"""The wide index's slot table (lookup.build_slots: key remainder and taxon,
or the taxon's code, in one 16-byte row) and the twin of the slot kernel's
walk (lookup.lookup_taxa_slots) on the CPU, against lookup_taxa, a
dictionary of the index and the JAX package's lookup_taxa_routed_wide
(through KeyValueIndex.lookup_wide), at tolerance 0: m from 32 to 63, 0 to
3,000 keys, small, wide and distinct taxa, 1, 4 and 2^30 keys a bucket,
queries at and beside every key and at the same remainder in the
neighbouring buckets. The fit rule (lookup.slot_fit) as a hypothesis
property, both field modes and the raised directory by name, and classify
end to end through the slot walk against the JAX package."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from probe_cases import NAMED, TOP, mode, neighbours, queries_of, taxa_of, wide_keys
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JCParams
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.ops import lookup as jlookup
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import cuda_kernels, lookup
from test_taxonomy import random_taxonomy
from test_torch_classify import _reads, tree
from test_torch_index import shared_library

torch.set_num_threads(1)

M = [32, 33, 45, 48, 49, 56, 63]
N = [0, 1, 2, 3, 127, 128, 129, 3000]
#: the sizes also held to the JAX package (each size a compilation there)
JAX_N = [1, 3, 128, 3000]
BUCKETS = [1, lookup.BUCKET_KEYS, 1 << 30]


@pytest.fixture(scope="module")
def indexes():
    """(m, n) -> keys, the queries that do not depend on the directory, and
    the position + 1 of each query's key (0 for none) from a dictionary of
    the index; at JAX_N keys checked against the JAX package's answer (it
    probes with taxa 1..n)."""
    rng = np.random.default_rng(8)
    out = {}
    for m in M:
        top = (1 << (2 * m - 64)) - 1
        for n in N:
            keys = wide_keys(rng, m, n)
            queries = queries_of(rng, keys, m)
            where = _positions(keys, queries)
            if n in JAX_N:
                inside = queries[:, 0] <= top  # the JAX package's keys are 2m-bit values
                jidx = JIndex(keys, np.arange(1, n + 1, dtype=np.int32), JParams(k=m + 3, m=m, spaces=0), None)
                got = np.asarray(jidx.lookup_wide(jlookup.wide_keys_from_numpy(queries[inside])))
                assert np.array_equal(got, where[inside])
            out[m, n] = keys, queries, where
    return out


def _positions(keys, queries):
    """The position + 1 of each query's key in `keys`, 0 for none."""
    index = {(int(h), int(l)): i + 1 for i, (h, l) in enumerate(keys)}
    return np.array([index.get((int(h), int(l)), 0) for h, l in queries], np.int32)


@pytest.mark.parametrize("kind", ["small", "wide", "distinct"])
@pytest.mark.parametrize("m", M)
def test_slot_walk_matches_lookup_taxa_and_jax(indexes, m, kind):
    """lookup_taxa_slots over build_slots' table == lookup_taxa == the
    dictionary == the JAX package, every n and directory; the field mode and
    any rise of b are what the fit rule says."""
    rng = np.random.default_rng(m)
    for n in N:
        keys, queries, where = indexes[m, n]
        taxa = taxa_of(rng, kind, n)
        k_t, t_t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
        for bucket_keys in BUCKETS:
            d = lookup.build_directory(k_t, bucket_keys)
            q = np.concatenate([queries, neighbours(keys, d.shift)])
            pos = np.concatenate([where, _positions(keys, q[len(queries):])])
            want = np.where(pos > 0, np.concatenate([[0], taxa])[pos], 0).astype(np.int32)
            q_t = torch.from_numpy(q.view(np.int64))
            assert np.array_equal(lookup.lookup_taxa(k_t, t_t, q_t).numpy(), want)
            table = lookup.build_slots(k_t, t_t, d)
            got = lookup.lookup_taxa_slots(table, q_t)
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), (n, bucket_keys)
            assert np.array_equal(lookup.probe(None, None, table, q_t).numpy(), want)
            if n:  # also the remainders of the raised directory's neighbours
                q2 = torch.from_numpy(neighbours(keys, table.directory.shift).view(np.int64))
                assert torch.equal(lookup.lookup_taxa_slots(table, q2), lookup.lookup_taxa(k_t, t_t, q2))
            # the fit rule, stated apart from slot_fit
            c0 = min(32, 128 - d.shift)
            direct = n == 0 or int(taxa.max()) < 1 << c0
            need = 0 if direct else max(0, (len(np.unique(taxa)) - 1).bit_length() - c0)
            assert mode(table) == ("direct" if direct else "code")
            assert table.directory.buckets == d.buckets << need and table.directory.shift == d.shift - need
            assert table.c == min(32, 128 - table.directory.shift) and table.directory.shift + table.c <= 128
            assert table.slots.dtype == torch.int64 and table.slots.shape == (n, 2) and table.slots.is_contiguous()
            if bucket_keys <= lookup.BUCKET_KEYS:
                assert need == 0
            if bucket_keys == lookup.SLOT_BUCKET_KEYS:  # build_slots' own directory
                default = lookup.build_slots(k_t, t_t)
                assert torch.equal(default.slots, table.slots) and torch.equal(default.directory.starts, d.starts)


@pytest.mark.parametrize("label,m,n,kind,bucket_keys,field,rises", NAMED, ids=[c[0] for c in NAMED])
def test_field_modes_and_the_raised_directory(indexes, label, m, n, kind, bucket_keys, field, rises):
    keys, queries, where = indexes[m, n]
    taxa = taxa_of(np.random.default_rng(n), kind, n)
    k_t, t_t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    d = lookup.build_directory(k_t, bucket_keys)
    table = lookup.build_slots(k_t, t_t, d)
    assert mode(table) == field and (table.directory.buckets > d.buckets) == rises
    if field == "code":
        assert torch.equal(table.codes, torch.unique(t_t)) and table.codes.dtype == torch.int32
    q_t = torch.from_numpy(np.concatenate([queries, neighbours(keys, table.directory.shift)]).view(np.int64))
    assert torch.equal(lookup.lookup_taxa_slots(table, q_t), lookup.lookup_taxa(k_t, t_t, q_t))


@st.composite
def _fits(draw):
    shift = draw(st.integers(0, 127))
    top = draw(st.integers(0, TOP))
    return shift, top, draw(st.integers(1, top + 1))


@settings(max_examples=300, deadline=None, database=None)
@given(_fits())
def test_fit_rule_always_fits(fit):
    """shift + field bits <= 128; the field holds the largest taxon (direct)
    or the largest code; b rises only where the code needs it, and by no
    bit more than it needs."""
    shift, top, n_taxa = fit
    rise, c, direct = lookup.slot_fit(shift, top, n_taxa)
    assert 0 <= rise <= shift and c == min(32, 128 - (shift - rise)) and shift - rise + c <= 128
    if direct:
        assert rise == 0 and top < 1 << c
    else:
        assert top >= 1 << min(32, 128 - shift) and n_taxa - 1 < 1 << c
        if rise:
            assert n_taxa - 1 >= 1 << (c - 1)


@settings(max_examples=300, deadline=None, database=None)
@given(st.data())
def test_fit_rule_never_raises_the_default_directory(data):
    """With build_slots' SLOT_BUCKET_KEYS or build_directory's BUCKET_KEYS
    keys a bucket (or any number between), any n unique keys of any width up
    to 126 bits and any taxa leave the directory as it is."""
    n = data.draw(st.integers(1, (1 << 31) - 1))
    width = data.draw(st.integers((n - 1).bit_length(), 126))
    bucket_keys = data.draw(st.integers(lookup.SLOT_BUCKET_KEYS, lookup.BUCKET_KEYS))
    shift = width - lookup.prefix_bits(n, width, bucket_keys)
    n_taxa = data.draw(st.integers(1, n))
    top = data.draw(st.integers(n_taxa - 1, TOP))
    assert lookup.slot_fit(shift, top, n_taxa)[0] == 0


def test_slot_tables_in_steps_equal_one_step(indexes, monkeypatch):
    """The directory and the slot table made CHUNK_ROWS rows (and buckets) at
    a time: a step of 7 rows gives what one step gives."""
    keys, _, _ = indexes[63, 3000]
    k_t = torch.from_numpy(keys.view(np.int64))
    t_t = torch.from_numpy(taxa_of(np.random.default_rng(3), "wide", len(keys)))
    whole = [lookup.build_slots(k_t, t_t, lookup.build_directory(k_t, b)) for b in (lookup.SLOT_BUCKET_KEYS, 1 << 30)]
    monkeypatch.setattr(lookup, "CHUNK_ROWS", 7)
    for b, want in zip((lookup.SLOT_BUCKET_KEYS, 1 << 30), whole):
        d = lookup.build_directory(k_t, b)
        got = lookup.build_slots(k_t, t_t, d)
        assert torch.equal(d.starts, lookup.build_directory(k_t, b).starts)
        assert torch.equal(got.slots, want.slots) and torch.equal(got.codes, want.codes) and got.c == want.c
        assert torch.equal(got.directory.starts, want.directory.starts) and got.directory.shift == want.directory.shift


def test_slot_tables_refuse_what_they_do_not_take():
    keys = torch.tensor([[0, 5], [1, 7]])
    with pytest.raises(ValueError, match=r"keys \[N\] or \[N, 2\]"):
        lookup.build_slots(torch.zeros((2, 3), dtype=torch.int64), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="non-negative"):
        lookup.build_slots(keys, torch.tensor([1, -2], dtype=torch.int32), lookup.build_directory(keys))
    table = lookup.build_slots(keys, torch.ones(2, dtype=torch.int32), lookup.build_directory(keys))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.lookup_taxa_slots_cuda(table, keys)
    empty = torch.zeros((0, 2), dtype=torch.int64)
    table = lookup.build_slots(empty, torch.zeros(0, dtype=torch.int32), lookup.build_directory(empty))
    assert table.codes is None and lookup.lookup_taxa_slots(table, keys).tolist() == [0, 0]


def test_classify_through_the_slot_walk_matches_jax(rng, tmp_path, monkeypatch):
    """The slice as a whole: classify with a wide index whose every probe
    walks its slot table, as on the card (`device_arrays` there), on the
    CPU through the walk's twin, at m = 63 with build_slots' own directory
    (direct taxa) and all keys in one bucket (codes and a raised directory);
    per-read lines and kreports byte-identical to the JAX package's."""
    kw = dict(k=63, m=63, spaces=0)
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=8)
    jidx = JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096)
    reads = [_reads(rng, lib, 150, 128, "a"), _reads(rng, lib, 60, 256, "b")]
    ckw = dict(thresholds=[0.0, 0.15], per_read_output=True, sample_regex=r"^[a-z](s\d)_")
    JClassifier(jidx, max_taxa_per_read=32).classify_and_write_packed(reads, str(tmp_path / "j"), JCParams(**ckw))
    want = tree(str(tmp_path / "j"))
    assert sum(v.count(b"\nC\t") for v in want.values()) > 100
    idx = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu")
    for bucket_keys in (lookup.SLOT_BUCKET_KEYS, 1 << 30):
        table = lookup.build_slots(idx.keys_t, idx.taxa_t, lookup.build_directory(idx.keys_t, bucket_keys))
        assert (mode(table), table.directory.buckets > 1) == (
            ("direct", True) if bucket_keys == lookup.SLOT_BUCKET_KEYS else ("code", True))
        monkeypatch.setattr(KeyValueIndex, "device_arrays", lambda self, device, probe, t=table: (None, None, t))
        out = tmp_path / f"t{bucket_keys}"
        Classifier(idx, "cpu", max_taxa_per_read=32).classify_and_write_packed(reads, str(out), ClassifyParams(**ckw))
        assert tree(str(out)) == want, bucket_keys
