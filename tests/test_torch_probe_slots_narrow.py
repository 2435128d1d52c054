"""The narrow index's slot table (lookup.build_slots over int64 [N] keys:
key remainder and taxon, or the taxon's code, in one 8-byte slot) and the
twin of its kernel's walk (lookup.lookup_taxa_slots) on the CPU, against
lookup_taxa, a dictionary of the index and the JAX package's routed probe
(KeyValueIndex.lookup, lookup_taxa_routed), at tolerance 0: 0 to 3,000
keys of 62 bits, under one prefix, under two far apart, dense small keys
(shift 0) and 63-bit keys (shift 63 in one bucket); small, wide and
distinct taxa; 1, 4 and 2^30 keys a bucket; queries at, beside and between
the keys, at the same remainder in the neighbouring buckets, at the edges
and -1. Slots decode to the records exactly; the fit rule over 64 bits as
hypothesis properties; the plain version of the kernel's floor; and
classify end to end through the walk against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from probe_cases import NARROW_SLOT_KINDS, TOP, decode_slots, mode, narrow_slot_keys, narrow_slot_queries, taxa_of
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JCParams
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import cuda_kernels, lookup
from test_taxonomy import random_taxonomy
from test_torch_classify import _reads, tree
from test_torch_index import shared_library

torch.set_num_threads(1)

N = [0, 1, 2, 3, 127, 128, 129, 3000]
#: the sizes also held to the JAX package (each size a compilation there)
JAX_N = [1, 3, 128, 3000]
BUCKETS = [1, lookup.BUCKET_KEYS, 1 << 30]


def _jax_routed(keys, taxa, q):
    """The JAX package's routed probe (m = 31: keys and queries below 2^62)."""
    j = JIndex(keys.view(np.uint64), taxa, JParams(k=34, m=31, spaces=0), None)
    u = q.view(np.uint64)
    return np.asarray(j.lookup(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)), jnp.asarray(u.astype(np.uint32))))


def _answers(keys, taxa, q):
    """The taxon of each query's key from a dictionary of the index, else 0."""
    index = dict(zip(keys.tolist(), taxa.tolist()))
    return np.array([index.get(int(x), 0) for x in q], np.int32)


@pytest.mark.parametrize("taxa_kind", ["small", "wide", "distinct"])
@pytest.mark.parametrize("kind", NARROW_SLOT_KINDS)
def test_narrow_slot_walk_matches_lookup_taxa_and_jax(kind, taxa_kind):
    """lookup_taxa_slots over build_slots' table == lookup_taxa == the
    dictionary == the JAX package's routed probe, every n and directory;
    the slots decode to the records; the field mode and any rise of b are
    what the fit rule says over 64 bits."""
    rng = np.random.default_rng(len(kind) * 7 + len(taxa_kind))
    for n in N:
        keys = narrow_slot_keys(rng, kind, n)
        taxa = taxa_of(rng, taxa_kind, len(keys))
        k_t, t_t = torch.from_numpy(keys), torch.from_numpy(taxa)
        for bucket_keys in BUCKETS:
            d = lookup.build_directory(k_t, bucket_keys)
            table = lookup.build_slots(k_t, t_t, d)
            q = np.concatenate([narrow_slot_queries(rng, keys, d.shift),
                                narrow_slot_queries(rng, keys, table.directory.shift)])
            q_t = torch.from_numpy(q)
            want = _answers(keys, taxa, q)
            assert np.array_equal(lookup.lookup_taxa(k_t, t_t, q_t).numpy(), want)
            got = lookup.lookup_taxa_slots(table, q_t)
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), (n, bucket_keys)
            assert np.array_equal(lookup.probe(None, None, table, q_t).numpy(), want)
            if len(keys) in JAX_N and bucket_keys == lookup.BUCKET_KEYS and kind != "63-bit":
                inside = (q >= 0) & (q < 1 << 62)  # the JAX package's keys are 62-bit values
                assert np.array_equal(_jax_routed(keys, taxa, q[inside]), want[inside])
            got_keys, got_taxa = decode_slots(table)
            assert torch.equal(got_keys, k_t) and torch.equal(got_taxa, t_t)
            # the fit rule over 64 bits, stated apart from slot_fit
            c0 = min(32, 64 - d.shift)
            direct = len(keys) == 0 or int(taxa.max()) < 1 << c0
            need = 0 if direct else max(0, (len(np.unique(taxa)) - 1).bit_length() - c0)
            assert mode(table) == ("direct" if direct else "code")
            assert table.directory.buckets == d.buckets << need and table.directory.shift == d.shift - need
            assert table.c == min(32, 64 - table.directory.shift) and table.directory.shift + table.c <= 64
            assert table.slots.dtype == torch.int64 and table.slots.shape == (len(keys),)
            assert table.slots.untyped_storage().nbytes() >= 8 * (len(keys) + 1)  # the word past the last
            if bucket_keys <= lookup.BUCKET_KEYS and kind != "63-bit":
                assert need == 0


@pytest.mark.parametrize("label,kind,n,taxa_kind,bucket_keys,field,rises,top_bit", [
    ("62-bit keys, default directory: the top bit set", "uniform", 3000, "small", None, "direct", False, True),
    ("62-bit keys, wide taxa: codes", "uniform", 3000, "wide", None, "code", False, True),
    ("62-bit keys, distinct taxa: codes", "uniform", 3000, "distinct", None, "code", False, True),
    ("dense keys, one a bucket: shift 0, 32 bits of field", "dense", 3000, "distinct", 1, "direct", False, False),
    ("one prefix: every key in one bucket", "one prefix", 3000, "small", None, "direct", False, False),
    ("62-bit keys in one bucket, distinct taxa: b rises", "uniform", 3000, "distinct", 1 << 30, "code", True, True),
    ("63-bit keys, default directory, distinct taxa: b rises", "63-bit", 3000, "distinct", None, "code", True, True),
    ("one key", "uniform", 1, "wide", None, "code", False, None),
    ("an empty index", "uniform", 0, "small", None, "direct", False, False),
])
def test_narrow_field_modes_and_the_raised_directory(label, kind, n, taxa_kind, bucket_keys, field, rises, top_bit):
    """The slot layouts by name: the field mode, a raised directory, slots
    with the top bit set (compared unsigned), taxa at and above 2^c (their
    codes); each probed at tolerance 0 and decoded to its records."""
    rng = np.random.default_rng(n + len(label))
    keys = narrow_slot_keys(rng, kind, n)
    taxa = taxa_of(rng, taxa_kind, len(keys))
    if label == "one key":
        taxa[:] = TOP
    k_t, t_t = torch.from_numpy(keys), torch.from_numpy(taxa)
    d = lookup.build_directory(k_t) if bucket_keys is None else lookup.build_directory(k_t, bucket_keys)
    table = lookup.build_slots(k_t, t_t, d)
    if bucket_keys is None:
        default = lookup.build_slots(k_t, t_t)
        assert torch.equal(default.slots, table.slots) and torch.equal(default.directory.starts, table.directory.starts)
    assert mode(table) == field and (table.directory.buckets > d.buckets) == rises
    if top_bit is not None:
        assert bool((table.slots < 0).any()) == top_bit
    if field == "code":
        assert torch.equal(table.codes, torch.unique(t_t)) and table.codes.dtype == torch.int32
        assert int(taxa.max()) >= 1 << min(32, 64 - d.shift)
    q = torch.from_numpy(np.concatenate([narrow_slot_queries(rng, keys, d.shift),
                                         narrow_slot_queries(rng, keys, table.directory.shift)]))
    assert torch.equal(lookup.lookup_taxa_slots(table, q), lookup.lookup_taxa(k_t, t_t, q))
    got_keys, got_taxa = decode_slots(table)
    assert torch.equal(got_keys, k_t) and torch.equal(got_taxa, t_t)


@st.composite
def _fits(draw):
    shift = draw(st.integers(0, 63))
    top = draw(st.integers(0, TOP))
    return shift, top, draw(st.integers(1, top + 1))


@settings(max_examples=300, deadline=None, database=None)
@given(_fits())
def test_narrow_fit_rule_always_fits(fit):
    """shift + field bits <= 64; the field holds the largest taxon (direct)
    or the largest code; b rises only where the code needs it, and by no
    bit more than it needs."""
    shift, top, n_taxa = fit
    rise, c, direct = lookup.slot_fit(shift, top, n_taxa, 64)
    assert 0 <= rise <= shift and c == min(32, 64 - (shift - rise)) and shift - rise + c <= 64
    if direct:
        assert rise == 0 and top < 1 << c
    else:
        assert top >= 1 << min(32, 64 - shift) and n_taxa - 1 < 1 << c
        if rise:
            assert n_taxa - 1 >= 1 << (c - 1)


@settings(max_examples=300, deadline=None, database=None)
@given(st.data())
def test_narrow_fit_rule_never_raises_the_default_directory(data):
    """With BUCKET_KEYS keys a bucket or fewer, any n unique narrow keys of
    any width up to 62 bits and any taxa leave the directory as it is."""
    n = data.draw(st.integers(1, (1 << 31) - 1))
    width = data.draw(st.integers((n - 1).bit_length(), 62))
    bucket_keys = data.draw(st.integers(1, lookup.BUCKET_KEYS))
    shift = width - lookup.prefix_bits(n, width, bucket_keys)
    n_taxa = data.draw(st.integers(1, n))
    top = data.draw(st.integers(n_taxa - 1, TOP))
    assert lookup.slot_fit(shift, top, n_taxa, 64)[0] == 0


def test_narrow_slot_tables_in_steps_equal_one_step(monkeypatch):
    """The directory and the slot table made CHUNK_ROWS rows (and buckets)
    at a time: a step of 7 gives what one step gives, raised directory and
    codes included."""
    rng = np.random.default_rng(5)
    k_t = torch.from_numpy(narrow_slot_keys(rng, "uniform", 3000))
    t_t = torch.from_numpy(taxa_of(rng, "distinct", 3000))
    whole = [lookup.build_slots(k_t, t_t, lookup.build_directory(k_t, b)) for b in (lookup.BUCKET_KEYS, 1 << 30)]
    monkeypatch.setattr(lookup, "CHUNK_ROWS", 7)
    for b, want in zip((lookup.BUCKET_KEYS, 1 << 30), whole):
        got = lookup.build_slots(k_t, t_t, lookup.build_directory(k_t, b))
        assert torch.equal(got.slots, want.slots) and torch.equal(got.codes, want.codes) and got.c == want.c
        assert torch.equal(got.directory.starts, want.directory.starts) and got.directory.shift == want.directory.shift


def test_narrow_slot_floor_reads_the_guessed_sector():
    """The plain version of the slot probe's floor (lookup.slot_sectors):
    each query inside the key space folds its directory entries and, in a
    non-empty bucket, the 16-byte halves of its guessed sector that hold a
    slot of the bucket (the word past the last slot reads 0); a query
    outside reads nothing."""
    rng = np.random.default_rng(9)
    keys = narrow_slot_keys(rng, "uniform", 129)
    k_t, t_t = torch.from_numpy(keys), torch.from_numpy(taxa_of(rng, "small", 129))
    table = lookup.build_slots(k_t, t_t)
    (starts, shift), slots = table.directory, table.slots.tolist() + [0]
    q = narrow_slot_queries(rng, keys, shift)
    got = lookup.slot_sectors(table, torch.from_numpy(q)).tolist()
    for x, v in zip(q.tolist(), got):
        p = x >> shift
        if x < 0 or p >= table.directory.buckets:
            assert v == 0
            continue
        s, e = int(starts[p]), int(starts[p + 1])
        want = s ^ e
        if s < e:
            place = ((x & ((1 << shift) - 1)) >> (shift - 32)) if shift > 32 else (x & ((1 << shift) - 1)) << (32 - shift)
            b = (s + ((place * (e - s)) >> 32)) // 4 * 4
            for h in (0, 2):
                if b + h + 2 > s and b + h < e:
                    for w in slots[b + h:b + h + 2]:
                        want ^= (w ^ (w >> 32)) & 0xFFFFFFFF
        assert v == np.int32(np.uint32(want & 0xFFFFFFFF))


def test_narrow_slot_tables_refuse_what_they_do_not_take():
    keys = torch.tensor([3, 9, 40])
    with pytest.raises(ValueError, match="non-negative"):
        lookup.build_slots(keys, torch.tensor([1, -2, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match=r"keys \[N\] or \[N, 2\]"):
        lookup.build_slots(keys, torch.ones(2, dtype=torch.int32))
    table = lookup.build_slots(keys, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.lookup_taxa_slots_cuda(table, keys)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.slots_floor_cuda(table, keys)
    empty = torch.zeros(0, dtype=torch.int64)
    table = lookup.build_slots(empty, torch.zeros(0, dtype=torch.int32))
    assert table.codes is None and lookup.lookup_taxa_slots(table, keys).tolist() == [0, 0, 0]


@pytest.mark.parametrize("per_read", [False, True], ids=["reports", "per_read"])
def test_classify_through_the_narrow_slot_walk_matches_jax(rng, tmp_path, monkeypatch, per_read):
    """Classify with a narrow index (k = 35, m = 31, s = 7: Kraken 2's
    defaults) whose every probe walks its slot table, as on the card
    (`device_arrays` there), on the CPU through the walk's twin, with the
    default directory (direct taxa) and with all keys in one bucket (codes
    and a raised directory); kreports, and per-read lines, byte-identical to
    the JAX package's."""
    kw = dict(k=35, m=31, spaces=7)
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=8)
    jidx = JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096)
    reads = [_reads(rng, lib, 150, 128, "a"), _reads(rng, lib, 60, 256, "b")]
    ckw = dict(thresholds=[0.0, 0.15], per_read_output=per_read, sample_regex=r"^[a-z](s\d)_")
    JClassifier(jidx, max_taxa_per_read=32).classify_and_write_packed(reads, str(tmp_path / "j"), JCParams(**ckw))
    want = tree(str(tmp_path / "j"))
    idx = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu")
    for bucket_keys in (None, 1 << 30):
        d = None if bucket_keys is None else lookup.build_directory(idx.keys_t, bucket_keys)
        table = lookup.build_slots(idx.keys_t, idx.taxa_t, d)
        assert (mode(table), table.directory.buckets > 1) == (
            ("direct", True) if bucket_keys is None else ("code", True))
        monkeypatch.setattr(KeyValueIndex, "device_arrays", lambda self, device, probe, t=table: (None, None, t))
        out = tmp_path / f"t{bucket_keys}"
        Classifier(idx, "cpu", max_taxa_per_read=32).classify_and_write_packed(reads, str(out), ClassifyParams(**ckw))
        assert tree(str(out)) == want, bucket_keys
