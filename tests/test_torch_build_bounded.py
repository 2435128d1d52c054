"""The port's bounded build (index.MergeTree: leaves every `superbatch` raw
records, pairwise merges, leaves off the device at the budget, the final
merge range by range) against slacken_tpu's KeyValueIndex.build on the CPU,
tolerance 0: keys, taxa, the full-records sidecar and the saved files byte
for byte. The JAX package runs its reference route and its device route
(STPU_BUILD_DEVICE=1 with a small STPU_BUILD_SUPERBATCH and
STPU_BUILD_DEVICE_BUDGET, as tests/test_index.py forces them). Indexes:
narrow (35, 31, 7), wide (35, 32, 7) and (50, 45, 7), and a frequency
ordering (25, 11, 0); the library has cross-taxon duplicates and a batch of
N only. Also: an empty library, a library of N only, one leaf returned as it
is, a leaf of exactly leaf_entries records, the range cuts' bound, and
Dynamic's per-taxon counts over several batches under a tiny budget."""

import numpy as np
import pytest
import torch

import slacken_tpu.dynamic as jdynamic
from slacken_tpu.classify import ClassifyParams as JClassifyParams
from slacken_tpu.classify import Fragment as JFragment
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import dynamic
from slacken_tpu_torch.classify import ClassifyParams, Fragment
from slacken_tpu_torch.index import HELD_BYTES, IndexParams, KeyValueIndex, MergeTree, _range_cuts
from slacken_tpu_torch.ops import encode, ordering
from test_dynamic import FakeLibrary
from test_torch_index import shared_library
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide32": dict(k=35, m=32, spaces=7),
    "wide45": dict(k=50, m=45, spaces=7),
    "frequency": dict(k=25, m=11, spaces=0, ordering="frequency"),
}
BATCH = dict(batch_rows=4, row_len=1024)  # about 990 new positions a row: several batches a genome
#: the port's routes: several leaves merged on the device; and a budget of
#: 2000-record leaves (8 x 12 bytes a narrow record, 8 x 20 wide), about
#: two batches' records, with ranges of about 600, so that merged leaves
#: leave the device and the final merge cuts ranges
ROUTES = {
    "leaves": dict(superbatch=700),
    "host leaves": dict(superbatch=300, leaf_entries=2000),
}


@pytest.fixture(scope="module")
def world():
    """A taxonomy; a library cut from one genome with per-taxon mutations
    (real LCAs), with a copy of a genome under another taxon and 9 kbp of N
    (a whole batch of N); the frequency table."""
    rng = np.random.default_rng(20261021)
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=6, length=5000)
    lib.append((lib[3][0], lib[0][1]))  # every key of genome 0 under a second taxon too
    lib.append((lib[1][0], "N" * 9000))
    mp = IndexParams(**KINDS["frequency"]).minimizer_params
    counts = ordering.sample_mmer_counts((encode.encode_seq(s) for _, s in lib), mp, "cpu")
    return tax, lib, {"frequency": ordering.frequency_lut(counts, mp.m)}, {}


def jax_index(world, kind, keep):
    """slacken_tpu's index of the library (its reference route), made once."""
    tax, lib, tables, cache = world
    if (kind, keep) not in cache:
        cache[(kind, keep)] = JIndex.build(iter(lib), JParams(**KINDS[kind]), tax, batch_rows=8, row_len=4096,
                                           keep_records=keep, ordering_lut=tables.get(kind))
    return cache[(kind, keep)]


def port_index(world, kind, keep, leaf_entries=None, **route):
    """The port's index; `leaf_entries` sets the budget that gives leaves of
    that many records (MergeTree: 8 held records' bytes a leaf record)."""
    tax, lib, tables, _ = world
    params = IndexParams(**KINDS[kind])
    if leaf_entries:
        route["device_budget"] = leaf_entries * 8 * HELD_BYTES[params.m > 31]
    return KeyValueIndex.build(iter(lib), params, tax, "cpu", ordering_lut=tables.get(kind),
                               keep_records=keep, **BATCH, **route)


def assert_same(got, want, keep):
    assert np.array_equal(got.keys, want.keys) and got.keys.dtype == np.uint64
    assert np.array_equal(got.taxa, want.taxa) and got.taxa.dtype == np.int32
    if keep:
        assert np.array_equal(got.record_keys, want.record_keys)
        assert np.array_equal(got.record_taxa, want.record_taxa)


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", KINDS)
def test_bounded_build_matches_jax(world, kind, route, keep):
    want = jax_index(world, kind, keep)
    got = port_index(world, kind, keep, **ROUTES[route])
    assert got.num_records == len(want.keys) > 2000
    assert_same(got, want, keep)
    stats = got.build_stats
    assert stats["leaves"] >= 8 and stats["merges"] >= 3
    if route == "leaves":
        assert stats["leaves_off"] == 0 and stats["leaf_entries"] is None
        assert got.keys_t.device.type == "cpu"
    else:
        assert stats["leaves_off"] >= 3 and stats["leaf_entries"] == 2000
        assert stats["range_entries"] < got.num_records


@pytest.mark.parametrize("kind", KINDS)
def test_saved_files_match_jax_device_route(world, kind, tmp_path, monkeypatch):
    """The JAX package's device route (its merge tree, host leaves under a
    small budget) and the port's under its smallest budget write the same
    files as its reference route."""
    tax, lib, tables, _ = world
    monkeypatch.setenv("STPU_BUILD_DEVICE", "1")
    monkeypatch.setenv("STPU_BUILD_SUPERBATCH", str(4 * 1024 * 2))
    monkeypatch.setenv("STPU_BUILD_DEVICE_BUDGET", "20000")
    jdev = JIndex.build(iter(lib), JParams(**KINDS[kind]), tax, batch_rows=4, row_len=1024,
                        ordering_lut=tables.get(kind))
    got = port_index(world, kind, False, superbatch=100, leaf_entries=200)
    assert got.build_stats["leaves_off"] >= 8
    want = jax_index(world, kind, False)
    for name, idx in (("ref", want), ("dev", jdev), ("port", got)):
        idx.save(str(tmp_path / name))
    for name in ("keys.npy", "taxa.npy", "params.json"):
        data = (tmp_path / "ref" / name).read_bytes()
        assert (tmp_path / "dev" / name).read_bytes() == data
        assert (tmp_path / "port" / name).read_bytes() == data


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
@pytest.mark.parametrize("kind", ["narrow", "wide45"])
def test_empty_and_all_n_libraries(world, kind, keep):
    tax, lib, _, _ = world
    params = IndexParams(**KINDS[kind])
    for genomes in ([], [(lib[0][0], "N" * 5000)], [(lib[0][0], "ACGT" * 5)]):
        got = KeyValueIndex.build(iter(genomes), params, tax, "cpu", keep_records=keep, superbatch=10,
                                  device_budget=1000, **BATCH)
        want = JIndex.build(iter(genomes), JParams(**KINDS[kind]), tax, keep_records=keep, batch_rows=8,
                            row_len=4096)
        assert got.num_records == 0 and got.keys.shape == ((0, 2) if got.wide else (0,))
        assert_same(got, want, keep)
        assert got.build_stats["leaves"] == 0


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
def test_one_leaf_without_a_raw_tail(world, keep):
    """Records that make exactly one leaf and no tail: the leaf is the index
    (pairs: the sidecar, with the index reduced from it), as slacken_tpu's
    reduce_chunks returns a lone leaf."""
    tax, lib, _, _ = world
    want = port_index(world, "narrow", keep)
    tree = MergeTree("cpu", tax, 31, pairs=keep, superbatch=1)
    keys, taxa = torch.from_numpy(want.keys.view(np.int64)), torch.from_numpy(want.taxa)
    if keep:
        keys, taxa = want.record_keys_t, want.record_taxa_t
    tree.add(keys, taxa)
    assert tree.stats["leaves"] == 1 and not tree.chunks
    leaf = tree.leaves[0]
    cols = tree.finish()
    assert cols[2 if keep else 0] is leaf[0]
    assert torch.equal(cols[0], want.keys_t) and torch.equal(cols[1], want.taxa_t)
    assert tree.stats["merges"] == 0 and tree.stats["leaves_off"] == 0


def test_a_leaf_of_exactly_leaf_entries_leaves(world):
    tax, lib, _, _ = world
    want = port_index(world, "narrow", False)
    n = want.num_records
    keys, taxa = want.keys_t, want.taxa_t
    for budget, off in ((n * 8 * 12, 1), ((n + 1) * 8 * 12, 0)):
        tree = MergeTree("cpu", tax, 31, superbatch=1, device_budget=budget)
        assert tree.leaf_entries == n + (1 - off)
        tree.add(keys, taxa)
        assert tree.stats["leaves_off"] == off and len(tree.leaves) == 1 - off
        cols = tree.finish()
        assert torch.equal(cols[0], keys) and torch.equal(cols[1], taxa)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_range_cuts_bound_every_range(wide):
    """Sorted runs with shared keys (wide: hi64 of 0 and 1 only, so cuts
    fall inside runs of equal hi64): every range holds at most the limit, no
    key spans two ranges, and the cuts cover every run."""
    rng = np.random.default_rng(3)
    pool = rng.integers(-(1 << 62), 1 << 62, 5000)
    runs = []
    for n in (3000, 800, 1, 1500):
        keys = torch.from_numpy(np.sort(rng.choice(pool, n, replace=False)))
        if wide:
            keys = torch.stack([keys.abs() % 2, keys], 1)
            keys = keys[torch.from_numpy(np.lexsort((keys[:, 1].numpy() ^ np.int64(-(1 << 63)), keys[:, 0].numpy())))]
        runs.append(keys)
    for limit in (37, 200, 1000, 10_000):
        cuts = _range_cuts(runs, limit)
        assert all(c[0] == 0 and c[-1] == len(k) and c == sorted(c) for c, k in zip(cuts, runs))
        seen = set()
        for j in range(len(cuts[0]) - 1):
            rows = [tuple(np.atleast_1d(x).tolist()) for k, c in zip(runs, cuts) for x in k[c[j] : c[j + 1]].numpy()]
            assert len(rows) <= limit
            assert not seen & set(rows)
            seen |= set(rows)
        assert len(cuts[0]) - 1 >= sum(map(len, runs)) // limit


def test_distinct_counts_over_batches_under_a_tiny_budget(world, tmp_path):
    """Dynamic's total and distinct per-taxon counts from span hits in many
    batches (96 rows a batch), the distinct pairs through a MergeTree whose
    leaves leave the device, against the JAX package's counts."""
    tax, lib, _, _ = world
    genomes = [g for g in lib[:4]]
    jbase = JIndex.build(iter(genomes), JParams(), tax)
    base = KeyValueIndex.build(iter(genomes), IndexParams(), tax, "cpu")
    rng = np.random.default_rng(9)
    reads = []
    for i in range(600):
        seq = genomes[i % 4][1]
        s = int(rng.integers(0, len(seq) - 101))
        reads.append((f"r{i}", seq[s : s + 101]))
    args = (FakeLibrary(genomes), 1)
    jd = jdynamic.Dynamic(jbase, *args, jdynamic.MinimizerDistinctCount(5), JClassifyParams(thresholds=[0.0]), None,
                          str(tmp_path / "j"))
    td = dynamic.Dynamic(base, *args, dynamic.MinimizerDistinctCount(5), ClassifyParams(thresholds=[0.0]), None,
                         str(tmp_path / "t"), "cpu", device_budget=300 * 8 * 12)
    td._classifier()._rows_target = lambda bucket: 96
    frags = [Fragment(*r) for r in reads]
    jfrags = [JFragment(*r) for r in reads]
    batches = list(td._span_hit_batches(frags))
    assert len(batches) >= 6
    total, distinct = td.total_minimizers_per_taxon(frags), td.distinct_minimizers_per_taxon(frags)
    assert total == jd.total_minimizers_per_taxon(jfrags) and list(total) == sorted(total)
    assert distinct == jd.distinct_minimizers_per_taxon(jfrags) and list(distinct) == sorted(distinct)
    assert sum(distinct.values()) < sum(total.values()) and len(distinct) >= 3
    tree = MergeTree("cpu", tax, 31, pairs=True, device_budget=300 * 8 * 12)
    for keys, taxa in batches:
        tree.add(keys, taxa)
    tree.finish(index=False)
    assert tree.stats["leaves_off"] >= 2
