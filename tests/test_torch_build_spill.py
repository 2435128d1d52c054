"""The port's spill route (index.SpillCollector, `build(spill_dir=)`,
`build_distributed(spill_dir=)` and the CLI's `build --spill-dir`) against
slacken_tpu's on the CPU, tolerance 0: keys, taxa, the full-records sidecar
and the saved files byte for byte, for narrow (35, 31, 7) and wide (35, 32,
7) and (50, 45, 7) indexes; the spill directory gone after each build; a
crashed build's range files not merged into the next; rank-table keys
spread over several ranges (the port's sampled boundaries, where the JAX
package's uniform ones fill one); an unwritable directory raising."""

import os

import numpy as np
import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.index import SpillCollector as JSpillCollector
from slacken_tpu_torch import cli, workloads
from slacken_tpu_torch.index import HELD_BYTES, IndexParams, KeyValueIndex, SpillCollector
from slacken_tpu_torch.parallel.classifier import build_distributed
from test_torch_index import shared_library
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide32": dict(k=35, m=32, spaces=7),
    "wide45": dict(k=50, m=45, spaces=7),
}
BATCH = dict(batch_rows=4, row_len=1024)
CPU = ["--device", "cpu"]


def leaf_budget(kind, entries=1000):
    """The device budget that gives leaves of `entries` records."""
    return entries * 8 * HELD_BYTES[KINDS[kind]["m"] > 31]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A taxonomy, a library with shared segments and a copy under a second
    taxon, written out with the taxonomy for the CLIs."""
    base = tmp_path_factory.mktemp("spill")
    rng = np.random.default_rng(20261022)
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=5, length=4000)[:5]
    lib.append((lib[2][0], lib[0][1]))
    workloads.write_library(lib, str(base / "lib"))
    tax.save(str(base / "taxonomy"))
    return tax, lib, base, {}


def jax_index(world, kind):
    """slacken_tpu's index with its sidecar, made once: through its spill
    route for (35, 32) keys (the shift-0 edge of its wide range key), else
    through its reference route, which its own tests hold equal to its spill
    route (each of the spill route's 64 ranges is a shape that JAX compiles
    its reduce for, 12-20 s a kind here)."""
    tax, lib, base, cache = world
    if kind not in cache:
        spill = str(base / f"jspill_{kind}")
        cache[kind] = JIndex.build(iter(lib), JParams(**KINDS[kind]), tax, keep_records=True, batch_rows=8,
                                   row_len=4096, spill_dir=spill if kind == "wide32" else None)
        assert not os.path.exists(spill)
    return cache[kind]


def assert_same(got, want, keep):
    assert np.array_equal(got.keys, want.keys) and np.array_equal(got.taxa, want.taxa)
    if keep:
        assert np.array_equal(got.record_keys, want.record_keys)
        assert np.array_equal(got.record_taxa, want.record_taxa)


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
@pytest.mark.parametrize("kind", KINDS)
def test_spill_build_matches_jax(world, tmp_path, kind, keep):
    tax, lib, _, _ = world
    spill = str(tmp_path / "spill")
    want = jax_index(world, kind)
    got = KeyValueIndex.build(iter(lib), IndexParams(**KINDS[kind]), tax, "cpu", keep_records=keep, spill_dir=spill,
                              superbatch=300, device_budget=leaf_budget(kind), **BATCH)
    assert got.num_records == len(want.keys) > 2000
    assert_same(got, want, keep)
    stats = got.build_stats
    assert stats["leaves_off"] >= 3 and stats["spill_ranges"] > 32 and stats["spilled_bytes"] > 0
    assert not os.path.exists(spill)


def test_spill_without_leaves_off_the_device(world, tmp_path):
    """Under the default (CPU: unbounded) budget no leaf leaves, nothing is
    written, and the directory made at the start is removed all the same."""
    tax, lib, _, _ = world
    spill = str(tmp_path / "spill")
    got = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", spill_dir=spill, **BATCH)
    want = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", **BATCH)
    assert got.build_stats["leaves_off"] == 0 and got.build_stats["spilled_bytes"] == 0
    assert_same(got, want, False)
    assert not os.path.exists(spill)


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_spill_collector_cleans_stale_files(world, tmp_path, port):
    """A crashed build's range files do not merge into the next build in the
    same directory (tests/test_index.py's case), for either collector: the
    port's next build spills its leaves there and equals the build without
    a spill directory."""
    tax, lib, _, _ = world
    d = str(tmp_path / "spill")
    collector = SpillCollector if port else JSpillCollector
    stale = collector(d)
    stale.add(np.array([1, 2, 3], np.uint64), np.array([5, 5, 5], np.int32))
    if not port:
        stale.close()  # a crash before reduce and cleanup: the files stay
    assert os.listdir(d)
    if port:
        got = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", spill_dir=d, superbatch=300,
                                  device_budget=leaf_budget("narrow"), **BATCH)
        assert got.build_stats["leaves_off"] >= 3 and got.build_stats["spilled_bytes"] > 0
        assert_same(got, KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", **BATCH), False)
    else:
        fresh = collector(d)
        fresh.add(np.array([11, 10], np.uint64), np.array([7, 7], np.int32))
        keys, taxa, _ = fresh.reduce(tax)
        fresh.cleanup()
        assert np.array_equal(np.asarray(keys).view(np.uint64), np.array([10, 11], np.uint64))
        assert np.array_equal(np.asarray(taxa), np.array([7, 7], np.int32))
    assert not os.path.exists(d)


def test_rank_table_keys_spread_over_ranges(world, tmp_path):
    """Lexicographic (21, 11, 2) records, every key below 4^11: the port's
    spill build samples its range boundaries from the first leaf off the
    device and spreads the records over its 64 ranges; the JAX package's
    uniform 62-bit boundaries put them all in range 0. Both give the index
    and the sidecar of the build without a spill directory."""
    tax, lib, _, _ = world
    params = IndexParams(k=21, m=11, spaces=2, ordering="lexicographic")
    idx = KeyValueIndex.build(iter(lib), params, tax, "cpu", keep_records=True, **BATCH)
    keys, taxa = idx.record_keys, idx.record_taxa
    assert keys.max() < 4**11
    got = KeyValueIndex.build(iter(lib), params, tax, "cpu", keep_records=True, spill_dir=str(tmp_path / "t"),
                              superbatch=300, device_budget=leaf_budget("narrow"), **BATCH)
    assert got.build_stats["leaves_off"] >= 3 and got.build_stats["spill_ranges"] >= 48
    assert_same(got, idx, True)
    assert not os.path.exists(tmp_path / "t")
    jax = JSpillCollector(str(tmp_path / "j"), m=11)
    for a, b in ((0, len(keys) // 3), (len(keys) // 3, len(keys))):
        jax.add(keys[a:b], taxa[a:b])
    jax.close()
    assert sorted(os.listdir(tmp_path / "j")) == ["k0000.bin", "t0000.bin"]
    want = jax.reduce(tax, keep_records=True)
    jax.cleanup()
    assert np.array_equal(got.keys, want[0]) and np.array_equal(got.taxa, want[1])
    assert np.array_equal(got.record_keys, want[2][0]) and np.array_equal(got.record_taxa, want[2][1])


def test_unwritable_spill_dir_raises(world, tmp_path):
    """A spill directory that cannot be made raises; nothing falls back to
    memory."""
    tax, lib, _, _ = world
    (tmp_path / "file").write_text("x")
    with pytest.raises(OSError):
        KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", spill_dir=str(tmp_path / "file" / "spill"))


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
@pytest.mark.parametrize("kind", ["narrow", "wide45"])
def test_build_distributed_with_spill(world, tmp_path, kind, keep):
    """build_distributed over 8 CPU shards, each owner's leaves spilled to
    its own subdirectory: the single-device build and slacken_tpu's index
    (whose build_distributed equals its build, tests/test_multichip.py)."""
    tax, lib, _, _ = world
    spill = str(tmp_path / "spill")
    got = build_distributed(iter(lib), IndexParams(**KINDS[kind]), tax, ["cpu"] * 8, keep_records=keep,
                            spill_dir=spill, superbatch=60, device_budget=8 * leaf_budget(kind, 150), **BATCH)
    assert sum(s["leaves_off"] for s in got.build_stats) >= 8
    assert sum(s["spilled_bytes"] > 0 for s in got.build_stats) >= 6
    assert not os.path.exists(spill)
    single = KeyValueIndex.build(iter(lib), IndexParams(**KINDS[kind]), tax, "cpu", keep_records=keep, **BATCH)
    assert_same(got, single, keep)
    assert_same(got, jax_index(world, kind), keep)


def tree(loc):
    return {os.path.relpath(os.path.join(r, n), loc): open(os.path.join(r, n), "rb").read()
            for r, _, names in os.walk(loc) for n in names}


@pytest.mark.parametrize("mesh", [[], ["--devices", "8", "--shards", "4"]], ids=["one", "mesh"])
def test_cli_build_spill_dir(world, tmp_path, mesh):
    """`build --spill-dir` in the port's CLI: the files of its build without
    it and of slacken_tpu.cli with the same arguments; the directory gone."""
    _, _, base, _ = world
    lib = ["-l", str(base / "lib"), "-t", str(base / "taxonomy"), "-k", "35", "-m", "32", "--full-records", *mesh]
    spill = ["--spill-dir", str(tmp_path / "spill")]
    assert cli.main(["build", "-i", str(tmp_path / "t"), *lib, *spill, *CPU]) == 0
    assert cli.main(["build", "-i", str(tmp_path / "plain"), *lib, *CPU]) == 0
    assert jcli.main(["build", "-i", str(tmp_path / "j"), *lib, "--spill-dir", str(tmp_path / "jspill")]) == 0
    got = tree(str(tmp_path / "t"))
    assert len([f for f in got if f.startswith("keys")]) == (4 if mesh else 1)
    assert got == tree(str(tmp_path / "plain")) == tree(str(tmp_path / "j"))
    assert not os.path.exists(tmp_path / "spill")
