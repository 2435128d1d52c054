"""Sharded index files: the port's KeyValueIndex.save_sharded writes
slacken_tpu's files byte for byte (narrow, wide m = 45, rank table), each
package loads the other's sharded index (load and load_shards, a subset of
shards too), and an index of fewer keys than shards saves and loads."""

import os

import numpy as np
import pytest
import torch

from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from test_torch_index import shared_library
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=50, m=45, spaces=7),
    "rank_table": dict(k=21, m=11, spaces=2, ordering="lexicographic"),
}


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """kind -> (the port's index, slacken_tpu's loaded from the port's save)."""
    rng = np.random.default_rng(20261019)
    tax = random_taxonomy(rng)
    genomes = shared_library(rng, tax, n=5, length=2000)
    out = {}
    for kind, kw in KINDS.items():
        idx = KeyValueIndex.build(iter(genomes), IndexParams(**kw), tax, "cpu")
        loc = str(tmp_path_factory.mktemp(kind) / "idx")
        idx.save(loc)
        out[kind] = (idx, JIndex.load(loc))
    return out


def files(loc):
    """{relative path: bytes} of every file under loc."""
    got = {}
    for root, _, names in os.walk(loc):
        for name in names:
            with open(os.path.join(root, name), "rb") as f:
                got[os.path.relpath(os.path.join(root, name), loc)] = f.read()
    return got


def same(idx, keys, taxa):
    return np.array_equal(idx.keys, np.asarray(keys, np.uint64)) and np.array_equal(idx.taxa, np.asarray(taxa))


@pytest.mark.parametrize("n_shards", [1, 4, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_save_sharded_byte_identical(indexes, tmp_path, kind, n_shards):
    idx, jidx = indexes[kind]
    idx.save_sharded(str(tmp_path / "t"), n_shards)
    jidx.save_sharded(str(tmp_path / "j"), n_shards)
    got, want = files(str(tmp_path / "t")), files(str(tmp_path / "j"))
    assert got == want
    assert sum(name.startswith("keys.") for name in got) == n_shards
    assert ("ordering_lut.npy" in got) == (kind == "rank_table") and "keys.npy" not in got


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_loads_the_others(indexes, tmp_path, kind):
    idx, jidx = indexes[kind]
    idx.save_sharded(str(tmp_path / "t"), 5)
    jidx.save_sharded(str(tmp_path / "j"), 5)
    for loc in ("t", "j"):
        mine, theirs = KeyValueIndex.load(str(tmp_path / loc)), JIndex.load(str(tmp_path / loc))
        assert same(mine, idx.keys, idx.taxa) and same(mine, theirs.keys, theirs.taxa)
        assert mine.params == idx.params and mine.keys_t.dtype == torch.int64
        assert (mine.ordering_lut is None) == (kind != "rank_table")
        if kind == "rank_table":
            assert np.array_equal(mine.ordering_lut, idx.ordering_lut)
        part = KeyValueIndex.load_shards(str(tmp_path / loc), [1, 2])
        jpart = JIndex.load_shards(str(tmp_path / loc), [1, 2])
        assert same(part, jpart.keys, jpart.taxa) and 0 < part.num_records < idx.num_records
        none = KeyValueIndex.load_shards(str(tmp_path / loc), [])
        assert none.num_records == 0 and none.keys_t.shape[1:] == idx.keys_t.shape[1:]


def test_load_of_a_sharded_index(indexes, tmp_path):
    """load hands a sharded index to load_shards, where it used to raise."""
    idx, _ = indexes["narrow"]
    idx.save_sharded(str(tmp_path / "s"))  # params.buckets (200) shards
    back = KeyValueIndex.load(str(tmp_path / "s"))
    assert same(back, idx.keys, idx.taxa) and back.location == str(tmp_path / "s")
    assert len(back.taxonomy.parents) == len(idx.taxonomy.parents)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_more_shards_than_keys(indexes, tmp_path, kind):
    idx, _ = indexes[kind]
    small = idx.with_records(idx.keys_t[10:13].clone(), idx.taxa_t[10:13].clone())
    small.save_sharded(str(tmp_path / "t"), 8)
    jsmall = JIndex(small.keys, small.taxa, indexes[kind][1].params, indexes[kind][1].taxonomy)
    jsmall.save_sharded(str(tmp_path / "j"), 8)
    assert files(str(tmp_path / "t")) == files(str(tmp_path / "j"))
    back = KeyValueIndex.load(str(tmp_path / "t"))
    assert same(back, small.keys, small.taxa)
    assert [KeyValueIndex.load_shards(str(tmp_path / "t"), [i]).num_records for i in range(8)].count(0) == 5
