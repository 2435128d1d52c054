"""The port's index build against slacken_tpu's KeyValueIndex.build on a
small library whose genomes share segments (so real LCAs above the leaves
occur): byte-identical keys.npy and taxa.npy, and each package loads the
other's saved index."""

import numpy as np
import pytest
import torch

from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

LUT = np.frombuffer(b"ACGT", np.uint8)


def shared_library(rng, tax, n=5, length=3000):
    """(taxon, sequence) pairs cut from one random genome with per-taxon
    mutations, so most minimizers are shared by several taxa; plus an
    N-containing sequence, a sequence shorter than k and an undefined taxon."""
    leaves = [t for t in tax.taxa() if tax.is_leaf(t)][:n]
    base = rng.integers(0, 4, length + 400 * n)
    lib = []
    for i, taxon in enumerate(leaves):
        g = base[i * 400 : i * 400 + length].copy()
        g[rng.random(length) < 0.01 * (i + 1)] = rng.integers(0, 4)
        lib.append((int(taxon), LUT[g].tobytes().decode()))
    lib.append((int(leaves[0]), "ACGT" * 20 + "N" * 40 + lib[1][1][:200]))
    lib.append((int(leaves[1]), lib[2][1][:30]))
    lib.append((10_000_000, lib[3][1]))
    return lib


@pytest.mark.parametrize("row_len", [1024, 4096])
def test_build_matches_jax_byte_for_byte(rng, tmp_path, row_len):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    want = JIndex.build(iter(lib), JParams(), tax, batch_rows=8, row_len=4096)
    got = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", batch_rows=4, row_len=row_len)
    assert got.num_records == len(want.keys) > 1000
    # real LCAs: some records carry an inner node, not the leaf of any sequence
    assert len(np.setdiff1d(got.taxa, [t for t, _ in lib])) > 0
    want.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "torch"))
    for name in ("keys.npy", "taxa.npy"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()


def test_each_package_loads_the_other(rng, tmp_path):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=3, length=1500)
    JIndex.build(iter(lib), JParams(), tax, batch_rows=8, row_len=2048).save(str(tmp_path / "j"))
    KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu").save(str(tmp_path / "t"))
    from_jax = KeyValueIndex.load(str(tmp_path / "j"))
    from_torch = JIndex.load(str(tmp_path / "t"))
    assert np.array_equal(from_jax.keys, from_torch.keys)
    assert np.array_equal(from_jax.taxa, from_torch.taxa)
    assert from_jax.params == IndexParams.from_json(from_torch.params.to_json())
    keys, taxa, fence = from_jax.device_arrays("cpu")
    assert keys.dtype == torch.int64 and taxa.dtype == torch.int32
    assert fence.shape[0] == -(-from_jax.num_records // 128)


@pytest.mark.parametrize("params", [IndexParams(ordering="lexicographic"), IndexParams(k=40, m=35, spaces=0)])
def test_unported_index_kinds_raise(rng, params):
    tax = random_taxonomy(rng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KeyValueIndex.build(iter([]), params, tax, "cpu")


def test_empty_library(rng):
    idx = KeyValueIndex.build(iter([]), IndexParams(), random_taxonomy(rng), "cpu")
    assert idx.num_records == 0 and idx.keys.dtype == np.uint64
