"""The port's index probe (slacken_tpu_torch.ops.lookup) against the JAX
package's Pallas block probe (interpret mode) and its plain lookup_taxa.
Exact equality on hits, misses and queries >= 2^62."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops.pallas_kernels import build_fence as jbuild_fence
from slacken_tpu.ops.pallas_kernels import lookup_taxa_dma
from slacken_tpu_torch.ops import cuda_kernels, lookup

torch.set_num_threads(1)


def _index(rng, n=5000):
    keys = np.unique(rng.integers(1, 1 << 62, 3 * n, dtype=np.int64))[:n]
    taxa = rng.integers(1, 1000, n).astype(np.int32)
    return keys, taxa


def _queries(rng, keys):
    hits = keys[rng.integers(0, len(keys), 250)]
    misses = rng.integers(1, 1 << 62, 200, dtype=np.int64)
    wild = rng.integers(1 << 62, (1 << 63) - 1, 40, dtype=np.int64)
    edges = np.array([keys[0], keys[-1], keys[0] - 1, keys[-1] + 1, 0, (1 << 63) - 1], np.int64)
    q = np.concatenate([hits, misses, wild, edges])
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("n", [5000, 128, 129, 1])
def test_build_fence_matches_jax(rng, n):
    keys, _ = _index(rng, n)
    u = keys.view(np.uint64)
    fh, fl, n_blocks = jbuild_fence((u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32))
    fence = lookup.build_fence(torch.from_numpy(keys)).numpy()
    assert len(fence) == n_blocks
    want = (fh.astype(np.uint64) << np.uint64(32)) | fl.astype(np.uint64)
    assert np.array_equal(fence.view(np.uint64), want)


def test_probe_matches_pallas_and_plain_jax(rng):
    keys, taxa = _index(rng)
    q = _queries(rng, keys)
    u, qu = keys.view(np.uint64), q.view(np.uint64)
    kh, kl = (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)
    fh, fl, _ = jbuild_fence(kh, kl)
    qh, ql = (qu >> np.uint64(32)).astype(np.uint32), qu.astype(np.uint32)
    want_dma = np.asarray(lookup_taxa_dma(kh, kl, taxa, fh, fl, qh, ql, interpret=True))
    want = np.asarray(jlookup.lookup_taxa(
        jlookup.keys_from_numpy(u), jnp.asarray(taxa), jlookup.keys_from_numpy(qu)))
    k_t, t_t, q_t = torch.from_numpy(keys), torch.from_numpy(taxa), torch.from_numpy(q)
    got = lookup.probe(k_t, t_t, lookup.build_fence(k_t), q_t)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_dma)
    assert np.array_equal(got.numpy(), want)
    assert (got > 0).sum() >= 250


def test_negative_queries_miss(rng):
    keys, taxa = _index(rng, 300)
    q = torch.tensor([-1, -(1 << 63), int(keys[5])], dtype=torch.int64)
    k_t = torch.from_numpy(keys)
    got = lookup.lookup_taxa(k_t, torch.from_numpy(taxa), q)
    assert got.tolist() == [0, 0, int(taxa[5])]


def test_empty_index_misses():
    empty = torch.zeros(0, dtype=torch.int64)
    got = lookup.probe(empty, empty.to(torch.int32), lookup.build_fence(empty), torch.arange(5))
    assert got.tolist() == [0] * 5


def test_probe_kernel_refuses_cpu_tensors(rng):
    keys, taxa = _index(rng, 300)
    k_t = torch.from_numpy(keys)
    cuda_kernels.reset_launch_counts()
    lookup.probe(k_t, torch.from_numpy(taxa), lookup.build_fence(k_t), k_t)
    assert cuda_kernels.LAUNCHES["probe"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.lookup_taxa_fence_cuda(k_t, torch.from_numpy(taxa), lookup.build_fence(k_t), k_t)
