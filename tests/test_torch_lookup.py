"""The port's index probe (slacken_tpu_torch.ops.lookup) against the JAX
package's Pallas block probe (interpret mode) and its plain lookup_taxa, and
the prefix directory the CUDA probe kernel walks against both. Exact equality
on hits, misses, negative queries and queries >= 2^62."""

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


def _keys_of(rng, kind, n):
    """n sorted unique non-negative keys (fewer where the kind has fewer)."""
    if kind == "uniform":
        raw = rng.integers(0, 1 << 62, 3 * n + 1, dtype=np.int64)
    elif kind == "one prefix":  # every key under one directory prefix
        raw = (1 << 61) + rng.integers(0, 1 << 20, 3 * n + 1, dtype=np.int64)
    else:  # two prefixes far apart: the lowest and the highest
        raw = np.concatenate([rng.integers(0, 1 << 12, n // 2, dtype=np.int64),
                              (1 << 62) - 1 - rng.integers(0, 1 << 12, n, dtype=np.int64)])
    return np.unique(raw)[:n]


@pytest.mark.parametrize("n", [0, 1, 2, 127, 128, 129, 100_003])
@pytest.mark.parametrize("kind", ["uniform", "one prefix", "two prefixes"])
def test_directory_matches_plain_and_jax(rng, kind, n):
    """build_directory + lookup_taxa_directory == lookup_taxa == the JAX
    package's lookup_taxa, at the default bucket size, one key a bucket and
    every key in one bucket. Tolerance 0."""
    keys = _keys_of(rng, kind, n)
    taxa = rng.integers(1, 1000, len(keys)).astype(np.int32)
    edges = np.array([-5, -(1 << 63), 0, 1 << 62, (1 << 63) - 1], np.int64)
    q = np.concatenate([keys[:2000], keys[-2000:], keys[:50] - 1, keys[-50:] + 1, edges,
                        rng.integers(0, 1 << 62, 300, dtype=np.int64),
                        rng.integers(-(1 << 63), (1 << 63) - 1, 300, dtype=np.int64)])
    k_t, t_t, q_t = torch.from_numpy(keys), torch.from_numpy(taxa), torch.from_numpy(q)
    want = lookup.lookup_taxa(k_t, t_t, q_t)
    if len(keys):
        u, qu = keys.view(np.uint64), q.view(np.uint64)
        want_jax = np.asarray(jlookup.lookup_taxa(
            jlookup.keys_from_numpy(u), jnp.asarray(taxa), jlookup.keys_from_numpy(qu)))
        assert np.array_equal(want.numpy(), want_jax)
    assert int((want > 0).sum()) >= min(len(keys), 2000)
    for bucket_keys in (lookup.BUCKET_KEYS, 1, 1 << 30):
        d = lookup.build_directory(k_t, bucket_keys)
        assert d.starts.dtype == torch.int32 and 0 <= d.shift <= 63
        assert d.buckets & (d.buckets - 1) == 0 and int(d.starts[0]) == 0 and int(d.starts[-1]) == len(keys)
        assert bool((d.starts[1:] >= d.starts[:-1]).all())
        got = lookup.lookup_taxa_directory(k_t, t_t, d, q_t)
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_directory_bucket_size(rng):
    keys = torch.from_numpy(_keys_of(rng, "uniform", 100_003))
    d = lookup.build_directory(keys)
    # ceil(log2(100003 / 4)) = 15 prefix bits, from the top of the widest key
    assert d.buckets == 1 << 15 and d.shift == int(keys[-1]).bit_length() - 15
    sizes = d.starts[1:] - d.starts[:-1]
    assert int(sizes.sum()) == 100_003 and int(sizes.max()) < 8 * lookup.BUCKET_KEYS
    # narrow keys (m < 31): the prefix comes from the top of the widest key
    narrow = torch.unique(torch.from_numpy(rng.integers(0, 1 << 30, 5000, dtype=np.int64)))
    d = lookup.build_directory(narrow)
    assert d.shift == 30 - (d.buckets.bit_length() - 1)
    with pytest.raises(ValueError, match="non-negative"):
        lookup.build_directory(torch.tensor([-3, 5]))


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
    got = lookup.probe(k_t, t_t, lookup.build_directory(k_t), q_t)
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
    got = lookup.probe(empty, empty.to(torch.int32), lookup.build_directory(empty), torch.arange(5))
    assert got.tolist() == [0] * 5


def test_probe_kernel_refuses_cpu_tensors(rng):
    keys, taxa = _index(rng, 300)
    k_t = torch.from_numpy(keys)
    cuda_kernels.reset_launch_counts()
    lookup.probe(k_t, torch.from_numpy(taxa), lookup.build_directory(k_t), k_t)
    assert cuda_kernels.LAUNCHES["probe"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.lookup_taxa_directory_cuda(k_t, torch.from_numpy(taxa), lookup.build_directory(k_t), k_t)
