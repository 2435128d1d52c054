"""The port's hit compaction, resolveTree, LCA reductions and on-device
finalize against the JAX package's, on a table_from_parents tree, including
rows that overflow max_taxa. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slacken_tpu import classify as jclassify
from slacken_tpu.ops import lca as jlca
from slacken_tpu.ops import resolve as jresolve
from slacken_tpu_torch.classify import finalize
from slacken_tpu_torch.ops import lca, resolve

torch.set_num_threads(1)


def _tree(rng, n=60):
    parents = np.zeros(n + 1, np.int32)
    parents[1] = 1
    for t in range(2, n + 1):
        parents[t] = rng.integers(1, t)
    return parents, jlca.table_from_parents(parents)


def _window_taxa(rng, n_taxa, b=48, l=128):
    wt = rng.integers(1, n_taxa + 1, (b, l)).astype(np.int32)
    wt[: b // 2] = rng.integers(1, 6, (b // 2, l))  # few distinct taxa
    wt[rng.random((b, l)) < 0.2] = 0
    wt[rng.random((b, l)) < 0.15] = resolve.INVALID_WINDOW
    wt[3] = resolve.INVALID_WINDOW  # no valid window at all
    wt[4] = 0  # valid windows that all missed
    return wt


@pytest.mark.parametrize("max_taxa", [4, 32])
def test_compact_hits_matches_both_jax_variants(rng, max_taxa):
    parents, _ = _tree(rng)
    wt = _window_taxa(rng, len(parents) - 1)
    got = resolve.compact_hits(torch.from_numpy(wt), max_taxa)
    for fn in (jresolve.compact_hits_sort, jresolve.compact_hits_rounds):
        want = fn(jnp.asarray(wt), max_taxa)
        for name in want._fields:
            assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    # both fitting and overflowing rows occur
    assert got.overflow.any() and not got.overflow.all()


@pytest.mark.parametrize("max_taxa", [4, 32])
def test_resolve_and_finalize_match_jax(rng, max_taxa):
    parents, table = _tree(rng)
    wt = _window_taxa(rng, len(parents) - 1)
    b, l = wt.shape
    ch = resolve.compact_hits(torch.from_numpy(wt), max_taxa)
    got = resolve.resolve_hits(ch.taxa, ch.counts, torch.from_numpy(table))
    jch = jresolve.compact_hits_sort(jnp.asarray(wt), max_taxa)
    want = jresolve.resolve_hits(jch.taxa, jch.counts, jnp.asarray(table))
    for name in want._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name

    nd = rng.integers(0, 4, b).astype(np.int32)
    ambig = rng.integers(0, 3, b).astype(np.int32)
    totals = np.arange(l + 1, dtype=np.float64)
    lut = np.stack([np.ceil(t * totals) for t in (0.0, 0.15, 0.31)]).astype(np.int32)
    bundle = finalize(got, torch.from_numpy(nd), ch.n_hit_kmers, ch.n_none_kmers, ch.overflow,
                      torch.from_numpy(ambig), torch.from_numpy(lut))
    want_b = jclassify._finalize_kernel(want, jnp.asarray(nd), jch.n_hit_kmers, jch.n_none_kmers,
                                        jch.overflow, jnp.asarray(ambig), jnp.asarray(lut))
    assert bundle.dtype == torch.int32
    assert np.array_equal(bundle.numpy(), np.asarray(want_b))


def test_lca_of_rpath_set_matches_jax(rng):
    parents, table = _tree(rng)
    taxa = rng.integers(0, len(parents), (30, 6))
    member = rng.random((30, 6)) < 0.6
    member[0] = False
    rp = table[taxa]
    got = lca.lca_of_rpath_set(torch.from_numpy(rp), torch.from_numpy(member))
    want = jlca.lca_of_rpath_set(jnp.asarray(rp), jnp.asarray(member))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_segment_lca_table_matches_jax(rng):
    parents, table = _tree(rng)
    n = 400
    run_ids = np.sort(rng.integers(0, 90, n))
    run_ids = np.unique(run_ids, return_inverse=True)[1]  # contiguous from 0
    taxa = rng.integers(0, len(parents), n).astype(np.int32)
    n_runs = int(run_ids.max()) + 1
    got = lca.segment_lca_table(torch.from_numpy(run_ids), torch.from_numpy(taxa),
                                torch.from_numpy(table), n_runs)
    want = jlca.segment_lca_table(jnp.asarray(run_ids, jnp.int32), jnp.asarray(taxa), jnp.asarray(table))
    assert np.array_equal(got.numpy(), np.asarray(want)[:n_runs])
