"""Lowest common ancestors over root-aligned path tables (counterpart of
slacken_tpu/ops/lca.py).

rpath_table[t, d] is the ancestor of taxon t at tree depth d (root = depth
0), -1 where t is shallower; it is indexed by raw taxon ID. The LCA of a set
of taxa is the deepest level at which all their rows agree, so segment LCA
reduces to per-level segment min/max.
"""

from __future__ import annotations

import torch

NONE = 0
ROOT = 1
BIG = 2**31 - 1


def lca_of_rpath_set(rpaths: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """LCA over a masked set: rpaths [..., T, D] int32, member bool [..., T].
    Returns [...] int32, NONE for an empty set."""
    m = member[..., None]
    mn = torch.where(m, rpaths, BIG).amin(dim=-2)
    mx = torch.where(m, rpaths, -2).amax(dim=-2)
    agree = (mn == mx) & (mn != -1) & (mn != BIG)
    d = torch.arange(rpaths.shape[-1], dtype=torch.int64, device=rpaths.device)
    best = torch.where(agree, d, -1).amax(dim=-1)
    val = torch.gather(mn, -1, best.clamp(min=0)[..., None])[..., 0]
    return torch.where(best >= 0, val, NONE).to(torch.int32)


def segment_lca_table(
    run_ids: torch.Tensor, taxa: torch.Tensor, rpath_table: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """LCA of the taxa in each segment (int32 [num_segments]): run_ids int64
    [N] in [0, num_segments), in any order. NONE taxa are the identity; a
    segment with no common level below the root gets ROOT."""
    taxa = taxa.to(torch.int64)
    defined = taxa != NONE
    best = torch.full((num_segments,), -1, dtype=torch.int32, device=taxa.device)
    val = torch.zeros(num_segments, dtype=torch.int32, device=taxa.device)

    def seg(values, init, reduce):
        out = torch.full((num_segments,), init, dtype=torch.int32, device=taxa.device)
        return out.scatter_reduce(0, run_ids, values, reduce, include_self=False)

    for d in range(rpath_table.shape[-1]):
        lev = rpath_table[:, d][taxa]
        mn = seg(torch.where(defined, lev, BIG), BIG, "amin")
        mx = seg(torch.where(defined, lev, -2), -2, "amax")
        agree = (mn == mx) & (mn != -1) & (mn != BIG)
        best = torch.where(agree, d, best)
        val = torch.where(agree, mn, val)
    any_defined = seg(defined.to(torch.int32), 0, "amax")
    fallback = torch.where(any_defined > 0, ROOT, NONE).to(torch.int32)
    return torch.where(best >= 0, val, fallback).to(torch.int32)
