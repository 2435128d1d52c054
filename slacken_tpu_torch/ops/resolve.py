"""Batched Kraken 2 resolveTree as dense tensor ops (counterpart of
slacken_tpu/ops/resolve.py): per-read hit taxa compacted to a fixed-width
list [B, T], candidate scores from ancestor tests on root-aligned paths,
tie-break by the LCA of all best-scoring taxa, and the clade scores along
the winner's path so any confidence threshold resolves afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lca import NONE, lca_of_rpath_set

INT_MAX = 2**31 - 1

#: sentinel for "not a valid k-mer window" in per-window taxon arrays
INVALID_WINDOW = -3


class CompactHits(NamedTuple):
    taxa: torch.Tensor  # [B, T] int32, ascending, 0-padded
    counts: torch.Tensor  # [B, T] int32
    n_hit_kmers: torch.Tensor  # [B] int32: windows hitting a taxon (> 0)
    n_none_kmers: torch.Tensor  # [B] int32: valid windows that missed (== 0)
    overflow: torch.Tensor  # [B] bool: more than T distinct taxa


def compact_hits(window_taxa: torch.Tensor, max_taxa: int) -> CompactHits:
    """The first `max_taxa` distinct hit taxa of each row, ascending, with
    their window counts (equal to both compact_hits_sort and
    compact_hits_rounds of the JAX package)."""
    wt = window_taxa.to(torch.int32)
    b = wt.shape[0]
    hit = wt > 0
    s = torch.sort(torch.where(hit, wt, INT_MAX), dim=-1).values
    prev = torch.cat([torch.full((b, 1), -1, dtype=s.dtype, device=s.device), s[:, :-1]], dim=-1)
    is_hit = s != INT_MAX
    start = (s != prev) & is_hit
    run_id = torch.cumsum(start, dim=-1, dtype=torch.int64) - 1
    t = max_taxa
    # slot t collects every dropped write and is sliced off
    kept = run_id < t
    taxa = torch.zeros((b, t + 1), dtype=torch.int32, device=s.device)
    taxa.scatter_(1, torch.where(start & kept, run_id, t), s)
    counts = torch.zeros((b, t + 1), dtype=torch.int32, device=s.device)
    counts.scatter_add_(1, torch.where(is_hit & kept, run_id, t), torch.ones_like(s))
    return CompactHits(
        taxa=taxa[:, :t].contiguous(),
        counts=counts[:, :t].contiguous(),
        n_hit_kmers=hit.sum(-1, dtype=torch.int32),
        n_none_kmers=(wt == NONE).sum(-1, dtype=torch.int32),
        overflow=start.sum(-1) > t,
    )


class ResolveResult(NamedTuple):
    max_taxon: torch.Tensor  # [B] int32: the pre-confidence winning taxon
    path: torch.Tensor  # [B, D] root-aligned path of max_taxon (-1 padded)
    clade: torch.Tensor  # [B, D] int32 clade scores along that path


def resolve_hits(
    taxa: torch.Tensor, counts: torch.Tensor, rpath_table: torch.Tensor
) -> ResolveResult:
    """resolveTree core over compacted hits [B, T] (0-padded). Sums are
    broadcast multiplies reduced with sum: CUDA has no integer matmul."""
    taxa = taxa.to(torch.int32)
    counts = counts.to(torch.int32)
    present = taxa != NONE
    rp = rpath_table[taxa.long()]  # [B, T, D]
    # eq[b, i, j]: hit taxon i is an ancestor-or-self of candidate j
    hit_i = taxa[:, :, None]
    eq = rp[:, None, :, 0] == hit_i
    for d in range(1, rp.shape[-1]):
        eq |= rp[:, None, :, d] == hit_i
    scores = (counts[:, :, None] * eq).sum(1, dtype=torch.int32)
    scores = torch.where(present, scores, 0)
    max_score = scores.amax(-1, keepdim=True)
    tied = present & (scores == max_score) & (max_score > 0)
    max_taxon = lca_of_rpath_set(rp, tied)
    pm = rpath_table[max_taxon.long()]  # [B, D]
    in_clade = (rp == pm[:, None, :]) & (pm[:, None, :] != -1)
    clade = (counts[:, :, None] * in_clade).sum(1, dtype=torch.int32)
    clade = torch.where(pm != -1, clade, 0)
    return ResolveResult(max_taxon=max_taxon, path=pm, clade=clade)
