"""Bracken's weights (Lu et al. 2017, PeerJ CS 3:e104; Slacken's
BrackenWeights.scala) in plain torch: every read of length R that a genome
holds is classified at confidence 0 and counted as (destination, source).
Genomes are cut into fragments of at most FRAGMENT_MAX bases that overlap by
R - 1 (BrackenWeights.scala:152-164, :303), and a read's hit groups are the
distinct-minimizer spans of its fragment that overlap it (FragmentWindow's
inWindow and passedWindow, BrackenWeights.scala:63-73), at least 2 to
classify. Written from those definitions, not from the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..gen.libraries import encode
from .index import ReferenceIndex
from .minimizers import MinimizerSpec, window_minimizers
from .tree import Tree, lca_of_sets

FRAGMENT_MAX = 1024 * 1024
#: read windows a block
WINDOWS = 1 << 17


def fragments(codes: np.ndarray, read_len: int):
    """The fragments of a genome: all of it up to FRAGMENT_MAX, else
    FRAGMENT_MAX bases every FRAGMENT_MAX - (R - 1)."""
    if len(codes) <= FRAGMENT_MAX:
        yield codes
        return
    step = FRAGMENT_MAX - (read_len - 1)
    for off in range(0, len(codes) - read_len + 1, step):
        yield codes[off : off + FRAGMENT_MAX]


def fragment_counts(codes: np.ndarray, index: ReferenceIndex, spec: MinimizerSpec, tree: Tree,
                    read_len: int, device) -> Dict[int, int]:
    """{destination taxon: reads} over the reads of one fragment."""
    L = len(codes)
    k, R = spec.k, read_len
    n_reads = L - R + 1
    if n_reads <= 0:
        return {}
    W = R - k + 1
    wm = window_minimizers(torch.from_numpy(codes).to(device), spec)  # [L - k + 1]
    valid = wm >= 0
    t = torch.where(valid, index.lookup(wm), torch.zeros_like(wm))
    n_pos = wm.shape[0]
    pos = torch.arange(n_pos, device=device)
    # the last valid minimizer before each position, carried over gaps
    last_valid = torch.cummax(torch.where(valid, pos, -1), 0).values
    prev_idx = torch.cat([torch.full((1,), -1, device=device, dtype=torch.int64), last_valid[:-1]])
    prev_min = torch.where(prev_idx >= 0, wm[prev_idx.clamp(min=0)], torch.full_like(wm, -1))
    before_valid = torch.cat([torch.zeros(1, dtype=torch.bool, device=device), valid[:-1]])
    before = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=device), wm[:-1]])
    span_start = valid & (~before_valid | (wm != before))
    distinct = span_start & ((prev_idx < 0) | (wm != prev_min))
    qual = distinct & (t > 0)
    # a span ends at the next span start or invalid position
    boundary = torch.nonzero(span_start | ~valid).flatten()
    starts = torch.nonzero(qual).flatten()
    nxt = torch.searchsorted(boundary, starts, right=True)
    end = torch.where(nxt < boundary.shape[0], boundary[nxt.clamp(max=max(boundary.shape[0] - 1, 0))],
                      torch.full_like(starts, n_pos))
    start_cum = torch.zeros(n_pos + 1, dtype=torch.int64, device=device)
    start_cum[1:] = torch.cumsum(qual.to(torch.int64), 0)
    ends = torch.zeros(n_pos + 1, dtype=torch.int64, device=device)
    ends.index_add_(0, end, torch.ones_like(end))
    passed_cum = torch.cumsum(ends, 0)
    s = torch.arange(n_reads, device=device)
    groups = start_cum[s + W] - passed_cum[s]
    present = torch.unique(t[t > 0])
    if present.shape[0] == 0:
        return {0: n_reads}
    tt = tree.tables(device)
    cidx = tt.lut[present]  # compact index of each present taxon
    S = present.shape[0]
    onehot = (t[None, :] == present[:, None]).to(torch.int32)  # [S, n_pos]
    pref = torch.zeros((S, n_pos + 1), dtype=torch.int32, device=device)
    pref[:, 1:] = torch.cumsum(onehot, 1)
    del onehot
    anc = tt.anc[cidx][:, cidx]  # [S, S]: a is t or above it
    out: Dict[int, int] = {}
    for a in range(0, n_reads, WINDOWS):
        w = s[a : a + WINDOWS]
        cnt = (pref[:, w + W] - pref[:, w]).to(torch.float64)  # [S, n]
        score = anc.T @ cnt
        hit = cnt > 0
        best = torch.where(hit, score, -1.0).amax(dim=0, keepdim=True)
        tied = (hit & (score == best)).T  # [n, S]
        any_hit = hit.any(dim=0)
        tied[~any_hit, 0] = True  # a placeholder; the read answers 0
        dest = tt.taxa[lca_of_sets(tt, tied, tt.path[cidx])]
        dest = torch.where(any_hit & (groups[w] >= 2), dest, torch.zeros_like(dest))
        vals, cts = torch.unique(dest, return_counts=True)
        for v, c in zip(vals.tolist(), cts.tolist()):
            out[v] = out.get(v, 0) + c
    return out


def weights(library: Iterable[Tuple[int, str]], taxa, index: ReferenceIndex, spec: MinimizerSpec,
            tree: Tree, read_len: int, device) -> Dict[Tuple[int, int], int]:
    """(destination, source) -> reads over every genome whose taxon is in
    `taxa`."""
    out: Dict[Tuple[int, int], int] = {}
    for source, seq in library:
        if source not in taxa:
            continue
        for frag in fragments(encode(seq) if isinstance(seq, str) else seq, read_len):
            for dest, c in fragment_counts(frag, index, spec, tree, read_len, device).items():
                out[(dest, source)] = out.get((dest, source), 0) + c
    return out
