"""The plain reference's minimizer -> taxon index: every genome's distinct
window minimizers, each key's taxon the LCA of the genomes that hold it,
keys sorted (Kraken 2's and Slacken's index, kept exactly). Plain torch on
the given device, in blocks of positions so that it fits.

`drop_bits` > 0 makes the control: keys keep only their top bits, as a
compact hash table that stores a fragment of each key does (Kraken 2's own
trade of exactness for memory), so that unrelated minimizers share a record.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..gen.libraries import encode
from .minimizers import MinimizerSpec, window_minimizers
from .tree import Tree

#: positions of one block of a genome
BLOCK = 1 << 25


def genome_minimizers(codes: np.ndarray, spec: MinimizerSpec, device) -> torch.Tensor:
    """The distinct valid window minimizers of one genome (int64, sorted)."""
    parts = []
    step = BLOCK - (spec.k - 1)
    for a in range(0, max(len(codes) - spec.k + 1, 1), step):
        block = torch.from_numpy(codes[a : a + BLOCK]).to(device)
        if block.shape[0] < spec.k:
            continue
        w = window_minimizers(block, spec)
        parts.append(torch.unique(w[w >= 0]))
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.unique(torch.cat(parts))


def lca_reduce(keys: torch.Tensor, taxa: torch.Tensor, tree: Tree, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted distinct keys, LCA taxon of each) of (key, taxon) records."""
    order = torch.sort(keys, stable=True).indices
    keys, taxa = keys[order], taxa[order]
    new = torch.ones(keys.shape[0], dtype=torch.bool, device=device)
    new[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    n_runs = int(run[-1]) + 1 if keys.shape[0] else 0
    tt = tree.tables(device)
    paths = tt.path[tt.lut[taxa]]  # [N, D] compact, root first
    big = torch.iinfo(torch.int64).max
    D = paths.shape[1]
    mn = torch.full((n_runs, D), big, dtype=torch.int64, device=device)
    mx = torch.full((n_runs, D), -2, dtype=torch.int64, device=device)
    idx = run[:, None].expand(-1, D)
    mn.scatter_reduce_(0, idx, paths, "amin")
    mx.scatter_reduce_(0, idx, paths, "amax")
    agree = (mn == mx) & (mn >= 0)
    deepest = (D - 1) - torch.argmax(agree.flip(1).to(torch.int8), dim=1)
    lca = mn.gather(1, deepest[:, None])[:, 0]
    return keys[new], tt.taxa[lca].to(torch.int32)


class ReferenceIndex:
    """keys (int64, sorted) and taxa (int32) on `device`."""

    def __init__(self, keys: torch.Tensor, taxa: torch.Tensor, drop_bits: int = 0):
        self.keys, self.taxa, self.drop_bits = keys, taxa, drop_bits

    @classmethod
    def build(cls, library: Iterable[Tuple[int, str]], spec: MinimizerSpec, tree: Tree, device,
              drop_bits: int = 0) -> "ReferenceIndex":
        keys: List[torch.Tensor] = []
        taxa: List[torch.Tensor] = []
        for taxon, seq in library:
            k = genome_minimizers(encode(seq) if isinstance(seq, str) else seq, spec, device)
            if drop_bits:
                k = torch.unique(k >> drop_bits)
            keys.append(k)
            taxa.append(torch.full_like(k, taxon))
        k, t = lca_reduce(torch.cat(keys), torch.cat(taxa), tree, device)
        return cls(k, t, drop_bits)

    def lookup(self, minimizers: torch.Tensor) -> torch.Tensor:
        """int64 taxon of each minimizer (0 where it is not a key or is
        negative)."""
        q = minimizers >> self.drop_bits if self.drop_bits else minimizers
        n = self.keys.shape[0]
        if n == 0:
            return torch.zeros_like(q)
        pos = torch.searchsorted(self.keys, q).clamp(max=n - 1)
        hit = (self.keys[pos] == q) & (minimizers >= 0)
        return torch.where(hit, self.taxa[pos].to(torch.int64), torch.zeros_like(q))
