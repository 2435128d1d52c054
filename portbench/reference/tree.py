"""The taxonomy as the plain reference reads it: parents and ranks from
(taxid, parent, rank) tuples, compact indexes, and the tables that its
vectorised LCA and resolveTree use. Plain Python, numpy and torch; nothing
of the program."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

NONE = 0
ROOT = 1
#: Kraken report rank letters of the standard ranks
RANK_LETTER = {"root": "R", "superkingdom": "D", "kingdom": "K", "phylum": "P", "class": "C",
               "order": "O", "family": "F", "genus": "G", "species": "S"}


class Tree:
    """A taxonomy. `taxa[i]` is the taxon of compact index i; `path[i]` the
    compact indexes of its ancestors from the root down to itself, padded
    with -1 ([T, D]); `anc[a, t]` is 1 where a is t or an ancestor of t."""

    def __init__(self, nodes: Sequence[Tuple[int, int, str]], names: Sequence[Tuple[int, str]]):
        self.parent: Dict[int, int] = {}
        self.rank: Dict[int, str] = {}
        for t, p, r in nodes:
            self.parent[t] = NONE if t == ROOT else p
            self.rank[t] = r
        self.name = dict(names)
        self.taxa = sorted(self.parent)
        self.index = {t: i for i, t in enumerate(self.taxa)}
        paths = [self.lineage(t)[::-1] for t in self.taxa]
        D = max(len(p) for p in paths)
        self.path = np.full((len(self.taxa), D), -1, np.int64)
        for i, p in enumerate(paths):
            self.path[i, : len(p)] = [self.index[x] for x in p]
        T = len(self.taxa)
        self.anc = np.zeros((T, T), np.float64)
        for i, p in enumerate(paths):
            for x in p:
                self.anc[self.index[x], i] = 1.0
        self._tables: Dict[str, "TreeTables"] = {}
        #: children in descending taxid order (the report's order on ties)
        self.children: Dict[int, List[int]] = {t: [] for t in self.taxa}
        for t in sorted(self.taxa, reverse=True):
            if t != ROOT:
                self.children[self.parent[t]].append(t)

    def lineage(self, t: int) -> List[int]:
        """t and its ancestors, up to the root."""
        out = []
        while t != NONE:
            out.append(t)
            t = self.parent[t]
        return out

    def tables(self, device) -> "TreeTables":
        """The tables on `device`, copied there once."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = TreeTables(
                torch.from_numpy(self.path).to(device), torch.from_numpy(self.anc).to(device),
                torch.tensor(self.taxa, dtype=torch.int64, device=device), self._lut(device))
        return self._tables[key]

    def _lut(self, device) -> torch.Tensor:
        """taxon -> compact index, -1 for NONE and undefined taxa."""
        lut = np.full(max(self.taxa) + 1, -1, np.int64)
        lut[self.taxa] = np.arange(len(self.taxa))
        return torch.from_numpy(lut).to(device)


class TreeTables:
    """Tree's tables on a device: path, anc, taxa (compact index -> taxon)
    and lut (taxon -> compact index)."""

    def __init__(self, path, anc, taxa, lut):
        self.path, self.anc, self.taxa, self.lut = path, anc, taxa, lut


def lca_of_sets(tt: TreeTables, member: torch.Tensor, path=None) -> torch.Tensor:
    """The LCA (compact index) of each row's set of taxa, `member` bool
    [n, T] with at least one taxon a row: the deepest level at which every
    member's root path agrees. `path`: the root paths of the T taxa that
    `member`'s columns stand for (default every taxon's, tt.path)."""
    big = torch.iinfo(torch.int64).max
    path = (tt.path if path is None else path)[None, :, :]  # [1, T, D]
    mn = torch.where(member[:, :, None], path, big).amin(dim=1)  # [n, D]
    mx = torch.where(member[:, :, None], path, -2).amax(dim=1)
    agree = (mn == mx) & (mn >= 0)
    D = agree.shape[1]
    deepest = (D - 1) - torch.argmax(agree.flip(1).to(torch.int8), dim=1)
    return mn.gather(1, deepest[:, None])[:, 0]


def resolve(tt: TreeTables, counts: torch.Tensor, required: torch.Tensor) -> torch.Tensor:
    """Kraken 2's resolveTree for each row of `counts` (float64 [n, T] hits
    a taxon, NONE excluded) at `required` (float64 [n] hits): the LCA of the
    hit taxa with the highest root-to-taxon score; then, from it upwards,
    the first taxon whose clade holds `required` hits. Returns taxa (int64
    [n], NONE where no taxon qualifies)."""
    n = counts.shape[0]
    hit = counts > 0
    score = counts @ tt.anc  # [n, T]: hits on the taxon's root path
    best = torch.where(hit, score, -1.0).amax(dim=1, keepdim=True)
    tied = hit & (score == best)
    any_hit = hit.any(dim=1)
    tied[~any_hit, 0] = True  # a placeholder; the row answers NONE
    top = lca_of_sets(tt, tied)  # [n] compact
    clade = counts @ tt.anc.T  # [n, T]: hits in the taxon's clade
    lineage = tt.path[top]  # [n, D], root first
    ok = (lineage >= 0) & (clade.gather(1, lineage.clamp(min=0)) >= required[:, None])
    D = lineage.shape[1]
    deepest = (D - 1) - torch.argmax(ok.flip(1).to(torch.int8), dim=1)
    chosen = lineage.gather(1, deepest[:, None])[:, 0]
    found = any_hit & ok.any(dim=1)
    taxon = tt.taxa[chosen.clamp(min=0)]
    return torch.where(found, taxon, torch.zeros(n, dtype=torch.int64, device=counts.device))
