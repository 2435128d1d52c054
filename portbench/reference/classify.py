"""Kraken 2 / Slacken classification of read pairs, in plain torch and
Python: each mate's k-mer windows, their minimizers looked up in the
reference index, hit counts per taxon, resolveTree at every confidence
threshold against ceil(threshold x k-mers) in float64, the hit-group gate
(distinct minimizers that hit, counted along the read's valid windows, mate
2 after mate 1), the kreport, and the per-read line. Written from the
definitions (Wood et al. 2019; Slacken's Classifier.classify, Supermers and
KrakenReport), not from the program.

Ambiguous bases (anything but A, C, G, T): a window holding one is not
looked up. A stretch of k or more of them counts as len - k + 1 k-mers of
the read, the windows that lie wholly inside it, and shows in the per-read
line as A:<count>; a window holding an ambiguous base and a valid one
counts for nothing and does not show.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from .index import ReferenceIndex
from .minimizers import MinimizerSpec, window_minimizers
from .tree import NONE, RANK_LETTER, ROOT, Tree, resolve

#: read pairs a block
ROWS = 1 << 15
#: window codes of Classified.window_taxa besides taxa
AMBIGUOUS, SKIPPED = -1, -2


class Classified(NamedTuple):
    """Per read: the taxon a threshold reports (0 unclassified) [nthr, n],
    each mate's window codes [n, 2, W] (int64: the taxon of a valid window,
    0 not found; AMBIGUOUS for a window wholly of ambiguous bases, SKIPPED
    for one that holds both kinds), and the minimizers of the sample's valid
    windows, distinct (int64)."""

    taxa: np.ndarray
    window_taxa: torch.Tensor
    distinct_minimizers: int


def classify_pairs(mate1: np.ndarray, mate2: np.ndarray, index: ReferenceIndex, spec: MinimizerSpec,
                   tree: Tree, thresholds: Sequence[float], min_hit_groups: int, device) -> Classified:
    """Classify n pairs of equal-length mates (uint8 codes [n, R], 4 for an
    ambiguous base)."""
    tt = tree.tables(device)
    T = len(tree.taxa)
    k = spec.k
    out = np.zeros((len(thresholds), len(mate1)), np.int64)
    wts, mins = [], []
    for a in range(0, len(mate1), ROWS):
        codes = torch.stack([torch.from_numpy(mate1[a : a + ROWS]), torch.from_numpy(mate2[a : a + ROWS])],
                            dim=1).to(device)  # [b, 2, R]
        wm = window_minimizers(codes, spec)  # [b, 2, W], -1 where a window holds an ambiguous base
        b, W = wm.shape[0], wm.shape[2]
        valid = wm >= 0
        n_amb = torch.nn.functional.pad(torch.cumsum((codes > 3).to(torch.int32), dim=2), (1, 0))
        all_amb = (n_amb[..., k:] - n_amb[..., : W]) == k  # [b, 2, W]: every base of the window ambiguous
        taxa = torch.where(valid, index.lookup(wm), NONE)
        wts.append(torch.where(valid, taxa, torch.where(all_amb, AMBIGUOUS, SKIPPED)))
        mins.append(torch.unique(wm[valid]))
        flat_m, flat_t, flat_v = wm.reshape(b, -1), taxa.reshape(b, -1), valid.reshape(b, -1)  # mate 2 after mate 1
        # a hit group starts where a valid window's minimizer differs from the previous valid window's
        pos = torch.arange(flat_m.shape[1], device=device).expand(b, -1)
        last = torch.cummax(torch.where(flat_v, pos, -1), dim=1).values
        prev = torch.nn.functional.pad(last[:, :-1], (1, 0), value=-1)
        change = (prev < 0) | (flat_m != flat_m.gather(1, prev.clamp(min=0)))
        groups = (flat_v & change & (flat_t != NONE)).sum(dim=1)
        counts = torch.zeros((b, T), dtype=torch.float64, device=device)
        cidx = torch.where(flat_v, tt.lut[flat_t], -1)
        counts.scatter_add_(1, cidx.clamp(min=0), (cidx >= 0).to(torch.float64))
        total = (flat_v.sum(dim=1) + all_amb.reshape(b, -1).sum(dim=1)).to(torch.float64)
        for i, thr in enumerate(thresholds):
            required = torch.ceil(float(thr) * total)  # ceil(threshold x k-mers) in float64
            taxon = resolve(tt, counts, required)
            taxon = torch.where(groups >= min_hit_groups, taxon, torch.zeros_like(taxon))
            out[i, a : a + b] = taxon.cpu().numpy()
    n_distinct = int(torch.unique(torch.cat(mins)).shape[0]) if mins else 0
    return Classified(out, torch.cat(wts), n_distinct)


def kreport_lines(tree: Tree, taxa: np.ndarray) -> List[str]:
    """The Kraken report of reads reporting `taxa` (0 unclassified): a
    header, the unclassified row, then a depth-first walk from the root,
    children by descending clade count (descending taxid on ties), zero
    clades left out."""
    vals, cts = np.unique(taxa, return_counts=True)
    own: Dict[int, int] = {int(v): int(c) for v, c in zip(vals, cts)}
    clade: Dict[int, int] = {}
    for t, c in own.items():
        for x in ([NONE] if t == NONE else tree.lineage(t)):
            clade[x] = clade.get(x, 0) + c
    total = sum(own.values()) or 1

    def line(t, code, indent):
        c = clade.get(t, 0)
        name = "unclassified" if t == NONE else tree.name.get(t, "")
        return f"{'%6.2f' % (100.0 * c / total)}\t{c}\t{own.get(t, 0)}\t{code}\t{t}\t{'  ' * indent}{name}"

    lines = ["#Perc\tAggregate\tIn taxon\tRank\tTaxon\tName"]
    if own.get(NONE, 0):
        lines.append(line(NONE, "U", 0))
    stack = [(ROOT, "R", 0, 0)]  # taxon, inherited rank letter, steps below it, indent
    while stack:
        t, letter, sub, indent = stack.pop()
        if tree.rank.get(t) in RANK_LETTER:
            letter, sub = RANK_LETTER[tree.rank[t]], 0
        elif t != ROOT:
            sub += 1
        lines.append(line(t, letter + (str(sub) if sub else ""), indent))
        kids = sorted(((c, clade.get(c, 0)) for c in tree.children[t]), key=lambda x: -x[1])
        for c, n in reversed(kids):
            if n > 0:
                stack.append((c, letter, sub, indent + 1))
    return lines


def hit_string(window_taxa: np.ndarray, k: int) -> str:
    """The threshold-free tail of a pair's per-read line: each mate's length
    in k-mers that count plus k - 1, a tab, and each mate's runs of equal
    window codes (taxon:windows, A:windows for ambiguous ones; windows that
    count for nothing left out), |:| between the mates. window_taxa int
    [2, W], Classified's codes."""
    pieces, lengths = [], []
    for j, mate in enumerate(window_taxa):
        if j:
            pieces.append("|:|")
        mate = mate[mate != SKIPPED]
        cut = np.flatnonzero(np.diff(mate)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [len(mate)]])
        if len(mate):
            pieces += [f"{'A' if mate[s] == AMBIGUOUS else int(mate[s])}:{e - s}" for s, e in zip(starts, ends)]
        lengths.append(len(mate) + k - 1)
    return f"{'|'.join(map(str, lengths))}\t{' '.join(pieces)}"


def read_line(title: str, taxon: int, window_taxa: np.ndarray, k: int, hits: str = None) -> str:
    """The per-read line of a pair: C or U, the title, the reported taxon,
    then hit_string (or `hits`, that string made before)."""
    flag = "C" if taxon != NONE else "U"
    return f"{flag}\t{title}\t{taxon}\t{hit_string(window_taxa, k) if hits is None else hits}"
