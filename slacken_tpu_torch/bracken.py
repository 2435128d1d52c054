"""Bracken weight generation (counterpart of slacken_tpu/bracken.py;
reference: BrackenWeights.scala).

Simulates every read of length R from every genome in the library,
classifies it against the index, and counts (destination taxon, source
taxon) pairs, written as a Bracken kmer_distrib file.

A genome is cut into fragments of at most FRAGMENT_MAX bases that overlap by
R - 1, so every read window lies in exactly one fragment. Fragments go to
the device in rows of a power-of-two width, a batch of about 4 Mi positions
at a time. The fragment pass there is the classify chain's first half: the
scan kernel and the probe kernel (their twins on the CPU), for narrow, wide
and rank-table indexes alike, giving each position's window taxon, validity,
span start and distinct flag. Every read window of a fragment is then
classified by prefix sums over those arrays: per-taxon k-mer counts over a
window are differences of prefix sums, resolveTree at confidence 0 is the
argmax of ancestor-weighted scores with an LCA tie-break, and the hit-group
gate is two more prefix-sum lookups. On the card that runs as torch ops
(`window_dest_counts`), rows that hit many taxa in a group of their own; on
the CPU in numpy (`_fragment_dest_counts`, the JAX package's host code),
which the tests also hold the torch ops to.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import get_device, to_device
from .index import KeyValueIndex
from .ops import encode
from .ops.lookup import probe
from .ops.minimizers import window_minimizers_packed
from .ops.resolve import INT_MAX, INVALID_WINDOW, compact_hits
from .taxonomy import NONE

FRAGMENT_MAX = 1024 * 1024  # BrackenWeights.scala:303
#: positions of fragment rows that make a batch (a flush of one row width)
BATCH_POSITIONS = 1 << 22
#: elements of one [rows, taxa, windows] block of the device window
#: classifier: the windows of a batch go through it in blocks this size
WINDOW_BLOCK = 1 << 24
#: rows that hit more taxa than this go through the device window
#: classifier in a group of their own
FEW_TAXA = 64


class FragmentScan(NamedTuple):
    """Per-position results of the fragment pass, each [B, L] on the device."""

    looked: torch.Tensor  # int32: the taxon of the window starting there, NONE on a miss
    valid: torch.Tensor  # bool: the window is valid
    span_start: torch.Tensor  # bool
    distinct: torch.Tensor  # bool


def fragment_pass(index: KeyValueIndex, codes: np.ndarray, device) -> FragmentScan:
    """Scan and probe genome-fragment rows (codes uint8 [B, L], L % 8 == 0)
    on `device`: the scan kernel and the probe kernel on the card, their
    plain twins on the CPU, for any kind of index (the chain of
    dynamic.Dynamic._span_hits)."""
    device = torch.device(device)
    keys, taxa, directory = index.device_arrays(device)
    packed, valid = encode.pack_2bit(codes)
    wm = window_minimizers_packed(to_device(packed, device), to_device(valid, device),
                                  index.params.minimizer_params, index.device_lut(device))
    b, l = wm.valid.shape
    looked = probe(keys, taxa, directory, wm.minimizer.flatten(0, 1)).reshape(b, l)
    return FragmentScan(looked, wm.valid, wm.span_start, wm.distinct)


def _hit_groups(scan: FragmentScan, w_kmers: int, n_windows: int) -> torch.Tensor:
    """int32 [B, n_windows]: the qualifying spans (distinct, hitting a
    taxon) that overlap each read window: spans started before its end less
    spans ended before its start (FragmentWindow.inWindow/passedWindow,
    BrackenWeights.scala:63-73)."""
    looked, valid, span_start, distinct = scan
    b, l = looked.shape
    dev = looked.device
    qual = (span_start & distinct & (looked > 0) & valid).to(torch.int32)
    zero = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    start_cum = torch.cat([zero, torch.cumsum(qual, -1, dtype=torch.int32)], -1)
    # a span's last k-mer is the one before the next boundary (a span start
    # or an invalid window) strictly after its start
    pos = torch.arange(l, dtype=torch.int64, device=dev).expand(b, l)
    boundary = torch.where(span_start | ~valid, pos, l)
    next_b = torch.flip(torch.cummin(torch.flip(boundary, [-1]), -1).values, [-1])
    nb_after = torch.cat([next_b[:, 1:], torch.full((b, 1), l, dtype=torch.int64, device=dev)], -1)
    ends = torch.zeros((b, l + 1), dtype=torch.int32, device=dev)
    ends.scatter_add_(1, torch.where(qual > 0, nb_after, l), qual)
    passed_cum = torch.cumsum(ends, -1, dtype=torch.int32)
    return start_cum[:, w_kmers : w_kmers + n_windows] - passed_cum[:, :n_windows]


def hit_taxa_per_row(scan: FragmentScan) -> torch.Tensor:
    """int64 [B]: the distinct taxa that valid windows of each row hit."""
    t = torch.where(scan.valid & (scan.looked > 0), scan.looked, INT_MAX)
    s = torch.sort(t, -1).values
    start = torch.cat([s[:, :1] != INT_MAX, (s[:, 1:] != s[:, :-1]) & (s[:, 1:] != INT_MAX)], -1)
    return start.sum(-1)


def window_classify(
    scan: FragmentScan, rpath_table: torch.Tensor, read_len: int, k: int, n_taxa: int
) -> torch.Tensor:
    """dest int32 [B, L - read_len + 1]: the destination taxon of the read
    starting at each position of fragment rows, classified on their device
    (replaces the XLA-compiled `_window_classify_kernel`,
    slacken_tpu/bracken.py:351). `n_taxa` is at least the most distinct hit
    taxa of any row (hit_taxa_per_row). Torch ops, in blocks of windows:
    per-taxon prefix sums, exact score products in float64 (integers far
    below 2^53; no TF32), and the LCA of the tied set as the deepest node, on
    the paths of the row's taxa, above all of them (a count by a second
    product), then the hit-group gate."""
    looked, valid = scan.looked, scan.valid
    b, l = looked.shape
    w_kmers = read_len - k + 1
    n_windows = l - read_len + 1
    dev = looked.device
    dest = torch.zeros((b, max(n_windows, 0)), dtype=torch.int32, device=dev)
    if n_taxa == 0 or n_windows <= 0:
        return dest
    ch = compact_hits(torch.where(valid, looked, INVALID_WINDOW), n_taxa)
    taxa = ch.taxa  # ascending, NONE-padded
    s = taxa.shape[1]
    present = taxa != NONE
    rp = torch.where(present[:, :, None], rpath_table[taxa.long()], -1)  # [B, S, D] root-aligned
    rp_t = rp.transpose(1, 2)
    level_of = (rpath_table >= 0).sum(-1) - 1  # a taxon's column in its own path

    def on_paths(nodes):
        """[B, N, S]: node n lies on the path of taxon j (j itself included)."""
        level = level_of[nodes.clamp(min=0).long()].clamp(min=0)
        at = torch.gather(rp_t, 1, level[:, :, None].expand(b, nodes.shape[1], s))
        return (at == nodes[:, :, None]) & (nodes >= 0)[:, :, None]

    # every node on the taxa's paths, distinct a row, -1 padded: [B, A]
    flat = torch.sort(torch.where(rp >= 0, rp, INT_MAX).flatten(1), -1).values
    first = torch.cat([flat[:, :1] != INT_MAX, (flat[:, 1:] != flat[:, :-1]) & (flat[:, 1:] != INT_MAX)], -1)
    a = int(first.sum(-1).max())
    nodes = torch.full((b, a + 1), -1, dtype=torch.int32, device=dev)
    nodes.scatter_(1, torch.where(first, torch.cumsum(first, -1) - 1, a), flat)
    nodes = nodes[:, :a]
    node_level = torch.where(nodes >= 0, level_of[nodes.clamp(min=0).long()], -1)
    anc_t = on_paths(taxa).transpose(1, 2).to(torch.float64)  # [B, S(j), S(i)]: hit i above-or-at j
    below = on_paths(nodes).to(torch.float64)  # [B, A, S]
    t = torch.where(valid, looked, NONE)
    hit_groups = _hit_groups(scan, w_kmers, n_windows)
    block = max(1, WINDOW_BLOCK // (b * max(s, a)))
    for w0 in range(0, n_windows, block):
        nw = min(block, n_windows - w0)
        seg = t[:, w0 : w0 + nw + w_kmers - 1]
        onehot = (seg[:, None, :] == taxa[:, :, None]) & present[:, :, None]
        pref = torch.cumsum(onehot, -1, dtype=torch.int32)
        pref = torch.cat([torch.zeros((b, s, 1), dtype=torch.int32, device=dev), pref], -1)
        cnt = (pref[:, :, w_kmers : w_kmers + nw] - pref[:, :, :nw]).to(torch.float64)  # [B, S, nw]
        scores = torch.bmm(anc_t, cnt)
        tied = ((scores == scores.amax(1, keepdim=True)) & present[:, :, None]).to(torch.float64)
        # the nodes above every tied taxon; the deepest of them is their LCA
        above_all = torch.bmm(below, tied) == tied.sum(1, keepdim=True)  # [B, A, nw]
        deepest = torch.where(above_all, node_level[:, :, None], -1).max(1)
        lca = torch.where(deepest.values >= 0, torch.gather(nodes, 1, deepest.indices), NONE)
        hit = cnt.sum(1) > 0
        dest[:, w0 : w0 + nw] = torch.where(hit & (hit_groups[:, w0 : w0 + nw] >= 2), lca, NONE)
    return dest


def window_dest_counts(
    scan: FragmentScan, rpath_table: torch.Tensor, read_len: int, k: int, row_windows: Sequence[int]
) -> List[Dict[int, int]]:
    """{destination taxon: reads} of each row's first `row_windows[row]` read
    windows, counted on the scan's device. Rows of at most FEW_TAXA hit taxa
    are classified together, the others after them, so that a row with many
    taxa does not widen the rest."""
    n_taxa = hit_taxa_per_row(scan)
    b = n_taxa.shape[0]
    dev = scan.looked.device
    out: List[Dict[int, int]] = [{} for _ in range(b)]
    many = n_taxa > FEW_TAXA
    for group in (~many, many):
        rows = torch.nonzero(group)[:, 0]
        if rows.numel() == 0:
            continue
        dest = window_classify(FragmentScan(*(x[rows] for x in scan)), rpath_table, read_len, k,
                               int(n_taxa[rows].max()))
        lim = torch.tensor(list(row_windows), dtype=torch.int64, device=dev)[rows]
        mask = torch.arange(dest.shape[1], device=dev)[None, :] < lim[:, None]
        key = rows[:, None] * (1 << 32) + dest.to(torch.int64)
        vals, cts = torch.unique(key[mask], return_counts=True)
        for v, c in zip(vals.tolist(), cts.tolist()):
            out[v >> 32][v & 0xFFFFFFFF] = c
    return out


class BrackenWeights:
    def __init__(self, index: KeyValueIndex, read_len: int, device="cuda"):
        self.index = index
        self.read_len = read_len
        self.device = get_device(device)
        self._table: Optional[torch.Tensor] = None
        if read_len < index.params.k:
            raise ValueError(f"read length {read_len} must be >= k {index.params.k}")

    # -- core: classify every window of one fragment -------------------------

    def _fragment_dest_counts(
        self, taxa_pos: np.ndarray, valid: np.ndarray, span_start: np.ndarray,
        distinct: np.ndarray, frag_len: int
    ) -> Dict[int, int]:
        """Counts of destination taxa over all read windows of a fragment.

        taxa_pos/valid/span_start/distinct: per-position host arrays (length
        >= frag_len) of the fragment pass. Windows start at 0..frag_len-R.
        """
        R = self.read_len
        k = self.index.params.k
        W = R - k + 1  # k-mers per read window
        n_windows = frag_len - R + 1
        if n_windows <= 0:
            return {}

        # per-position hit taxon: NONE where the k-mer is invalid
        t = np.where(valid[:frag_len], taxa_pos[:frag_len], NONE).astype(np.int64)

        # for window [s, s+W): #(qualifying spans with start < s+W)
        #                     - #(qualifying spans fully before s)
        qual = span_start[:frag_len] & distinct[:frag_len] & (t > 0)
        start_cum = np.concatenate([[0], np.cumsum(qual)])  # S1[x] = starts < x
        # a span is passed before s iff its last k-mer position < s; mark
        # the position after each span's last k-mer
        ends = np.zeros(frag_len + 1, np.int64)
        starts_idx = np.flatnonzero(qual)
        if len(starts_idx):
            # a span ends where the next span starts or validity ends
            boundary = np.flatnonzero(span_start[:frag_len] | ~valid[:frag_len])
            nxt = np.searchsorted(boundary, starts_idx, side="right")
            end_pos = np.where(
                nxt < len(boundary), boundary[np.minimum(nxt, len(boundary) - 1)], frag_len
            )
            np.add.at(ends, end_pos, 1)
        passed_cum = np.cumsum(ends)  # S2[x] = spans fully before x (end <= x)

        s = np.arange(n_windows)
        # spans overlapping window [s, s+W) (FragmentWindow.inWindow /
        # passedWindow, BrackenWeights.scala:63-73)
        hit_groups = start_cum[s + W] - passed_cum[s]

        taxa_list = np.unique(t[t > 0])
        if len(taxa_list) == 0:
            return {NONE: n_windows}

        tax = self.index.taxonomy
        # prefix sums per taxon: cnt[i, s] = count of taxa_list[i] in window s
        onehot = t[None, :] == taxa_list[:, None]  # [S, L]
        pref = np.concatenate(
            [np.zeros((len(taxa_list), 1), np.int64), np.cumsum(onehot, axis=1)], axis=1
        )
        cnt = pref[:, s + W] - pref[:, s]  # [S, n_windows]

        # ancestor matrix over the small taxon set
        S = len(taxa_list)
        anc = np.zeros((S, S), bool)
        paths = []
        for j, tj in enumerate(taxa_list):
            pj = list(tax.path_to_root(int(tj)))
            paths.append(pj)
            pset = set(pj)
            for i, ti in enumerate(taxa_list):
                anc[i, j] = int(ti) in pset

        scores = anc.T.astype(np.int64) @ cnt  # [S(j), n_windows]
        max_scores = scores.max(axis=0)
        # resolveTree at required=0: maxTaxon with LCA tie-break
        tied = (scores == max_scores[None, :]) & (cnt.sum(axis=0)[None, :] > 0)
        # LCA over tied: root-aligned paths
        D = tax.max_path_len
        rp = np.full((S, D), -1, np.int64)
        for i, pj in enumerate(paths):
            d = len(pj) - 1
            for step, node in enumerate(pj):
                rp[i, d - step] = node
        big = np.int64(2**62)
        mn = np.where(tied[:, :, None], rp[:, None, :], big).min(axis=0)  # [W, D]
        mx = np.where(tied[:, :, None], rp[:, None, :], np.int64(-2)).max(axis=0)
        agree = (mn == mx) & (mn != -1) & (mn != big)
        best = np.where(agree.any(axis=1), agree.shape[1] - 1 - np.argmax(agree[:, ::-1], axis=1), 0)
        dest = np.where(
            agree.any(axis=1), np.take_along_axis(mn, best[:, None], axis=1)[:, 0], NONE
        )
        # hit-group gate (minHitGroups=2, TaxonFragment.classify,
        # BrackenWeights.scala:276-284)
        dest = np.where(hit_groups >= 2, dest, NONE)

        vals, counts = np.unique(dest, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    # -- pipeline ------------------------------------------------------------

    def _iter_fragments(self, library, taxa: Set[int]):
        """(taxon, fragment codes) with FRAGMENT_MAX splitting and R-1 overlap
        (TaxonFragment.splitToMaxLength, BrackenWeights.scala:152-164)."""
        R = self.read_len
        for taxon, header, seq in library.sequences():
            taxon = int(self.index.taxonomy.primary[taxon]) if taxon < len(
                self.index.taxonomy.primary
            ) else taxon
            if taxon not in taxa:
                continue
            codes = encode.encode_seq(seq)
            if len(codes) <= FRAGMENT_MAX:
                yield taxon, codes
            else:
                step = FRAGMENT_MAX - (R - 1)
                for off in range(0, len(codes) - R + 1, step):
                    yield taxon, codes[off : off + FRAGMENT_MAX]

    def _rpath_table(self) -> torch.Tensor:
        if self._table is None:
            self._table = torch.from_numpy(self.index.taxonomy.rpath_table()).to(self.device)
        return self._table

    def _dest_counts(self, scan: FragmentScan, lengths: Sequence[int]) -> List[Dict[int, int]]:
        """{destination taxon: reads} of each fragment row of one batch: on
        the card by the device window classifier, on the CPU by numpy."""
        R = self.read_len
        if self.device.type == "cuda":
            return window_dest_counts(scan, self._rpath_table(), R, self.index.params.k,
                                      [n - R + 1 for n in lengths])
        host = [x.numpy() for x in scan]
        return [self._fragment_dest_counts(*(x[row] for x in host), n) for row, n in enumerate(lengths)]

    def build_weights(self, library, taxa: Set[int]) -> Dict[Tuple[int, int], int]:
        """(dest, source) -> read count over all simulated reads
        (BrackenWeights.buildWeights, BrackenWeights.scala:312-354)."""
        out: Dict[Tuple[int, int], int] = {}
        # fragments batched by padded row width
        pend: Dict[int, List[Tuple[int, np.ndarray]]] = {}

        def flush(bucket, items):
            codes, _ = encode.pack_batch([c for _, c in items], bucket)
            scan = fragment_pass(self.index, codes, self.device)
            for (source, _), dc in zip(items, self._dest_counts(scan, [len(c) for _, c in items])):
                for dest_t, n in dc.items():
                    key = (int(dest_t), source)
                    out[key] = out.get(key, 0) + n

        for taxon, codes in self._iter_fragments(library, taxa):
            bucket = 1 << max(10, (len(codes) - 1).bit_length())
            pend.setdefault(bucket, []).append((taxon, codes))
            if len(pend[bucket]) * bucket >= BATCH_POSITIONS:
                flush(bucket, pend[bucket])
                pend[bucket] = []
        for bucket, items in pend.items():
            if items:
                flush(bucket, items)
        return out

    def build_weights_gradually(
        self, library, taxa: Set[int], temp_location: str, chunks: int = 5
    ) -> Dict[Tuple[int, int], int]:
        """Chunk the taxon set and persist each chunk's counts durably so an
        interrupted job only loses the latest batch
        (BrackenWeights.scala:356-374). The chunk files are slacken_tpu's:
        a run either package began, either package resumes."""
        os.makedirs(temp_location, exist_ok=True)
        taxa_sorted = sorted(taxa)
        size = max(1, len(taxa_sorted) // chunks)
        total: Dict[Tuple[int, int], int] = {}
        for ci in range(0, len(taxa_sorted), size):
            chunk_file = os.path.join(temp_location, f"chunk{ci}.npz")
            if os.path.exists(chunk_file):
                data = np.load(chunk_file)
                part = {
                    (int(d), int(s)): int(c)
                    for d, s, c in zip(data["dest"], data["source"], data["count"])
                }
            else:
                part = self.build_weights(library, set(taxa_sorted[ci : ci + size]))
                np.savez(
                    chunk_file,
                    dest=np.array([k[0] for k in part], np.int64),
                    source=np.array([k[1] for k in part], np.int64),
                    count=np.array(list(part.values()), np.int64),
                )
            for key, c in part.items():
                total[key] = total.get(key, 0) + c
        return total

    def build_and_write_weights(
        self, library, taxa: Set[int], output_location: str, gradual: bool = False
    ):
        os.makedirs(os.path.dirname(output_location) or ".", exist_ok=True)
        if gradual:
            counts = self.build_weights_gradually(library, taxa, output_location + "_tmp")
        else:
            counts = self.build_weights(library, taxa)
        write_kmer_distrib(counts, output_location)
        if gradual:
            shutil.rmtree(output_location + "_tmp", ignore_errors=True)
        return counts


def write_kmer_distrib(counts: Dict[Tuple[int, int], int], output_location: str):
    """Bracken kmer_distrib format (BrackenWeights.scala:418-430):
    mapped_taxid<TAB>genome_taxids:kmers_mapped:total_genome_kmers ..."""
    totals: Dict[int, int] = {}
    for (dest, source), c in counts.items():
        totals[source] = totals.get(source, 0) + c
    by_dest: Dict[int, List[Tuple[int, int]]] = {}
    for (dest, source), c in counts.items():
        by_dest.setdefault(dest, []).append((source, c))
    with open(output_location, "w") as f:
        f.write("mapped_taxid\tgenome_taxids:kmers_mapped:total_genome_kmers\n")
        for dest in sorted(by_dest):
            parts = " ".join(
                f"{s}:{c}:{totals[s]}" for s, c in sorted(by_dest[dest])
            )
            f.write(f"{dest}\t{parts}\n")
