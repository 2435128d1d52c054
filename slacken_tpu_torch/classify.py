"""Read classification, reports mode (counterpart of slacken_tpu/classify.py).

Per batch of packed reads, on the device:

  1. minimizer scan over the 2-bit wire format (CUDA scan kernel; the
     unpack is fused into it),
  2. a probe of every window position (CUDA fence probe kernel),
  3. window taxa (INVALID_WINDOW where the window is invalid) and the
     distinct hit-group count per read,
  4. hit compaction and batched resolveTree,
  5. per-threshold finalisation against a host-computed table of
     ceil_f64(threshold * total), giving one [B, 3 + nthr] int32 bundle,
     the only array copied back.

The host packs batches, keeps up to PIPELINE_DEPTH batches in flight
(launches are asynchronous until the host reads a bundle), resolves the rare
rows with more than `max_taxa` distinct taxa exactly on the host, applies the
min-hit-groups gate, and aggregates per-sample Kraken reports. On a CPU
device the same code runs the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import collections
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from slacken_tpu.report import KrakenReport
from slacken_tpu.taxonomy import NONE
from slacken_tpu.utils import prefetch_iterator

from . import to_device
from .index import KeyValueIndex
from .ops import encode
from .ops.lookup import probe
from .ops.minimizers import window_minimizers_packed
from .ops.resolve import INVALID_WINDOW, ResolveResult, compact_hits, resolve_hits

#: batches launched ahead of the one the host post-processes
PIPELINE_DEPTH = 3

PER_READ_LATER = (
    "per-read (detailed) output is not ported yet; use --no-detailed "
    "(ROADMAP.md, port queue: per-read output)"
)


@dataclass
class ClassifyParams:
    """Classification parameters (as slacken_tpu.classify.ClassifyParams)."""

    min_hit_groups: int = 2
    with_unclassified: bool = True
    thresholds: Sequence[float] = (0.0,)
    sample_regex: Optional[str] = None
    per_read_output: bool = True


def finalize(
    res: ResolveResult, num_distinct, n_hit, n_none, overflow, ambig, req_lut
) -> torch.Tensor:
    """Per-threshold confidence resolution on the device (as
    slacken_tpu.classify._finalize_kernel). req_lut [nthr, tmax+1] holds the
    host's exact ceil_f64(threshold * total) for every possible total.
    Returns [B, 3 + nthr] int32: (num_distinct, total, overflow, raw taxon
    per threshold, before the min-hit-groups gate)."""
    total = n_hit + n_none + ambig
    tmax = req_lut.shape[1] - 1
    req = req_lut[:, total.clamp(0, tmax).long()]  # [nthr, B]
    path, clade = res.path, res.clade  # [B, D]
    ok = (path != -1)[None] & (clade[None] >= req[:, :, None])  # [nthr, B, D]
    any_ok = ok.any(-1)
    d = path.shape[1]
    # deepest satisfying position: first True of the reversed row
    dsel = d - 1 - torch.argmax(torch.flip(ok, [-1]).to(torch.int32), dim=-1)
    picked = torch.gather(path.expand(len(req_lut), -1, -1), 2, dsel[..., None])[..., 0]
    taxon = torch.where(any_ok, picked, NONE)
    taxon = torch.where(res.max_taxon[None] == NONE, NONE, taxon)
    return torch.cat(
        [
            num_distinct[:, None].to(torch.int32),
            total[:, None].to(torch.int32),
            overflow[:, None].to(torch.int32),
            taxon.T.to(torch.int32),
        ],
        dim=1,
    )


def classify_batch(packed, valid, ambig, keys, taxa, fence, table, req_lut, mp, max_taxa):
    """The device body for one batch: (bundle [B, 3+nthr], window taxa [B, L])."""
    wm = window_minimizers_packed(packed, valid, mp)
    b, l = wm.valid.shape
    looked = probe(keys, taxa, fence, wm.minimizer.reshape(-1)).reshape(b, l)
    window_taxa = torch.where(wm.valid, looked, INVALID_WINDOW)
    # hit groups: spans whose minimizer is distinct AND found in the index
    num_distinct = (wm.span_start & wm.distinct & (looked > 0) & wm.valid).sum(
        -1, dtype=torch.int32
    )
    ch = compact_hits(window_taxa, max_taxa)
    res = resolve_hits(ch.taxa, ch.counts, table)
    bundle = finalize(
        res, num_distinct, ch.n_hit_kmers, ch.n_none_kmers, ch.overflow, ambig, req_lut
    )
    return bundle, window_taxa


# ---------------------------------------------------------------------------
# Host helpers (copies of slacken_tpu/classify.py's, which imports JAX)
# ---------------------------------------------------------------------------


def _char_runs(valid: np.ndarray):
    """Yield (start, end, is_valid) maximal runs of the boolean array."""
    n = len(valid)
    if n == 0:
        return
    change = np.flatnonzero(valid[1:] != valid[:-1]) + 1
    bounds = [0, *change.tolist(), n]
    for a, b in zip(bounds[:-1], bounds[1:]):
        yield a, b, bool(valid[a])


def _ambig_kmers(codes_row: np.ndarray, split: Optional[int], row_len: int, k: int) -> int:
    """Pseudo-kmers from ambiguous char-runs >= k, per mate."""
    total = 0
    slices = [(0, row_len)] if split is None else [(0, split), (split + 1, row_len)]
    for a, b in slices:
        for i, j, is_valid in _char_runs(codes_row[a:b] < 4):
            if not is_valid and (j - i) >= k:
                total += (j - i) - k + 1
    return total


def _ambig_array(codes, splits, row_lens, k, n):
    """[B] int32 ambiguous pseudo-kmer counts; only rows whose invalid-char
    count exceeds pure padding are scanned."""
    ambig = np.zeros(codes.shape[0], np.int32)
    bucket = codes.shape[1]
    n_invalid = (codes[:n] == encode.INVALID).sum(axis=1)
    suspects = np.flatnonzero(
        n_invalid > (bucket - np.array(row_lens)) + np.array([s is not None for s in splits])
    )
    for i in suspects:
        ambig[i] = _ambig_kmers(codes[i], splits[i], row_lens[i], k)
    return ambig


def _resolve_host(parents: np.ndarray, hit_counts: Dict[int, int], required: float) -> int:
    """Exact host resolveTree for reads overflowing the device's max-taxa
    budget (LowestCommonAncestor.scala:101-146)."""

    def path(t):
        out = []
        while t != NONE:
            out.append(t)
            t = int(parents[t])
        return out

    def lca(a, b):
        if a == NONE or b == NONE:
            return a if b == NONE else b
        pa = set(path(a))
        t = b
        while t != NONE:
            if t in pa:
                return t
            t = int(parents[t])
        return 1

    max_taxon, max_score = 0, 0
    for taxon in hit_counts:
        if taxon == NONE:
            continue
        score = sum(hit_counts.get(n, 0) for n in path(taxon))
        if score > max_score:
            max_taxon, max_score = taxon, score
        elif score == max_score:
            max_taxon = lca(max_taxon, taxon)

    max_score = hit_counts.get(max_taxon, 0)
    while max_taxon != NONE and max_score < required:
        anc = max_taxon
        max_score = sum(c for t, c in hit_counts.items() if t != NONE and anc in path(t))
        if max_score >= required:
            return max_taxon
        max_taxon = int(parents[max_taxon])
    return max_taxon


def _window_taxa_counts(window_taxa_row: np.ndarray) -> Dict[int, int]:
    vals, counts = np.unique(window_taxa_row[window_taxa_row >= 0], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def format_threshold(t: float, thresholds: Sequence[float]) -> str:
    """Format with the max decimal places across the thresholds so file
    names sort."""
    decimals = max(len(repr(float(x)).split(".")[1]) for x in thresholds)
    return f"%.{decimals}f" % t


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------


@dataclass
class _Batch:
    titles: List[str]
    num_distinct: np.ndarray
    total_kmers: np.ndarray
    final_taxa: Dict[float, np.ndarray]
    #: {row: window taxa row} for the rows that overflowed max_taxa
    overflow_window_taxa: Dict[int, np.ndarray]


class Classifier:
    """Classify packed reads against a KeyValueIndex on `device`."""

    def __init__(
        self,
        index: KeyValueIndex,
        device,
        max_taxa_per_read: int = 32,
    ):
        self.device = torch.device(device)
        self.index = index
        self.max_taxa = max_taxa_per_read
        self._cuda = self.device.type == "cuda"
        # 4 Mbp batches on the card, 1 Mbp on the CPU (cache residency)
        self.target_batch_bp = (1 << 22) if self._cuda else (1 << 20)
        self._keys, self._taxa, self._fence = index.device_arrays(self.device)
        # indexed by raw taxon ID: [max_id + 1, D], copied to the device once
        self._table = torch.from_numpy(index.taxonomy.rpath_table()).to(self.device)
        self._req_luts: Dict[tuple, torch.Tensor] = {}
        self._thresholds: tuple = (0.0,)

    def _rows_target(self, width: int) -> int:
        return max(8, self.target_batch_bp // width)

    def _req_lut(self, tmax: int) -> torch.Tensor:
        """[nthr, tmax+1] int32 ceil_f64(t * total) for every possible total."""
        key = (self._thresholds, tmax)
        if key not in self._req_luts:
            totals = np.arange(tmax + 1, dtype=np.float64)
            lut = np.stack([np.ceil(t * totals) for t in self._thresholds]).astype(np.int32)
            self._req_luts[key] = torch.from_numpy(lut).to(self.device)
        return self._req_luts[key]

    def _dispatch(self, codes: np.ndarray, titles, splits, row_lens):
        """Launch one batch; pair with _harvest. Rows pad to a power of two
        (INVALID rows) and the width to a multiple of 8 (INVALID columns,
        which no valid window touches) for the 2-bit wire format."""
        n, width = codes.shape
        rows = 8
        while rows < n:
            rows *= 2
        w8 = -(-width // 8) * 8
        if (rows, w8) != (n, width):
            padded = np.full((rows, w8), encode.INVALID, np.uint8)
            padded[:n, :width] = codes
            codes = padded
        ambig = _ambig_array(codes, splits, row_lens, self.index.params.k, n)
        packed, valid = encode.pack_2bit(codes)
        bundle, window_taxa = classify_batch(
            to_device(packed, self.device), to_device(valid, self.device),
            to_device(ambig, self.device),
            self._keys, self._taxa, self._fence, self._table, self._req_lut(w8),
            self.index.params.minimizer_params, self.max_taxa,
        )
        if self._cuda:
            host = torch.empty(bundle.shape, dtype=bundle.dtype, pin_memory=True)
            host.copy_(bundle, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = bundle, None
        return titles, host, done, window_taxa

    def _harvest(self, dispatched) -> _Batch:
        titles, host, done, window_taxa = dispatched
        if done is not None:
            done.synchronize()
        n = len(titles)
        fb = host.numpy()[:n]
        rows = np.flatnonzero(fb[:, 2])
        ovf = {}
        if len(rows):
            wt = window_taxa[torch.from_numpy(rows).to(window_taxa.device)].cpu().numpy()
            ovf = dict(zip(rows.tolist(), wt))
        return _Batch(
            titles=titles,
            num_distinct=fb[:, 0],
            total_kmers=fb[:, 1].astype(np.int64),
            final_taxa={t: fb[:, 3 + i].astype(np.int64) for i, t in enumerate(self._thresholds)},
            overflow_window_taxa=ovf,
        )

    def packed_batches(self, packed_iter):
        """Run native.PackedReads chunks through the device pipeline.
        Same-width chunks coalesce into full batches across the stream, and
        up to PIPELINE_DEPTH batches are in flight while the host
        post-processes earlier ones."""
        packed_iter = prefetch_iterator(packed_iter, depth=2)
        pending = collections.deque()
        buffers: Dict[int, list] = {}  # width -> [(codes, titles, splits, lens)]

        def emit(width, force=False):
            rows_target = self._rows_target(width)
            buf = buffers.get(width, [])
            count = sum(len(x[1]) for x in buf)
            while count >= rows_target or (force and count > 0):
                take = min(count, rows_target)
                codes_parts, titles, splits, lens = [], [], [], []
                got = 0
                while got < take:
                    c, t, s, l = buf[0]
                    need = take - got
                    if len(t) <= need:
                        codes_parts.append(c)
                        titles += t
                        splits += s
                        lens += l
                        got += len(t)
                        buf.pop(0)
                    else:
                        codes_parts.append(c[:need])
                        titles += t[:need]
                        splits += s[:need]
                        lens += l[:need]
                        buf[0] = (c[need:], t[need:], s[need:], l[need:])
                        got = take
                count -= take
                codes = np.ascontiguousarray(
                    np.concatenate(codes_parts) if len(codes_parts) > 1 else codes_parts[0]
                )
                pending.append(self._dispatch(codes, titles, splits, lens))
                while len(pending) > PIPELINE_DEPTH:
                    yield self._harvest(pending.popleft())
            buffers[width] = buf

        for packed in packed_iter:
            width = packed.codes.shape[1]
            if getattr(packed, "splits", None) is not None:
                splits = [int(x) for x in packed.splits]
            else:
                splits = [None] * len(packed)
            buffers.setdefault(width, []).append(
                (packed.codes, list(packed.titles), splits, [int(x) for x in packed.lengths])
            )
            yield from emit(width)
        for width in list(buffers):
            yield from emit(width, force=True)
        while pending:
            yield self._harvest(pending.popleft())

    def _finalize_taxa(self, batch: _Batch, threshold: float, cpar: ClassifyParams):
        """(taxon, classified) per read for one threshold."""
        taxon = batch.final_taxa[threshold]
        if batch.overflow_window_taxa:
            taxon = taxon.copy()
            required = np.ceil(threshold * batch.total_kmers.astype(np.float64))
            parents = self.index.taxonomy.parents
            for i, row in batch.overflow_window_taxa.items():
                taxon[i] = _resolve_host(parents, _window_taxa_counts(row), required[i])
        classified = (taxon != NONE) & (batch.num_distinct >= cpar.min_hit_groups)
        return taxon, classified

    def classify_and_write_packed(self, packed_iter, output_location: str, cpar: ClassifyParams):
        """Classify native-packed reads and write one kreport per (threshold,
        sample) under <output_location>_c<threshold>/. Returns {threshold:
        [sample ids]}. Reports mode only: per (sample, taxon) counts
        aggregate as batches stream."""
        if cpar.per_read_output:
            raise NotImplementedError(PER_READ_LATER)
        self._thresholds = tuple(cpar.thresholds)
        counts: Dict[float, Dict[str, Dict[int, int]]] = {t: {} for t in cpar.thresholds}
        sre = re.compile(cpar.sample_regex) if cpar.sample_regex else None
        for batch in self.packed_batches(packed_iter):
            n = len(batch.titles)
            if sre is not None:
                samples = np.array(
                    [(m.group(1) if (m := sre.search(t)) else "other") for t in batch.titles]
                )
            else:
                samples = None
            for t in cpar.thresholds:
                taxon, classified = self._finalize_taxa(batch, t, cpar)
                report_taxon = np.where(classified, taxon, NONE)
                keep = classified if not cpar.with_unclassified else np.ones(n, bool)
                per_sample = counts[t]
                groups = (
                    [("all", keep)]
                    if samples is None
                    else [(str(s), keep & (samples == s)) for s in np.unique(samples[keep])]
                )
                for sample, sel in groups:
                    agg = per_sample.setdefault(sample, {})
                    vals, cts = np.unique(report_taxon[sel], return_counts=True)
                    for v, c in zip(vals.tolist(), cts.tolist()):
                        agg[v] = agg.get(v, 0) + c
        return self._write_reports(counts, output_location, cpar)

    def _write_reports(self, counts, output_location: str, cpar: ClassifyParams):
        out = {}
        for t, per_sample in counts.items():
            loc = output_location + "_c" + format_threshold(t, cpar.thresholds)
            os.makedirs(loc, exist_ok=True)
            names = []
            for sample, agg in per_sample.items():
                KrakenReport(self.index.taxonomy, sorted(agg.items())).write(
                    os.path.join(loc, f"{sample}_kreport.txt")
                )
                names.append(sample)
            out[t] = names
        return out
