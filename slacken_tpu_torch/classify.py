"""Read classification (counterpart of slacken_tpu/classify.py).

Per batch of packed reads, on the device:

  1. minimizer scan over the 2-bit wire format (a CUDA scan kernel: the
     XOR-ordered one, its rank-table instance for an index with an explicit
     ordering, or the wide one for m > 31; the unpack is fused into it),
  2. a probe of every window position (the CUDA directory probe kernel, or
     its wide counterpart over two-limb keys; with `probe="tiled"`,
     `"hashed1"`, `"hashed"` or `"hashed128"` the kernel of that table,
     kernels/probe_tables.cu; with `"bucketed"` the directory kernel over
     the bucketed router),
  3. window taxa (INVALID_WINDOW where the window is invalid) and the
     distinct hit-group count per read,
  4. hit compaction and batched resolveTree,
  5. per-threshold finalisation against a host-computed table of
     ceil_f64(threshold * total), giving one [B, 3 + nthr] int32 bundle.
     Reports mode copies back only this bundle; per-read mode also copies
     the dense [B, L] int32 window taxa into a reused pinned buffer, or,
     under STPU_HIT_RUNS, each row's final hit runs (ops/hitruns.py, a CUDA
     kernel); rows over the run cap are then fetched densely, by row.

The host packs batches, keeps up to PIPELINE_DEPTH batches in flight
(launches are asynchronous until the host reads a bundle), resolves the rare
rows with more than `max_taxa` distinct taxa exactly on the host, applies the
min-hit-groups gate, aggregates per-sample Kraken reports and, in per-read
mode, formats one Kraken output line per read (natively when the C++ library
is available). On a CPU device the same code runs the kernels' plain PyTorch
twins.

Paired-end reads are packed as R1 + one INVALID separator + R2 in a single
row: no k-mer window crosses the separator, the distinct-minimizer chain runs
through it, and the host splits the ordered hit list at the border for
output (the |:| marker).
"""

from __future__ import annotations

import collections
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native, to_device
from .index import KeyValueIndex
from .ops import encode, hitruns
from .ops.lookup import probe
from .ops.minimizers import window_minimizers_packed
from .ops.resolve import INVALID_WINDOW, ResolveResult, compact_hits, resolve_hits
from .report import KrakenReport
from .taxonomy import NONE, Taxonomy
from .utils import count, prefetch_iterator, span
from .zio import ParallelGzipWriter

#: batches launched ahead of the one the host post-processes
PIPELINE_DEPTH = 3

AMBIGUOUS_SPAN = -1

#: the probes of the JAX package's --probe: the directory walk (routed), the
#: tiled table, the row-bucket table (hashed1), the displacement-bounded
#: hashed table in its two layouts (hashed, hashed128) and the direct-bucket
#: arrays (bucketed); the last three take narrow keys only
PROBES = ("routed", "tiled", "hashed1", "hashed", "hashed128", "bucketed")
#: the probes of a wide index
WIDE_PROBES = ("routed", "tiled", "hashed1")


def probe_choice(probe: Optional[str], wide: bool) -> str:
    """The probe a classifier runs: `probe`, or without one STPU_PROBE, or
    "routed"; checked as the JAX package's Classifier checks it. A wide
    index takes routed, tiled or hashed1 (the other probes raise
    NotImplementedError, never another probe in their place), and an
    unknown name raises ValueError. Every probe gives the same answers.
    The JAX package probes `bucketed` through span compaction (one query a
    span) and the others densely; the port probes every window densely:
    each window of a span probes the same key and invalid positions are
    masked, so the files are the same."""
    if probe is None:
        probe = os.environ.get("STPU_PROBE", "routed")
    if wide and probe not in WIDE_PROBES:
        raise NotImplementedError("wide (m > 31) indexes support the routed, tiled and hashed1 probes")
    if probe not in PROBES:
        raise ValueError(f"unknown probe mode {probe!r}")
    return probe


class Fragment(NamedTuple):
    """An input read (or read pair) to classify."""

    title: str
    seq: str
    seq2: Optional[str] = None


@dataclass
class ClassifyParams:
    """Classification parameters (as slacken_tpu.classify.ClassifyParams)."""

    min_hit_groups: int = 2
    with_unclassified: bool = True
    thresholds: Sequence[float] = (0.0,)
    sample_regex: Optional[str] = None
    per_read_output: bool = True


@dataclass
class ClassifiedRead:
    sample_id: str
    classified: bool
    title: str
    taxon: int
    length_string: str
    hit_details: str

    @property
    def classify_flag(self) -> str:
        return "C" if self.classified else "U"

    def output_line(self) -> str:
        return f"{self.classify_flag}\t{self.title}\t{self.taxon}\t{self.length_string}\t{self.hit_details}"


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


def scan_probe(packed, valid, keys, taxa, directory, mp, lut=None):
    """The first half of a batch on one device: the minimizer scan and the
    probe of every window position. Returns (WindowMinimizers, looked-up
    taxon [B, L] int32, 0 on a miss)."""
    wm = window_minimizers_packed(packed, valid, mp, lut)
    b, l = wm.valid.shape
    return wm, probe(keys, taxa, directory, wm.minimizer.flatten(0, 1)).reshape(b, l)


def postprocess(wm, looked, ambig, table, req_lut, max_taxa):
    """The second half: window taxa, hit groups, compaction, resolveTree and
    the per-threshold finalize. Returns (bundle [B, 3+nthr], window taxa [B, L])."""
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


def classify_batch(packed, valid, ambig, keys, taxa, directory, table, req_lut, mp, max_taxa,
                   lut=None):
    """The device body for one batch: (bundle [B, 3+nthr], window taxa [B, L]).
    `lut` is the index's rank table on the device (explicit orderings); in a
    wide index `keys` and the minimizers are rows of two limbs. `directory`
    is what KeyValueIndex.device_arrays gives for the probe: a directory, or
    a slot, tiled or row-bucket table (keys and taxa None)."""
    wm, looked = scan_probe(packed, valid, keys, taxa, directory, mp, lut)
    return postprocess(wm, looked, ambig, table, req_lut, max_taxa)


# ---------------------------------------------------------------------------
# Host helpers (as slacken_tpu/classify.py's)
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


def mate_hits(codes: np.ndarray, window_taxa: np.ndarray, a: int, b: int, k: int):
    """Ordered (taxon, kmer-count) hit pairs for one mate occupying row
    columns [a, b), merging adjacent equal taxa. Ambiguous char-runs >= k
    become (-1, len-k+1) pseudo-hits; shorter ambiguous/valid runs are
    dropped."""
    hits: List[List[int]] = []

    def add(taxon, count):
        if hits and hits[-1][0] == taxon:
            hits[-1][1] += count
        else:
            hits.append([taxon, count])

    for i, j, is_valid in _char_runs(codes[a:b] < 4):
        runlen = j - i
        if runlen < k:
            continue
        if is_valid:
            for w in range(a + i, a + j - k + 1):
                add(int(window_taxa[w]), 1)
        else:
            add(AMBIGUOUS_SPAN, runlen - k + 1)
    return hits


def hits_to_strings(hits_parts: List[List[List[int]]], k: int) -> Tuple[str, str]:
    """(hit_details, length_string) from per-mate ordered hit lists."""
    pieces = []
    lengths = []
    for part in hits_parts:
        for taxon, count in part:
            pieces.append(("A" if taxon == AMBIGUOUS_SPAN else str(taxon)) + f":{count}")
        lengths.append(sum(c for _, c in part) + (k - 1))
        pieces.append("|:|")
    pieces.pop()  # drop trailing border
    return " ".join(pieces), "|".join(str(x) for x in lengths)


def _row_hit_parts(codes_row, window_taxa_row, split, row_len, k):
    if split is None:
        return [mate_hits(codes_row, window_taxa_row, 0, row_len, k)]
    return [
        mate_hits(codes_row, window_taxa_row, 0, split, k),
        mate_hits(codes_row, window_taxa_row, split + 1, row_len, k),
    ]


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


def write_per_sample_output(
    reads: List[ClassifiedRead], location: str, cpar: ClassifyParams, taxonomy: Taxonomy, part: int = 0
) -> List[str]:
    """Write gzip per-read outputs partitioned by sample and a kreport per
    sample (<loc>/sample=<id>/part-<part:05d>.txt.gz and <loc>/<id>_kreport.txt)."""
    os.makedirs(location, exist_ok=True)
    by_sample: Dict[str, List[ClassifiedRead]] = {}
    for r in reads:
        if cpar.with_unclassified or r.classified:
            by_sample.setdefault(r.sample_id, []).append(r)
    for sample, rs in by_sample.items():
        if cpar.per_read_output:
            d = os.path.join(location, f"sample={sample}")
            os.makedirs(d, exist_ok=True)
            with ParallelGzipWriter(os.path.join(d, f"part-{part:05d}.txt.gz"), level=1) as f:
                chunk = 1 << 14
                for i in range(0, len(rs), chunk):
                    f.write("\n".join(r.output_line() for r in rs[i : i + chunk]) + "\n")
        counts: Dict[int, int] = {}
        for r in rs:
            counts[r.taxon] = counts.get(r.taxon, 0) + 1
        KrakenReport(taxonomy, sorted(counts.items())).write(
            os.path.join(location, f"{sample}_kreport.txt")
        )
    return list(by_sample)


def _row_length_bucket(n: int) -> int:
    b = 128
    while b < n:
        b *= 2
    return b


def _samples_of(titles: List[str], sre) -> Optional[np.ndarray]:
    """Sample id per title through the compiled regex (None without one)."""
    if sre is None:
        return None
    return np.array([(m.group(1) if (m := sre.search(t)) else "other") for t in titles])


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------


@dataclass
class _Batch:
    """One harvested batch. In per-read mode it carries either the dense
    `window_taxa` (possibly a view of a reused pinned buffer: valid until the
    next batch is requested) or, under the hit-runs reduction, `hit_runs`
    (hitruns.decode's values, counts, nruns, totals and overflow rows) with
    the overflow rows' window taxa in `run_rows`."""

    titles: List[str]
    num_distinct: np.ndarray
    total_kmers: np.ndarray
    final_taxa: Dict[float, np.ndarray]
    #: {row: window taxa row} for the rows that overflowed max_taxa
    overflow_window_taxa: Dict[int, np.ndarray]
    codes: np.ndarray  # [n, L] uint8, L padded to a multiple of 8
    mate_split: List[Optional[int]]  # R1 length per row if paired
    row_lens: List[int]  # true row content length (trailing Ns are content)
    window_taxa: Optional[np.ndarray] = None  # host [n, L] int32
    pinned: Optional[torch.Tensor] = None  # the buffer behind window_taxa or hit_runs
    hit_pairs: Optional[list] = None  # memoised (hit_details, length_string)
    hit_runs: Optional[tuple] = None
    run_rows: Optional[Dict[int, np.ndarray]] = None


class Classifier:
    """Classify reads against a KeyValueIndex on `device`, through the probe
    `probe` (probe_choice: routed, tiled, hashed1, hashed, hashed128 or
    bucketed; the answers are the same, the tables and kernels differ)."""

    def __init__(
        self,
        index: KeyValueIndex,
        device,
        max_taxa_per_read: int = 32,
        probe: Optional[str] = None,
    ):
        self.device = torch.device(device)
        self.index = index
        self.max_taxa = max_taxa_per_read
        self.probe = probe_choice(probe, index.wide)
        self._cuda = self.device.type == "cuda"
        # 4 Mbp batches on the card, 1 Mbp on the CPU (cache residency)
        self.target_batch_bp = (1 << 22) if self._cuda else (1 << 20)
        self._place_index()
        self._req_luts: Dict[tuple, torch.Tensor] = {}
        self._thresholds: tuple = (0.0,)
        #: set per call by the entry points: the window taxa reach the host
        #: only when per-read lines are produced
        self._fetch_window_taxa = False
        #: per-read mode copies each row's final hit runs (ops/hitruns.py)
        #: in place of its dense window taxa when STPU_HIT_RUNS is 1. The
        #: default, as in the JAX package, is on only on a CPU device without
        #: the native formatter, where formatting O(runs) in Python beats the
        #: dense walk.
        hr_default = "1" if not self._cuda and not native.available() else "0"
        self._hit_runs = os.environ.get("STPU_HIT_RUNS", hr_default) == "1"
        #: free pinned int32 buffers per shape for the window taxa or their
        #: hit runs. A buffer is taken at dispatch and comes back once its
        #: batch has been consumed, so at most PIPELINE_DEPTH + 1 exist per
        #: shape.
        self._pinned_free: Dict[tuple, List[torch.Tensor]] = {}
        #: the number in the per-read part files' names (one a process)
        self._part_index = 0

    def _place_index(self) -> None:
        """Put what a batch reads on the device, once: the index's probe
        arrays, its rank table and the taxonomy's rpath table."""
        self._keys, self._taxa, self._directory = self.index.device_arrays(self.device, self.probe)
        self._lut = self.index.device_lut(self.device)
        # indexed by raw taxon ID: [max_id + 1, D], copied to the device once
        self._table = torch.from_numpy(self.index.taxonomy.rpath_table()).to(self.device)

    def _rows_target(self, width: int) -> int:
        return max(8, self.target_batch_bp // width)

    def _padded_rows(self, n: int) -> int:
        """Rows a batch of n reads pads to: a power of two, at least 8."""
        rows = 8
        while rows < n:
            rows *= 2
        return rows

    def _req_lut(self, tmax: int, device=None) -> torch.Tensor:
        """[nthr, tmax+1] int32 ceil_f64(t * total) for every possible total,
        on `device` (default the classifier's)."""
        device = self.device if device is None else torch.device(device)
        key = (self._thresholds, tmax, device)
        if key not in self._req_luts:
            totals = np.arange(tmax + 1, dtype=np.float64)
            lut = np.stack([np.ceil(t * totals) for t in self._thresholds]).astype(np.int32)
            self._req_luts[key] = torch.from_numpy(lut).to(device)
        return self._req_luts[key]

    def scan_probe(self, packed: np.ndarray, valid: np.ndarray):
        """The scan and the probe of pack_2bit's arrays on the device:
        [(WindowMinimizers, looked-up taxa)], one pair a device, in row order."""
        return [scan_probe(to_device(packed, self.device), to_device(valid, self.device),
                           self._keys, self._taxa, self._directory,
                           self.index.params.minimizer_params, self._lut)]

    def _classify_packed_rows(self, packed, valid, ambig, tmax: int, valid_dev=None):
        """(bundle, window taxa) of one batch of pack_2bit's arrays.
        `valid_dev`: the validity bits already on the device, if they are."""
        return classify_batch(
            to_device(packed, self.device), to_device(valid, self.device) if valid_dev is None else valid_dev,
            to_device(ambig, self.device), self._keys, self._taxa, self._directory, self._table,
            self._req_lut(tmax), self.index.params.minimizer_params, self.max_taxa, self._lut,
        )

    def _fetch_runs(self, width: int) -> bool:
        """Whether per-read mode copies hit runs in place of the dense window
        taxa for rows of `width` (never for rows of 2^16 or more)."""
        return self._fetch_window_taxa and self._hit_runs and width < hitruns.MAX_ROW

    def _dispatch(self, codes: np.ndarray, titles, splits, row_lens):
        """Launch one batch; pair with _harvest. Rows pad to `_padded_rows`
        (INVALID rows) and the width to a multiple of 8 (INVALID columns,
        which no valid window touches) for the 2-bit wire format. In per-read
        mode the window taxa, or their hit runs (rows under 2^16 wide), go to
        the host with the bundle; the device window taxa stay until the
        harvest, which fetches the rows over the run cap. A `dispatch` span
        counts the rows launched and the padding rows among them; its
        `dispatch.launch` the bytes queued for copy to the device and back."""
        with span("dispatch"):
            n, width = codes.shape
            rows = self._padded_rows(n)
            w8 = -(-width // 8) * 8
            count("rows", rows)
            count("padded_rows", rows - n)
            with span("dispatch.pad"):
                if (rows, w8) != (n, width):
                    padded = np.full((rows, w8), encode.INVALID, np.uint8)
                    padded[:n, :width] = codes
                    codes = padded
            k = self.index.params.k
            with span("dispatch.ambig"):
                ambig = _ambig_array(codes, splits, row_lens, k, n)
            with span("dispatch.pack"):
                packed, valid = encode.pack_2bit(codes)
            with span("dispatch.launch"):
                h2d = packed.nbytes + valid.nbytes + ambig.nbytes
                runs = self._fetch_runs(w8)
                valid_dev = to_device(valid, self.device) if runs else None
                bundle, window_taxa = self._classify_packed_rows(packed, valid, ambig, w8, valid_dev)
                if runs:
                    split_arr = np.full(rows, -1, np.int32)
                    split_arr[:n] = [-1 if s is None else s for s in splits]
                    len_arr = np.zeros(rows, np.int32)
                    len_arr[:n] = row_lens
                    h2d += split_arr.nbytes + len_arr.nbytes
                    fetched = hitruns.hit_runs(window_taxa, valid_dev, to_device(split_arr, self.device),
                                               to_device(len_arr, self.device), k, hitruns.DEFAULT_RUNS_PER_ROW)
                else:
                    fetched = window_taxa if self._fetch_window_taxa else None
                d2h = bundle.numel() * bundle.element_size()
                if fetched is not None:
                    d2h += fetched[:n].numel() * fetched.element_size()
                pinned = None
                if self._cuda:
                    host = torch.empty(bundle.shape, dtype=bundle.dtype, pin_memory=True)
                    host.copy_(bundle, non_blocking=True)
                    if fetched is not None:
                        free = self._pinned_free.setdefault(tuple(fetched.shape), [])
                        pinned = free.pop() if free else torch.empty(fetched.shape, dtype=torch.int32, pin_memory=True)
                        pinned[:n].copy_(fetched[:n], non_blocking=True)
                        fetched = pinned
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                else:
                    host, done = bundle, None
                count("h2d_bytes", h2d)
                count("d2h_bytes", d2h)
            return titles, host, done, window_taxa, runs, fetched, pinned, codes[:n], splits, row_lens

    def _harvest(self, dispatched) -> _Batch:
        """The host's side of a dispatched batch, as a `harvest` span: the
        wait for its copies (`harvest.wait`), then the synchronous fetch of
        the rows over max_taxa or the run cap (`harvest.overflow`)."""
        titles, host, done, window_taxa, runs, fetched, pinned, codes, splits, row_lens = dispatched
        with span("harvest"):
            with span("harvest.wait"):
                if done is not None:
                    done.synchronize()
            n = len(titles)
            fb = host.numpy()[:n]
            rows = np.flatnonzero(fb[:, 2])  # over max_taxa: resolved on the host
            wt_host = None if fetched is None else fetched.numpy()[:n]
            hit_runs = None
            if runs:
                hit_runs = hitruns.decode(wt_host, hitruns.DEFAULT_RUNS_PER_ROW)
                wt_host = None
                fetch = np.union1d(hit_runs[4], rows)  # over the run cap or max_taxa
            else:
                fetch = rows if wt_host is None else rows[:0]
            dense = {}
            if len(fetch):
                with span("harvest.overflow"):
                    got = window_taxa[torch.from_numpy(fetch).to(window_taxa.device)].cpu().numpy()
                count("d2h_bytes", got.nbytes)
                dense = dict(zip(fetch.tolist(), got))
            ovf = {r: (dense[r] if wt_host is None else wt_host[r]) for r in rows.tolist()}
        return _Batch(
            titles=titles,
            num_distinct=fb[:, 0],
            total_kmers=fb[:, 1].astype(np.int64),
            final_taxa={t: fb[:, 3 + i].astype(np.int64) for i, t in enumerate(self._thresholds)},
            overflow_window_taxa=ovf,
            codes=codes,
            mate_split=splits,
            row_lens=row_lens,
            window_taxa=wt_host,
            pinned=pinned,
            hit_runs=hit_runs,
            run_rows=dense if runs else None,
        )

    def _drain(self, pending, keep: int):
        """Harvest and yield the oldest batches until `keep` stay in flight;
        a batch's pinned buffer is free again once the consumer asks for the
        next batch."""
        while len(pending) > keep:
            batch = self._harvest(pending.popleft())
            count("reads", len(batch.titles))
            yield batch
            if batch.pinned is not None:
                self._pinned_free[tuple(batch.pinned.shape)].append(batch.pinned)

    def packed_batches(self, packed_iter):
        """Run native.PackedReads chunks through the device pipeline.
        Same-width chunks coalesce into full batches across the stream, and
        up to PIPELINE_DEPTH batches are in flight while the host
        post-processes earlier ones."""
        packed_iter = prefetch_iterator(packed_iter, depth=2)
        try:
            yield from self._batches(packed_iter)
        finally:
            packed_iter.close()

    def _batches(self, packed_iter):
        """packed_batches' pipeline over the prefetched chunks; taking in a
        chunk and joining parts into a batch are `batch.assemble` spans."""
        pending = collections.deque()
        buffers: Dict[int, list] = {}  # width -> [(codes, titles, splits, lens)]

        def emit(width, force=False):
            rows_target = self._rows_target(width)
            buf = buffers.get(width, [])
            queued = sum(len(x[1]) for x in buf)
            while queued >= rows_target or (force and queued > 0):
                with span("batch.assemble"):
                    take = min(queued, rows_target)
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
                    queued -= take
                    codes = np.ascontiguousarray(
                        np.concatenate(codes_parts) if len(codes_parts) > 1 else codes_parts[0]
                    )
                pending.append(self._dispatch(codes, titles, splits, lens))
                yield from self._drain(pending, PIPELINE_DEPTH)
            buffers[width] = buf

        for packed in packed_iter:
            with span("batch.assemble"):
                width = packed.codes.shape[1]
                if getattr(packed, "splits", None) is not None:
                    # a negative split marks a single read among paired rows
                    splits = [int(x) if x >= 0 else None for x in packed.splits]
                else:
                    splits = [None] * len(packed)
                buffers.setdefault(width, []).append(
                    (packed.codes, list(packed.titles), splits, [int(x) for x in packed.lengths])
                )
            yield from emit(width)
        for width in list(buffers):
            yield from emit(width, force=True)
        yield from self._drain(pending, 0)

    # -- per-threshold finalisation -----------------------------------------

    def _finalize_taxa(self, batch: _Batch, threshold: float, cpar: ClassifyParams):
        """(taxon, classified) per read for one threshold, as an
        `output.finalize` span counting the rows resolved on the host."""
        with span("output.finalize"):
            taxon = batch.final_taxa[threshold]
            if batch.overflow_window_taxa:
                taxon = taxon.copy()
                required = np.ceil(threshold * batch.total_kmers.astype(np.float64))
                parents = self.index.taxonomy.parents
                for i, row in batch.overflow_window_taxa.items():
                    taxon[i] = _resolve_host(parents, _window_taxa_counts(row), required[i])
                count("host_resolved_rows", len(batch.overflow_window_taxa))
            classified = (taxon != NONE) & (batch.num_distinct >= cpar.min_hit_groups)
        return taxon, classified

    def _hit_pairs(self, batch: _Batch):
        """(hit_details, length_string) per read, memoised on the batch: it
        is the same for every threshold."""
        if batch.hit_pairs is None:
            k = self.index.params.k
            splits = np.array([-1 if s is None else s for s in batch.mate_split], np.int64)
            if batch.hit_runs is not None:
                pairs = self._pairs_from_runs(batch, splits, k)
            else:
                pairs = native.hit_lines(batch.codes, batch.window_taxa, splits, batch.row_lens, k)
                if pairs is None:
                    pairs = [
                        hits_to_strings(
                            _row_hit_parts(batch.codes[i], batch.window_taxa[i],
                                           batch.mate_split[i], batch.row_lens[i], k), k)
                        for i in range(len(batch.titles))
                    ]
            batch.hit_pairs = pairs
        return batch.hit_pairs

    def _pairs_from_runs(self, batch: _Batch, splits: np.ndarray, k: int):
        """(details, length) pairs from the hit runs (in C++, else in
        Python); a row over the run cap from its dense window taxa."""
        values, counts, nruns, totals, overflow_rows = batch.hit_runs
        cap = values.shape[1]
        pairs = native.hit_lines_runs(values, counts, np.minimum(nruns, cap), totals, splits, k)
        if pairs is None:
            pairs = []
            for i in range(len(batch.titles)):
                parts = [[]] if batch.mate_split[i] is None else [[], []]
                for j in range(min(int(nruns[i]), cap)):
                    pv = int(values[i, j])
                    taxon = (pv >> 1) - 2
                    parts[pv & 1].append([AMBIGUOUS_SPAN if taxon == -1 else taxon, int(counts[i, j])])
                pairs.append(hits_to_strings(parts, k))
        for i in overflow_rows.tolist():
            parts = _row_hit_parts(batch.codes[i], batch.run_rows[i], batch.mate_split[i], batch.row_lens[i], k)
            pairs[i] = hits_to_strings(parts, k)
        return pairs

    def finalize(self, batch: _Batch, threshold: float, cpar: ClassifyParams) -> List[ClassifiedRead]:
        """Apply one confidence threshold to a batch's device results."""
        n = len(batch.titles)
        taxon, classified = self._finalize_taxa(batch, threshold, cpar)
        report_taxon = np.where(classified, taxon, NONE)
        sre = re.compile(cpar.sample_regex) if cpar.sample_regex else None
        samples = _samples_of(batch.titles, sre)
        pairs = self._hit_pairs(batch) if cpar.per_read_output else [("", "")] * n
        return [
            ClassifiedRead(
                "all" if samples is None else str(samples[i]), bool(classified[i]),
                batch.titles[i], int(report_taxon[i]), pairs[i][1], pairs[i][0],
            )
            for i in range(n)
        ]

    # -- high level ----------------------------------------------------------

    def _begin(self, cpar: ClassifyParams) -> None:
        self._thresholds = tuple(cpar.thresholds)
        self._fetch_window_taxa = bool(cpar.per_read_output)

    def _pack_rows(self, frags: List[Fragment], bucket: int) -> native.PackedReads:
        rows, splits = [], []
        for f in frags:
            c1 = encode.encode_seq(f.seq)
            if f.seq2 is not None:
                rows.append(np.concatenate(
                    [c1, np.array([encode.INVALID], np.uint8), encode.encode_seq(f.seq2)]))
                splits.append(len(c1))
            else:
                rows.append(c1)
                splits.append(-1)
        codes, lens = encode.pack_batch(rows, bucket)
        return native.PackedReads(codes, lens, [f.title for f in frags], np.array(splits, np.int64))

    def classify(
        self, fragments: Iterable[Fragment], cpar: ClassifyParams
    ) -> Dict[float, List[ClassifiedRead]]:
        """Classify all fragments at every threshold in one device pass.
        Fragments are packed into rows by length bucket and go down the
        packed_batches pipeline; results come back in input order."""
        self._begin(cpar)
        #: input positions per row width, in the order the rows were packed:
        #: packed_batches keeps that order within a width
        order: Dict[int, collections.deque] = {}

        def chunks():
            pending: Dict[int, list] = {}

            def pack(bucket):
                lst = pending.pop(bucket)
                order.setdefault(bucket, collections.deque()).extend(p for p, _ in lst)
                return self._pack_rows([f for _, f in lst], bucket)

            for pos, f in enumerate(fragments):
                n = len(f.seq) + (len(f.seq2) + 1 if f.seq2 is not None else 0)
                bucket = _row_length_bucket(n)
                pending.setdefault(bucket, []).append((pos, f))
                if len(pending[bucket]) >= self._rows_target(bucket):
                    yield pack(bucket)
            for bucket in list(pending):
                yield pack(bucket)

        acc: Dict[float, list] = {t: [] for t in cpar.thresholds}
        with span("classify.request", request=True):
            for batch in self.packed_batches(chunks()):
                queue = order[batch.codes.shape[1]]
                positions = [queue.popleft() for _ in batch.titles]
                for t in cpar.thresholds:
                    acc[t].extend(zip(positions, self.finalize(batch, t, cpar)))
        return {
            t: [read for _, read in sorted(pairs, key=lambda x: x[0])]
            for t, pairs in acc.items()
        }

    def classify_packed(self, packed_iter, cpar: ClassifyParams) -> Dict[float, List[ClassifiedRead]]:
        """Classify native.PackedReads chunks at every threshold in one
        device pass; reads come back in stream order within a row width."""
        self._begin(cpar)
        results: Dict[float, List[ClassifiedRead]] = {t: [] for t in cpar.thresholds}
        with span("classify.request", request=True):
            for batch in self.packed_batches(packed_iter):
                for t in cpar.thresholds:
                    results[t].extend(self.finalize(batch, t, cpar))
        return results

    def classify_and_write(
        self, fragments: Iterable[Fragment], output_location: str, cpar: ClassifyParams
    ) -> Dict[float, List[str]]:
        """Classify and write per-sample outputs + kreports per threshold.
        Returns {threshold: [sample ids]}."""
        out = {}
        for t, reads in self.classify(fragments, cpar).items():
            loc = output_location + "_c" + format_threshold(t, cpar.thresholds)
            out[t] = write_per_sample_output(reads, loc, cpar, self.index.taxonomy, self._part_index)
        return out

    def classify_and_write_packed(self, packed_iter, output_location: str, cpar: ClassifyParams):
        """Classify native-packed reads and write, under
        <output_location>_c<threshold>/, one kreport per sample and, in
        per-read mode, sample=<sample>/part-<_part_index:05d>.txt.gz with one Kraken line
        per read. Returns {threshold: [sample ids]}. Everything streams: per
        (sample, taxon) counts aggregate, and lines are written, as batches
        arrive. The request is a `classify.request` span; under it the
        per-threshold tallies are `output.count`, the lines `lines.emit`,
        `lines.write` and `lines.close`, and the kreports `reports.write`."""
        with span("classify.request", request=True):
            self._begin(cpar)
            counts: Dict[float, Dict[str, Dict[int, int]]] = {t: {} for t in cpar.thresholds}
            sre = re.compile(cpar.sample_regex) if cpar.sample_regex else None
            writers: Dict[tuple, ParallelGzipWriter] = {}

            def writer_for(t, sample):
                if (t, sample) not in writers:
                    d = os.path.join(
                        output_location + "_c" + format_threshold(t, cpar.thresholds),
                        f"sample={sample}")
                    os.makedirs(d, exist_ok=True)
                    writers[(t, sample)] = ParallelGzipWriter(
                        os.path.join(d, f"part-{self._part_index:05d}.txt.gz"), level=1)
                return writers[(t, sample)]

            try:
                for batch in self.packed_batches(packed_iter):
                    n = len(batch.titles)
                    samples = _samples_of(batch.titles, sre)
                    lines = None
                    if cpar.per_read_output:
                        with span("lines.emit"):
                            lines = _LineFormatter(self, batch)
                    for t in cpar.thresholds:
                        taxon, classified = self._finalize_taxa(batch, t, cpar)
                        with span("output.count"):
                            rtax = np.where(classified, taxon, NONE)
                            keep = classified if not cpar.with_unclassified else np.ones(n, bool)
                            groups = (
                                [("all", np.flatnonzero(keep))]
                                if samples is None
                                else [(str(s), np.flatnonzero(keep & (samples == s)))
                                      for s in np.unique(samples[keep])]
                            )
                            groups = [(sample, idxs) for sample, idxs in groups if len(idxs)]
                            for sample, idxs in groups:
                                agg = counts[t].setdefault(sample, {})
                                vals, cts = np.unique(rtax[idxs], return_counts=True)
                                for v, c in zip(vals.tolist(), cts.tolist()):
                                    agg[v] = agg.get(v, 0) + c
                        if lines is not None:
                            with span("lines.emit"):
                                lines.emit(rtax, classified)
                            for sample, idxs in groups:
                                with span("lines.write"):
                                    lines.write(writer_for(t, sample), idxs)
            finally:
                with span("lines.close"):
                    for f in writers.values():
                        f.close()
            with span("reports.write"):
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


class _LineFormatter:
    """Per-read Kraken lines of one batch. Whole lines in C++ when the
    native library is available: from the hit runs (native.output_lines_runs)
    when the batch has them and no row overflowed their cap, from the dense
    window taxa (output_lines_dense) when it has no runs. Otherwise, or when
    a formatter gives nothing, Python formatting over the hit pairs, where a
    row over the run cap reads its own dense window taxa."""

    def __init__(self, classifier: Classifier, batch: _Batch):
        self.classifier = classifier
        self.batch = batch
        self.emitted = None
        self.native = native.available() and (batch.hit_runs is None or len(batch.hit_runs[4]) == 0)
        if self.native:
            tb = [s.encode("utf-8") for s in batch.titles]
            self.title_offs = np.zeros(len(tb) + 1, np.int64)
            np.cumsum([len(s) for s in tb], out=self.title_offs[1:])
            self.blob = b"".join(tb)
            self.max_title = max((len(s) for s in tb), default=0)
            self.splits = np.array([-1 if s is None else s for s in batch.mate_split], np.int64)
            self.row_lens = np.asarray(batch.row_lens, np.int64)

    def emit(self, rtax: np.ndarray, classified: np.ndarray) -> None:
        """Format every row for one threshold's (report taxon, classified)."""
        self.rtax, self.classified = rtax, classified
        if not self.native:
            return
        b, k = self.batch, self.classifier.index.params.k
        if b.hit_runs is not None:
            values, counts, nruns, totals, _ = b.hit_runs
            self.emitted = native.output_lines_runs(
                values, counts, nruns, totals, self.splits, self.blob, self.title_offs, rtax,
                classified.astype(np.uint8), k, self.max_title,
            )
        else:
            self.emitted = native.output_lines_dense(
                b.codes, b.window_taxa, self.splits, self.row_lens, self.blob,
                self.title_offs, rtax, classified.astype(np.uint8), k, self.max_title,
            )

    def write(self, writer: ParallelGzipWriter, idxs: np.ndarray) -> None:
        """Write the lines of rows `idxs` (non-empty) to `writer`."""
        if self.emitted is not None:
            writer.write_bytes(native.gather_rows(*self.emitted, idxs))
            return
        titles = self.batch.titles
        pairs = self.classifier._hit_pairs(self.batch)
        lines = [
            f"{'C' if self.classified[i] else 'U'}\t{titles[i]}\t{self.rtax[i]}\t{pairs[i][1]}\t{pairs[i][0]}"
            for i in idxs
        ]
        writer.write("\n".join(lines) + "\n")
