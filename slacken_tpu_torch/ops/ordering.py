"""Explicit minimizer orderings through rank tables (counterpart of
slacken_tpu/ops/ordering.py).

Instead of the XOR formula, the priority of an m-mer is a rank read from a
dense table of 4^m entries: one gather per position in the scan (the
rank-table instance of the CUDA scan kernel on the card). Spacing composes
as in the reference: the canonical m-mer is masked first, then ranked, so
only masked motifs' entries are read.

Orderings:

  * lexicographic  rank(x) = x
  * given          an explicit motif list in priority order
  * frequency      rarest first by sampled counts, ties lexicographic
  * signature      the KMC 2 signature filter: candidates before the rest

The table functions are numpy and return uint32, the dtype of
`ordering_lut.npy`; on a device the table lives as int32 (every rank is
below 4^15 = 2^30). Sizes: m = 12 is 64 MiB, m = 13 256 MiB, m = 14 1 GiB,
m = 15 (MAX_LUT_M, the reference's bound) 4 GiB, all of which fit an 80 GB
card beside an index; from m = 12 on the table exceeds the H100's 50 MB L2,
so a rank then costs a device-memory access. `sample_mmer_counts` keeps its
4^m int64 counts (8 bytes an entry: 8 GiB at m = 15) on the device, and
`frequency_lut` sorts them on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .minimizers import MinimizerParams, _mmers, _revcomps, sliding_all, space_mask_int

#: largest m for a dense rank table
MAX_LUT_M = 15


def _check_m(m: int) -> int:
    if not (1 <= m <= MAX_LUT_M):
        raise ValueError(f"explicit-ordering tables require 1 <= m <= {MAX_LUT_M}, got {m}")
    return 1 << (2 * m)


def lexicographic_lut(m: int) -> np.ndarray:
    """Rank = m-mer value."""
    return np.arange(_check_m(m), dtype=np.uint32)


def given_lut(motifs: np.ndarray, m: int) -> np.ndarray:
    """motifs[i] gets rank i; absent motifs rank last, in lexicographic order."""
    n = _check_m(m)
    motifs = np.asarray(motifs, dtype=np.int64)
    if motifs.size and (motifs.min() < 0 or motifs.max() >= n):
        raise ValueError("motif out of range for m")
    if np.unique(motifs).size != motifs.size:
        raise ValueError("duplicate motifs in priority list")
    last = np.iinfo(np.uint32).max
    lut = np.full(n, last, np.uint32)
    lut[motifs] = np.arange(motifs.size, dtype=np.uint32)
    absent = np.flatnonzero(lut == last)
    lut[absent] = np.arange(motifs.size, motifs.size + absent.size, dtype=np.uint32)
    return lut


def signature_lut(m: int) -> np.ndarray:
    """KMC 2's signature ordering (Deorowicz et al. 2015): an m-mer is a
    candidate iff it does not start with AAA or ACA and contains AA nowhere
    except at its very start. Candidates rank before the others; inside each
    class the order is lexicographic."""
    n = _check_m(m)
    vals = np.arange(n, dtype=np.uint32)
    allowed = np.ones(n, bool)
    if m >= 3:
        top3 = vals >> np.uint32(2 * (m - 3))
        allowed &= (top3 != 0b000000) & (top3 != 0b000100)  # AAA, ACA
    for i in range(1, m - 1):  # AA from any interior position
        allowed &= (vals >> np.uint32(2 * (m - 2 - i))) & np.uint32(0xF) != 0
    n_allowed = int(allowed.sum())
    return np.where(
        allowed,
        np.cumsum(allowed, dtype=np.int64) - 1,
        np.cumsum(~allowed, dtype=np.int64) - 1 + n_allowed,
    ).astype(np.uint32)


def frequency_lut(counts: np.ndarray, m: int) -> np.ndarray:
    """Rarest first from sampled m-mer counts: a lower count is a lower rank;
    ties break lexicographically (a stable sort)."""
    n = _check_m(m)
    counts = np.asarray(counts)
    if counts.shape != (n,):
        raise ValueError(f"counts must have shape ({n},), got {counts.shape}")
    order = np.argsort(counts, kind="stable")
    lut = np.empty(n, np.uint32)
    lut[order] = np.arange(n, dtype=np.uint32)
    return lut


def mmer_rank_ids(codes: torch.Tensor, params: MinimizerParams) -> torch.Tensor:
    """The spaced-masked canonical m-mer per start position of codes [B, L]
    (0..3, 4 = invalid), int64 on the codes' device; -1 where the m-mer runs
    into an invalid base or past the row's end."""
    m = params.m
    _check_m(m)
    codes = codes.to(torch.uint8)
    c = (codes & 3).to(torch.int64)
    mm = _mmers(c, m)
    if params.canonical:
        mm = torch.minimum(mm, _revcomps(c, m))
    return torch.where(sliding_all(codes < 4, m), mm & space_mask_int(m, params.spaces), -1)


def sample_mmer_counts(
    code_rows, params: MinimizerParams, device, row_len: int = 1 << 15, batch_rows: int = 64
) -> np.ndarray:
    """Occurrences of every spaced-masked canonical m-mer over the sample
    sequences (uint8 code arrays), counted on `device`; int64 [4^m] on the
    host, for `frequency_lut`. Rows longer than row_len are split with m - 1
    overlap, so no m-mer is lost or counted twice."""
    m = params.m
    n = _check_m(m)
    device = torch.device(device)
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    buf: list = []

    def flush():
        codes = np.full((len(buf), row_len), 4, np.uint8)
        for r, row in enumerate(buf):
            codes[r, : len(row)] = row
        ids = mmer_rank_ids(torch.from_numpy(codes).to(device), params).reshape(-1)
        counts.add_(torch.bincount(ids[ids >= 0], minlength=n))
        buf.clear()

    step = row_len - (m - 1)
    for row in code_rows:
        row = np.asarray(row, np.uint8)
        for off in range(0, max(len(row) - m + 1, 1), step):
            buf.append(row[off : off + row_len])
            if len(buf) >= batch_rows:
                flush()
    if buf:
        flush()
    return counts.cpu().numpy()
