"""Each read's final ordered hit runs on the device (counterpart of
slacken_tpu/ops/hitruns.py).

Per-read output needs, for each read, the ordered (taxon, k-mer count) runs
of TaxonCounts.fromHits (TaxonCounts.scala:31-48) with the ambiguity rule of
Supermers.scala:113-125: a valid window emits its taxon, a char-run of at
least k ambiguous bases emits (A, len - k + 1), shorter segments drop out,
equal neighbours merge across what dropped out, and a paired row splits the
list at the mate border. Reducing each row to its runs on the device sends
cap + cap/2 + 3 int32 a row to the host in place of the dense [B, L] window
taxa, and the host formats O(runs) a row.

For each window position p:
  - taxon t[p]       where the window is valid (window_taxa != INVALID_WINDOW),
  - ambiguous (-1)   where all k chars are invalid and the window lies
                     inside one mate (exactly len - k + 1 positions of each
                     ambiguous char-run),
  - a gap otherwise.
The runs are the run-length encoding of the non-gap positions, also broken
at the mate border.

`hit_runs` launches the hand-written kernel (kernels/hitruns.cu, through
cuda_kernels.hit_runs_cuda) for a CUDA tensor, and runs the plain twin
`hit_runs_plain` for a CPU tensor. Both take the validity bitmask of
encode.pack_2bit, which the scan already has on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .resolve import INVALID_WINDOW

__all__ = ["hit_runs", "hit_runs_plain", "decode", "DEFAULT_RUNS_PER_ROW", "bundle_width"]

#: runs a row budgeted in the bundle; a row with more is fetched densely
#: (rare: each N adds about two runs)
DEFAULT_RUNS_PER_ROW = 16

#: rows at least this wide are not reduced (a count must fit 16 bits)
MAX_ROW = 1 << 16

_I32_MIN = -(2**31)


def bundle_width(cap: int) -> int:
    """int32 columns of a row's bundle."""
    return cap + cap // 2 + 3


def unpack_valid(valid: torch.Tensor, L: int) -> torch.Tensor:
    """[B, L] bool char validity from pack_2bit's [B, L/8] little-endian bits."""
    v = valid.to(torch.int32)
    bits = torch.stack([(v >> j) & 1 for j in range(8)], dim=-1).reshape(valid.shape[0], -1)
    return bits[:, :L] == 1


def hit_runs_plain(window_taxa, valid, splits, row_lens, k: int, cap: int) -> torch.Tensor:
    """[B, cap + cap//2 + 3] int32 bundle of final hit runs a row, step for
    step the JAX package's hit_runs (cumsum, cummax, gathers, the one-hot
    over [B, L, cap]).

    window_taxa [B, L] int32 (INVALID_WINDOW at invalid windows); valid
    [B, L/8] uint8, pack_2bit's bitmask; splits [B] int32 (-1 single-end,
    else the mate-separator column); row_lens [B] int32 (content length).

    Layout a row:
      [:cap]               packed run values ((taxon+2) << 1 | mate; taxon -1
                           = ambiguous), INT32_MIN past nruns
      [cap : cap+cap//2]   run k-mer counts, uint16 pairs packed into int32
      [-3]                 nruns (> cap: overflow, the row is fetched densely)
      [-2], [-1]           per-mate k-mer totals (mate 2's is 0 single-end)
    """
    B, L = window_taxa.shape
    dev = window_taxa.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    splits = splits.to(torch.int32)[:, None]
    row_lens = row_lens.to(torch.int32)[:, None]
    paired = splits >= 0

    # fully invalid windows: no valid char among p..p+k-1
    inv = (~unpack_valid(valid, L)).to(torch.int32)
    cs = torch.cumsum(inv, dim=1, dtype=torch.int32)
    cs = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev), cs], dim=1)  # [B, L+1]
    hi = torch.clamp(pos + k, max=L).expand(B, L).long()
    n_inv = torch.gather(cs, 1, hi) - torch.gather(cs, 1, pos.expand(B, L).long())
    win_all_invalid = (n_inv == k) & (pos + k <= L)

    mate_id = (paired & (pos > splits)).to(torch.int32)
    m_start = torch.where(mate_id == 1, splits + 1, 0)
    m_end = torch.where(paired & (mate_id == 0), splits, row_lens)
    amb = win_all_invalid & (pos >= m_start) & (pos + k <= m_end)

    wv = window_taxa != INVALID_WINDOW
    v = torch.where(wv, window_taxa, -1).to(torch.int32)
    nongap = wv | amb

    # forward-fill the previous non-gap (value, mate) to find run starts
    tag = torch.where(nongap, pos, -1)
    idx_incl = torch.cummax(tag, dim=1).values
    idx_prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev), idx_incl[:, :-1]], dim=1)
    safe_prev = torch.clamp(idx_prev, min=0).long()
    lastv = torch.gather(v, 1, safe_prev)
    lastm = torch.gather(mate_id, 1, safe_prev)
    run_start = nongap & ((idx_prev < 0) | (lastv != v) | (lastm != mate_id))
    run_id = torch.cumsum(run_start.to(torch.int32), dim=1, dtype=torch.int32) - 1
    nruns = run_id[:, -1] + 1

    # ((v + 2) << 1) | mate in wrapping int32 arithmetic, as the JAX package's
    pv = (((v.long() + 2) << 1) | mate_id).to(torch.int32)
    onehot = (run_id[:, :, None] == torch.arange(cap, dtype=torch.int32, device=dev)) & nongap[:, :, None]
    values = torch.where(onehot, pv[:, :, None], _I32_MIN).amax(dim=1).to(torch.int32)
    counts = onehot.sum(dim=1, dtype=torch.int32)  # [B, cap]
    packed = (counts[:, 0::2].long() | (counts[:, 1::2].long() << 16)).to(torch.int32)
    t0 = (nongap & (mate_id == 0)).sum(dim=1, dtype=torch.int32)
    t1 = (nongap & (mate_id == 1)).sum(dim=1, dtype=torch.int32)
    return torch.cat([values, packed, nruns[:, None], t0[:, None], t1[:, None]], dim=1)


def hit_runs(window_taxa, valid, splits, row_lens, k: int, cap: int = DEFAULT_RUNS_PER_ROW) -> torch.Tensor:
    """The hit-runs bundle (hit_runs_plain's layout) of rows narrower than
    MAX_ROW: the CUDA kernel on a CUDA tensor, the plain twin on a CPU one."""
    if window_taxa.shape[1] >= MAX_ROW:
        raise ValueError(f"hit runs take rows narrower than {MAX_ROW}, got {window_taxa.shape[1]}")
    if window_taxa.device.type == "cpu":
        return hit_runs_plain(window_taxa, valid, splits, row_lens, k, cap)
    from . import cuda_kernels

    return cuda_kernels.hit_runs_cuda(window_taxa, valid, splits, row_lens, k, cap)


def decode(bundle: np.ndarray, cap: int):
    """Host view of a hit-runs bundle: (values [B, cap] packed, counts
    [B, cap] int64, nruns [B], totals [B, 2], overflow rows)."""
    values = bundle[:, :cap]
    packed = bundle[:, cap : cap + cap // 2].view(np.uint32)
    counts = np.empty((bundle.shape[0], cap), np.int64)
    counts[:, 0::2] = packed & 0xFFFF
    counts[:, 1::2] = packed >> 16
    nruns = bundle[:, -3]
    totals = bundle[:, -2:]
    return values, counts, nruns, totals, np.flatnonzero(nruns > cap)
