"""Minimizer scan for narrow (m <= 31) XOR-ordered minimizers.

Same semantics as slacken_tpu.ops.minimizers (Kraken 2 compatible):

  priority(m-mer) = (canonical(m-mer) XOR toggle_mask) AND spaced_seed_mask

with the toggle mask truncated to 2m bits, the window minimizer the minimum
priority over the W = k - m + 1 m-mers of a k-mer window, and super-mer
spans starting where the window minimum changes or validity resumes.

Every value fits one int64 (2m <= 62 bits), so the plain version here works
on int64 tensors with no unsigned arithmetic: the reverse complement is
built by the same doubling as the forward m-mer, over complemented codes,
so bit 63 is never set. `window_minimizers` is the plain PyTorch twin of
the CUDA scan kernel; `window_minimizers_packed` is the entry point the
pipeline calls: it launches the kernel for CUDA tensors and runs the twin
only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .encode import unpack_2bit

#: Kraken 2's minimizer toggle mask (mmscanner.h)
DEFAULT_TOGGLE_MASK = 0xE37E28C4271B5A2D
INT64_MAX = (1 << 63) - 1


class MinimizerParams(NamedTuple):
    """Minimizer scheme parameters (fields as in slacken_tpu)."""

    k: int = 35
    m: int = 31
    spaces: int = 7
    toggle_mask: int = DEFAULT_TOGGLE_MASK
    canonical: bool = True

    @property
    def window(self) -> int:
        return self.k - self.m + 1

    @property
    def wide(self) -> bool:
        return self.m > 31

    def validate(self):
        if not (1 <= self.m <= 63):
            raise ValueError(f"m must be in [1, 63], got {self.m}")
        if self.k < self.m:
            raise ValueError(f"k ({self.k}) must be >= m ({self.m})")
        if self.spaces > self.m // 2:
            raise ValueError(f"spaces ({self.spaces}) must be <= m/2 ({self.m // 2})")
        return self


def space_mask_int(m: int, s: int) -> int:
    """Spaced-seed AND-mask over 2m bits: clears nt positions 1,3,..,2s-1 from the right."""
    mask = (1 << (2 * m)) - 1
    for j in range(s):
        mask &= ~(0b11 << (2 * (2 * j + 1)))
    return mask


class WindowMinimizers(NamedTuple):
    """Per-window results, all [B, L]; position i is the k-mer window
    starting at base i. `minimizer` is meaningful only where `valid`."""

    minimizer: torch.Tensor  # int64
    valid: torch.Tensor  # bool: all k bases of the window are valid
    span_start: torch.Tensor  # bool: window starts a new super-mer span
    distinct: torch.Tensor  # bool: span's minimizer differs from the last valid window's


def _powers_desc(n: int):
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if n >> b & 1]


def _ahead(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """out[..., i] = x[..., i+d], `fill` past the end."""
    if d == 0:
        return x
    d = min(d, x.shape[-1])
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def _behind(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """out[..., i] = x[..., i-d], `fill` before the start."""
    d = min(d, x.shape[-1])
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., : x.shape[-1] - d]], dim=-1)


def _doubling(x, n, double, compose, fill):
    """Fold n consecutive positions by doubling: double(v, p) folds 2p from
    p-wide values, compose(acc, block, off, p) appends a p-wide block at
    offset off. O(log n) whole-array steps."""
    pw = {1: x}
    p = 1
    while p * 2 <= n:
        pw[2 * p] = double(pw[p], p)
        p *= 2
    acc, off = None, 0
    for p in _powers_desc(n):
        block = _ahead(pw[p], off, fill)
        acc = block if acc is None else compose(acc, block, off, p)
        off += p
    return acc


def _mmers(c: torch.Tensor, m: int) -> torch.Tensor:
    """Forward m-mer starting at each position, first base most significant."""
    return _doubling(
        c, m,
        lambda v, p: (v << (2 * p)) | _ahead(v, p, 0),
        lambda acc, blk, off, p: (acc << (2 * p)) | blk,
        0,
    )


def _revcomps(c: torch.Tensor, m: int) -> torch.Tensor:
    """Reverse complement of the m-mer starting at each position: base j of
    the m-mer lands, complemented, at bits 2j."""
    return _doubling(
        3 - c, m,
        lambda v, p: (_ahead(v, p, 0) << (2 * p)) | v,
        lambda acc, blk, off, p: acc | (blk << (2 * off)),
        0,
    )


def sliding_min(x: torch.Tensor, width: int) -> torch.Tensor:
    """out[i] = min of x[i : i+width] (INT64_MAX past the end)."""
    return _doubling(
        x, width,
        lambda v, p: torch.minimum(v, _ahead(v, p, INT64_MAX)),
        lambda acc, blk, off, p: torch.minimum(acc, blk),
        INT64_MAX,
    )


def sliding_all(valid: torch.Tensor, width: int) -> torch.Tensor:
    """out[i] = AND of valid[i : i+width] (False past the end)."""
    return _doubling(
        valid, width,
        lambda v, p: v & _ahead(v, p, False),
        lambda acc, blk, off, p: acc & blk,
        False,
    )


def priorities(codes: torch.Tensor, params: MinimizerParams) -> torch.Tensor:
    """Priority of the m-mer starting at each position (garbage where the
    m-mer runs into invalid bases or past the end)."""
    m = params.m
    c = (codes & 3).to(torch.int64)
    mm = _mmers(c, m)
    if params.canonical:
        mm = torch.minimum(mm, _revcomps(c, m))
    toggle = params.toggle_mask & ((1 << (2 * m)) - 1)
    return (mm ^ toggle) & space_mask_int(m, params.spaces)


def window_minimizers(codes: torch.Tensor, params: MinimizerParams) -> WindowMinimizers:
    """Plain PyTorch minimizer scan over dense codes [B, L] (0..3, 4 =
    invalid); the twin of the CUDA scan kernel."""
    params.validate()
    if params.wide:
        raise NotImplementedError("wide minimizers (m > 31) are not ported yet")
    codes = codes.to(torch.uint8)
    win_min = sliding_min(priorities(codes, params), params.window)
    win_valid = sliding_all(codes < 4, params.k)
    prev_valid = _behind(win_valid, 1, False)
    prev_min = _behind(win_min, 1, 0)
    span_start = win_valid & (~prev_valid | (win_min != prev_min))
    # distinct: against the last valid window strictly before i, carried
    # across invalid gaps (a running max of valid positions)
    pos = torch.arange(codes.shape[-1], device=codes.device).expand_as(win_min)
    last = torch.cummax(torch.where(win_valid, pos, -1), dim=-1).values
    before = _behind(last, 1, -1)
    before_min = torch.gather(win_min, -1, before.clamp(min=0))
    distinct = span_start & ((before < 0) | (win_min != before_min))
    return WindowMinimizers(win_min, win_valid, span_start, distinct)


def window_minimizers_packed(
    packed: torch.Tensor, valid: torch.Tensor, params: MinimizerParams
) -> WindowMinimizers:
    """Minimizer scan over pack_2bit's wire format ([B, L/4] codes, [B, L/8]
    validity bits): the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors."""
    if packed.device.type == "cpu":
        return window_minimizers(unpack_2bit(packed, valid), params)
    from . import cuda_kernels

    params.validate()
    return WindowMinimizers(*cuda_kernels.window_minimizers_cuda(packed, valid, params))
