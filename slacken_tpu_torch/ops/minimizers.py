"""Minimizer scan: XOR-ordered and rank-table minimizers, narrow and wide.

Same semantics as slacken_tpu.ops.minimizers (Kraken 2 compatible):

  priority(m-mer) = (canonical(m-mer) XOR toggle_mask) AND spaced_seed_mask

with the toggle mask truncated to 2m bits, the window minimizer the minimum
priority over the W = k - m + 1 m-mers of a k-mer window, and super-mer
spans starting where the window minimum changes or validity resumes.

For m <= 31 every value fits one int64 (2m <= 62 bits), so the plain version
works on int64 tensors with no unsigned arithmetic: the reverse complement
is built by the same doubling as the forward m-mer, over complemented codes,
so bit 63 is never set.

With a rank table (an explicit ordering, ops/ordering.py; m <= 15) the
priority is `lut[canonical(m-mer) AND spaced_seed_mask]` and no toggle
applies; ranks are below 4^15 and stay int64 like any narrow key.

Wide minimizers (31 < m <= 63) are 2m-bit values held right-aligned in two
int64 limbs: hi64 (below 2^62) and lo64, whose 64 bits are all in use. The
m-mer of m bases is the (m - 32)-mer of its first bases over the 32-mer of
its last, so both limbs come from the narrow doubling. Order on the lo limb
is unsigned: the scan keeps it with its sign bit flipped, where signed and
unsigned order agree, and flips it back at the end. The toggle mask is
replicated over the limbs as the reference does (`wide_toggle_mask`).

`window_minimizers` is the plain PyTorch twin of the CUDA scan kernels;
`window_minimizers_packed` is the entry point the pipeline calls: it launches
a kernel for CUDA tensors and runs the twin only for CPU tensors. On the card
few long rows are scanned in segments, a warp each, and stitched inside the
same launch; `stitch_segments` is the twin of that stitch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .encode import unpack_2bit

#: Kraken 2's minimizer toggle mask (mmscanner.h)
DEFAULT_TOGGLE_MASK = 0xE37E28C4271B5A2D
INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)


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


def wide_toggle_mask(m: int, toggle: int) -> int:
    """The XOR toggle over 2m bits: every full 32-nt long of the m-mer carries
    the whole 64-bit mask and a trailing partial long of r nts its low 2r
    bits. For m <= 32 this is the low 2m bits."""
    if m <= 32:
        return toggle & ((1 << (2 * m)) - 1)
    r = m % 32
    val = 0
    for _ in range(m // 32):
        val = (val << 64) | (toggle & ((1 << 64) - 1))
    if r:
        val = (val << (2 * r)) | (toggle & ((1 << (2 * r)) - 1))
    return val


def limbs_int64(value: int):
    """(hi64, lo64) of a 128-bit Python integer as signed int64 bit patterns."""
    signed = lambda x: x - (1 << 64) if x >> 63 else x  # noqa: E731
    return signed(value >> 64), signed(value & ((1 << 64) - 1))


class WindowMinimizers(NamedTuple):
    """Per-window results; position i is the k-mer window starting at base
    i. `minimizer` is int64 [B, L] for m <= 31 and int64 [B, L, 2], the
    (hi64, lo64) limbs of each value, for a wide m; the flags are [B, L].
    Every limb of `minimizer` is -1 where the window is not `valid`."""

    minimizer: torch.Tensor  # int64 [B, L], or [B, L, 2] for a wide m
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


def priorities(codes: torch.Tensor, params: MinimizerParams, lut=None) -> torch.Tensor:
    """Priority of the narrow m-mer starting at each position (garbage where
    the m-mer runs into invalid bases or past the end). With `lut`, an
    integer rank table of 4^m entries on the codes' device, the priority is
    the rank of the masked canonical m-mer."""
    m = params.m
    c = (codes & 3).to(torch.int64)
    mm = _mmers(c, m)
    if params.canonical:
        mm = torch.minimum(mm, _revcomps(c, m))
    if lut is not None:
        return lut[mm & space_mask_int(m, params.spaces)].to(torch.int64)
    toggle = params.toggle_mask & ((1 << (2 * m)) - 1)
    return (mm ^ toggle) & space_mask_int(m, params.spaces)


def _min_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of two stacks [2, ...] of (hi64, flipped lo64)."""
    a_first = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))
    return torch.where(a_first, a, b)


def priorities_wide(codes: torch.Tensor, params: MinimizerParams) -> torch.Tensor:
    """Priority of the wide m-mer (31 < m <= 63) starting at each position,
    as a stack [2, B, L] of hi64 and lo64 with lo64's sign bit flipped."""
    m = params.m
    c = (codes & 3).to(torch.int64)
    zero = torch.zeros_like(c)
    # forward: the first m - 32 bases over the 32-mer that follows them
    mm = torch.stack([_mmers(c, m - 32) if m > 32 else zero, _ahead(_mmers(c, 32), m - 32, 0)])
    mm[1] ^= INT64_MIN
    if params.canonical:
        # reverse complement: base j lands, complemented, at bits 2j
        rc = torch.stack([_ahead(_revcomps(c, m - 32), 32, 0) if m > 32 else zero, _revcomps(c, 32)])
        rc[1] ^= INT64_MIN
        mm = _min_wide(mm, rc)
    t_hi, t_lo = limbs_int64(wide_toggle_mask(m, params.toggle_mask))
    s_hi, s_lo = limbs_int64(space_mask_int(m, params.spaces))
    lo = (((mm[1] ^ INT64_MIN) ^ t_lo) & s_lo) ^ INT64_MIN
    return torch.stack([(mm[0] ^ t_hi) & s_hi, lo])


def sliding_min_wide(x: torch.Tensor, width: int) -> torch.Tensor:
    """sliding_min over a stack [2, B, L] of (hi64, flipped lo64)."""
    return _doubling(
        x, width,
        lambda v, p: _min_wide(v, _ahead(v, p, INT64_MAX)),
        lambda acc, blk, off, p: _min_wide(acc, blk),
        INT64_MAX,
    )


def window_minimizers(codes: torch.Tensor, params: MinimizerParams, lut=None) -> WindowMinimizers:
    """Plain PyTorch minimizer scan over dense codes [B, L] (0..3, 4 =
    invalid); the twin of the CUDA scan kernels. `lut` is a rank table on
    the codes' device (explicit orderings, m <= 15)."""
    params.validate()
    codes = codes.to(torch.uint8)
    wide = params.wide
    if wide:
        if lut is not None:
            raise ValueError("explicit-ordering rank tables require m <= 15")
        win_min = sliding_min_wide(priorities_wide(codes, params), params.window)
        differs = lambda a, b: (a != b).any(0)  # noqa: E731
    else:
        win_min = sliding_min(priorities(codes, params, lut), params.window)
        differs = lambda a, b: a != b  # noqa: E731
    win_valid = sliding_all(codes < 4, params.k)
    prev_valid = _behind(win_valid, 1, False)
    span_start = win_valid & (~prev_valid | differs(win_min, _behind(win_min, 1, 0)))
    # distinct: against the last valid window strictly before i, carried
    # across invalid gaps (a running max of valid positions)
    pos = torch.arange(codes.shape[-1], device=codes.device).expand_as(win_valid)
    last = torch.cummax(torch.where(win_valid, pos, -1), dim=-1).values
    before = _behind(last, 1, -1)
    before_min = torch.gather(win_min, -1, before.clamp(min=0).expand_as(win_min))
    distinct = span_start & ((before < 0) | differs(win_min, before_min))
    # no key is negative, so the probe dismisses an invalid window unsearched
    if wide:
        win_min = torch.stack([win_min[0], win_min[1] ^ INT64_MIN], dim=-1)
        out = torch.where(win_valid[..., None], win_min, -1)
    else:
        out = torch.where(win_valid, win_min, -1)
    return WindowMinimizers(out, win_valid, span_start, distinct)


def carried(minimizer: torch.Tensor, summary: torch.Tensor) -> torch.Tensor:
    """The flat positions into [B, L] whose `distinct` byte the carry across
    segments clears. summary int64 [B, nseg, 4], a row of it for each
    segment: whether the segment holds a valid window, the flat index into
    [B, L] of its first valid window when nothing valid lay in the reach of
    its own warp (else -1), and the (hi64, lo64) limbs of the minimizer of
    its last valid window (hi64 0 for a narrow m). Such a first window is
    carried when the nearest earlier segment of the row that holds a valid
    window ended on the same minimizer. minimizer int64 [B, L] or [B, L, 2]."""
    b, nseg, _ = summary.shape
    has, first = summary[..., 0] != 0, summary[..., 1]
    seg = torch.arange(nseg, device=summary.device).expand(b, nseg)
    last_with = torch.cummax(torch.where(has, seg, -1), dim=1).values
    before = _behind(last_with, 1, -1)  # the nearest earlier segment that holds a valid window
    limbs = minimizer.reshape(b * minimizer.shape[1], -1)  # [B * L, 1 or 2]
    prev = torch.gather(summary[..., 4 - limbs.shape[1]:], 1,
                        before.clamp(min=0)[..., None].expand(b, nseg, limbs.shape[1]))
    same = (limbs[first.clamp(min=0)] == prev).all(-1)
    return first[(first >= 0) & (before >= 0) & same]


def stitch_segments(minimizer: torch.Tensor, distinct: torch.Tensor, summary: torch.Tensor) -> torch.Tensor:
    """Plain twin of the stitch of rows cut into segments (kernels/scan.cu,
    stitch_row, inside the segmented scan's launch): `distinct` with the
    bytes at `carried(minimizer, summary)` cleared, as a new bool [B, L].
    Over the summaries of a segment's scan on its own, that is the whole
    row's `distinct`; over the kernel's, whose `distinct` is already
    stitched, it changes nothing."""
    out = distinct.clone()
    out.view(-1)[carried(minimizer, summary)] = False
    return out


def window_minimizers_packed(
    packed: torch.Tensor, valid: torch.Tensor, params: MinimizerParams, lut=None
) -> WindowMinimizers:
    """Minimizer scan over pack_2bit's wire format ([B, L/4] codes, [B, L/8]
    validity bits): a CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors. `lut` is an int32 rank table on the same device, or None."""
    if packed.device.type == "cpu":
        return window_minimizers(unpack_2bit(packed, valid), params, lut)
    from . import cuda_kernels

    params.validate()
    return WindowMinimizers(*cuda_kernels.window_minimizers_cuda(packed, valid, params, lut))
