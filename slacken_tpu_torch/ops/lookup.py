"""Index probe: exact-match lookup of minimizer keys in a sorted index.

The index carries a prefix directory (`build_directory`): the top bits of a
key name a bucket of a few neighbouring keys, so a probe is two adjacent
a directory load and a short scan instead of a bisection of the whole
array. `lookup_taxa` is the plain PyTorch twin (torch.searchsorted over the
sorted int64 keys); `lookup_taxa_directory` walks the directory with tensor
ops (the CUDA kernel, kernels/probe.cu, scans forward from the bucket's
start where this bisects the bucket); `probe` is the entry
point the pipeline calls: the kernel for CUDA tensors, the twin for CPU
tensors. All return the key's taxon, or 0 (NONE) on a miss, for any int64
query.

Wide keys (m > 31) are rows of an interleaved int64 [N, 2] tensor, the
(hi64, lo64) limbs of a 2m-bit value, sorted by the value; hi64 is below
2^62 and lo64 is compared unsigned. Every function here takes either kind
and tells them apart by `keys.dim()`; queries are [Q] or [Q, 2] to match.
The directory's prefix then comes from the top of the widest 128-bit key
(wholly or mostly from lo64 when m is 32 or 33), and its shift reaches 127.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: mean keys per directory bucket: one 32-byte sector (measured on an H100
#: against 2, 8, 16 and 64)
BUCKET_KEYS = 4


class Directory(NamedTuple):
    """Prefix directory over sorted non-negative keys: bucket p holds the
    keys with `key >> shift == p`, at `starts[p] : starts[p + 1]`."""

    starts: torch.Tensor  # int32 [2^b + 1], starts[2^b] = number of keys
    shift: int  # 0 <= shift <= 63, or <= 127 over wide keys

    @property
    def buckets(self) -> int:
        return self.starts.shape[0] - 1


def build_directory(keys: torch.Tensor, bucket_keys: int = BUCKET_KEYS) -> Directory:
    """Directory of the sorted, unique, non-negative `keys` with about
    `bucket_keys` keys a bucket: b = ceil(log2(n / bucket_keys)) prefix bits,
    taken from the top of the widest key. One pass over the keys; index
    preparation, not part of a probe."""
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"the directory's int32 entries hold fewer than 2^31 keys, got {n}")
    if keys.dim() == 2:
        return _build_directory_wide(keys, bucket_keys)
    if n and int(keys[0]) < 0:
        raise ValueError("index keys must be non-negative")
    width = int(keys[-1]).bit_length() if n else 0
    b = min((max(-(-n // bucket_keys), 1) - 1).bit_length(), width)
    shift = width - b
    edges = torch.arange((1 << b) + 1, dtype=torch.int64, device=keys.device) << shift
    starts = torch.searchsorted(keys, edges).to(torch.int32)
    starts[-1] = n  # 2^b << shift overflows int64 when width is 63
    return Directory(starts, shift)


def lookup_taxa(keys: torch.Tensor, taxa: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain exact-match probe: int32 taxon per query, 0 on a miss."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    if keys.dim() == 2:
        return _lookup_taxa_wide(keys, taxa, queries)
    pos = torch.searchsorted(keys, queries)
    idx = pos.clamp(max=n - 1)
    found = (pos < n) & (keys[idx] == queries)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def lookup_taxa_directory(
    keys: torch.Tensor, taxa: torch.Tensor, directory: Directory, queries: torch.Tensor
) -> torch.Tensor:
    """A walk of the directory in tensor ops: prefix, the bucket's two
    directory entries, bisection of the bucket, one taxon gather. Holds the
    directory and its edge cases against `lookup_taxa` on the CPU; off the
    pipeline's path."""
    n = keys.shape[0]
    starts, shift = directory
    if n == 0 or queries.numel() == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    if keys.dim() == 2:
        return _lookup_taxa_directory_wide(keys, taxa, directory, queries)
    # a negative query, or one above the widest key's prefix, misses unsearched
    prefix = queries >> shift
    inside = (queries >= 0) & (prefix < directory.buckets)
    p = torch.where(inside, prefix, 0)
    lo, hi = starts[p].long(), starts[p + 1].long()
    end = hi
    for _ in range(int((hi - lo).max()).bit_length()):
        mid = (lo + hi) >> 1
        less = (lo < hi) & (keys[mid.clamp(max=n - 1)] < queries)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less | (lo >= hi), hi, mid)
    idx = lo.clamp(max=n - 1)
    found = inside & (lo < end) & (keys[idx] == queries)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def probe(
    keys: torch.Tensor, taxa: torch.Tensor, directory: Directory, queries: torch.Tensor
) -> torch.Tensor:
    """Probe `queries` (int64 [Q], or [Q, 2] in a wide index) in the index:
    a directory kernel on CUDA, the plain twin on the CPU."""
    if queries.device.type == "cpu":
        return lookup_taxa(keys, taxa, queries)
    from . import cuda_kernels

    return cuda_kernels.lookup_taxa_directory_cuda(keys, taxa, directory, queries)


# ---------------------------------------------------------------------------
# Wide keys: int64 [N, 2] rows of (hi64, lo64)
# ---------------------------------------------------------------------------

_SIGN = -(1 << 63)  # x ^ _SIGN: unsigned order of x as signed order


def prefix_wide(k2: torch.Tensor, shift: int):
    """(low 64 bits, the bits above them) of the 128-bit values `k2 >> shift`
    with hi64 >= 0, 0 <= shift <= 127."""
    hi, lo = k2[:, 0], k2[:, 1]
    if shift >= 64:
        return hi >> (shift - 64), torch.zeros_like(hi)
    if shift == 0:
        return lo, hi
    lo_part = (lo >> shift) & ((1 << (64 - shift)) - 1)  # a logical shift
    return (hi << (64 - shift)) | lo_part, hi >> shift


def _build_directory_wide(keys: torch.Tensor, bucket_keys: int) -> Directory:
    n = keys.shape[0]
    if n and int(keys[0, 0]) < 0:
        raise ValueError("index keys must be non-negative")
    widest = ((int(keys[-1, 0]) << 64) | (int(keys[-1, 1]) & ((1 << 64) - 1))) if n else 0
    width = widest.bit_length()
    b = min((max(-(-n // bucket_keys), 1) - 1).bit_length(), width)
    shift = width - b
    prefixes = prefix_wide(keys, shift)[0]  # below 2^b, b <= 31: sorted as signed
    edges = torch.arange((1 << b) + 1, dtype=torch.int64, device=keys.device)
    return Directory(torch.searchsorted(prefixes.contiguous(), edges).to(torch.int32), shift)


def _bisect_wide(keys, queries, lo, hi):
    """First position in [lo, hi) whose key is not below its query, by
    bisection on both limbs; `hi` where every key of the range is below."""
    n = keys.shape[0]
    q_hi, q_lo = queries[:, 0], queries[:, 1] ^ _SIGN
    for _ in range(int((hi - lo).max()).bit_length()):
        mid = ((lo + hi) >> 1).clamp(max=n - 1)
        k_hi, k_lo = keys[mid, 0], keys[mid, 1] ^ _SIGN
        less = (lo < hi) & ((k_hi < q_hi) | ((k_hi == q_hi) & (k_lo < q_lo)))
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less | (lo >= hi), hi, mid)
    return lo


def _taxa_at(keys, taxa, queries, pos, end, inside):
    idx = pos.clamp(max=keys.shape[0] - 1)
    found = inside & (pos < end) & (keys[idx] == queries).all(1)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def _lookup_taxa_wide(keys, taxa, queries):
    """torch.searchsorted has no pair form: the run of keys with the
    query's hi64 from two searches, then a bisection of lo64 inside it. A
    negative hi64 (an invalid window's -1) matches no key."""
    if queries.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=queries.device)
    hi = keys[:, 0].contiguous()
    q_hi = queries[:, 0].contiguous()
    lo, end = torch.searchsorted(hi, q_hi), torch.searchsorted(hi, q_hi, right=True)
    pos = _bisect_wide(keys, queries, lo, end)
    return _taxa_at(keys, taxa, queries, pos, end, q_hi >= 0)


def _lookup_taxa_directory_wide(keys, taxa, directory, queries):
    starts, shift = directory
    p_lo, p_above = prefix_wide(queries, shift)
    inside = (queries[:, 0] >= 0) & (p_above == 0) & (p_lo >= 0) & (p_lo < directory.buckets)
    p = torch.where(inside, p_lo, 0)
    lo, end = starts[p].long(), starts[p + 1].long()
    pos = _bisect_wide(keys, queries, lo, end)
    return _taxa_at(keys, taxa, queries, pos, end, inside)
