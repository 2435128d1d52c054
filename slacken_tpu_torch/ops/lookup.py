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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: mean keys per directory bucket: one 32-byte sector (measured on an H100
#: against 2, 8, 16 and 64)
BUCKET_KEYS = 4


class Directory(NamedTuple):
    """Prefix directory over sorted non-negative int64 keys: bucket p holds
    the keys with `key >> shift == p`, at `starts[p] : starts[p + 1]`."""

    starts: torch.Tensor  # int32 [2^b + 1], starts[2^b] = number of keys
    shift: int  # 0 <= shift <= 63

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
        return torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
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
        return torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
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
    """Probe `queries` (int64 [Q]) in the index: the directory kernel on
    CUDA, the plain twin on the CPU."""
    if queries.device.type == "cpu":
        return lookup_taxa(keys, taxa, queries)
    from . import cuda_kernels

    return cuda_kernels.lookup_taxa_directory_cuda(keys, taxa, directory, queries)
