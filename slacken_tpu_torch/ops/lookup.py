"""Index probe: exact-match lookup of minimizer keys in a sorted index.

`lookup_taxa` is the plain PyTorch twin (torch.searchsorted over the sorted
int64 keys); `probe` is the entry point the pipeline calls: the CUDA fence
kernel (kernels/probe.cu) for CUDA tensors, the twin for CPU tensors. Both
return the key's taxon, or 0 (NONE) on a miss, for any int64 query.
"""

from __future__ import annotations

import torch

#: keys per fence block (BLOCK_KEYS in kernels/probe.cu)
PROBE_BLOCK = 128


def build_fence(keys: torch.Tensor) -> torch.Tensor:
    """The first key of every PROBE_BLOCK-aligned run of the sorted keys."""
    n = keys.shape[0]
    idx = torch.arange(-(-n // PROBE_BLOCK), device=keys.device) * PROBE_BLOCK
    return keys[idx.clamp(max=max(n - 1, 0))]


def lookup_taxa(keys: torch.Tensor, taxa: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain exact-match probe: int32 taxon per query, 0 on a miss."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    pos = torch.searchsorted(keys, queries)
    idx = pos.clamp(max=n - 1)
    found = (pos < n) & (keys[idx] == queries)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def probe(
    keys: torch.Tensor, taxa: torch.Tensor, fence: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """Probe `queries` (int64 [Q]) in the index: the fence kernel on CUDA,
    the plain twin on the CPU."""
    if queries.device.type == "cpu":
        return lookup_taxa(keys, taxa, queries)
    from . import cuda_kernels

    return cuda_kernels.lookup_taxa_fence_cuda(keys, taxa, fence, queries)
