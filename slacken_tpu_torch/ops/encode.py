"""2-bit DNA encoding: the host functions are slacken_tpu's own (numpy, no
JAX); `unpack_2bit` is the PyTorch inverse of `pack_2bit` that the plain
scan path uses (the CUDA scan kernel unpacks inside the kernel)."""

from __future__ import annotations

import torch

from slacken_tpu.ops.encode import INVALID, encode_seq, pack_2bit  # noqa: F401


def unpack_2bit(packed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_2bit: uint8 codes [B, L] (INVALID where the validity
    bit is clear) from [B, L/4] codes and [B, L/8] little-endian bits."""
    b = packed.shape[0]
    p = packed.to(torch.int32)
    codes = torch.stack([(p >> (2 * j)) & 3 for j in range(4)], dim=-1).reshape(b, -1)
    v = valid.to(torch.int32)
    ok = torch.stack([(v >> j) & 1 for j in range(8)], dim=-1).reshape(b, -1)
    return torch.where(ok == 1, codes, INVALID).to(torch.uint8)
