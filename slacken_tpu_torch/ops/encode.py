"""2-bit DNA encoding (counterpart of slacken_tpu/ops/encode.py).

Alphabet: A=0, C=1, G=2, T=U=3, chosen so that the complement is XOR with
all-ones, matching the reference encoding (BitRepresentation.scala:31-44).
Code 4 marks an invalid/ambiguous base (or padding). The host functions are
numpy; `unpack_2bit` is the PyTorch inverse of `pack_2bit` that the plain
scan path uses (the CUDA scan kernel unpacks inside the kernel).
"""

from __future__ import annotations

import numpy as np
import torch

A, C, G, T = 0, 1, 2, 3
INVALID = 4

#: uint8 lookup table: ASCII byte -> 2-bit code (or INVALID)
CODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in [("A", A), ("C", C), ("G", G), ("T", T), ("U", T)]:
    CODE_LUT[ord(_ch)] = _code
    CODE_LUT[ord(_ch.lower())] = _code


def encode_seq(seq) -> np.ndarray:
    """Encode one sequence (str/bytes) to a uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def pack_batch(seqs, length: int, fill: int = INVALID):
    """Pack sequences (str, bytes or code arrays) into a [B, length] uint8
    code matrix, truncating longer ones and padding shorter ones with `fill`
    (INVALID, so no k-mer window ever spans padding). Returns (codes,
    lengths [B] int32)."""
    out = np.full((len(seqs), length), fill, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        c = s if isinstance(s, np.ndarray) else encode_seq(s)
        m = min(len(c), length)
        out[i, :m] = c[:m]
        lens[i] = m
    return out, lens


def pack_2bit(codes: np.ndarray):
    """Host-side dense->packed transform for the host-to-device copy: codes
    [B, L] uint8 (0..4, L % 8 == 0) become (packed [B, L/4] uint8 with 4
    bases per byte, little-endian, valid [B, L/8] uint8 bitmask)."""
    c = codes & np.uint8(3)
    packed = (
        c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    ).astype(np.uint8)
    valid = np.packbits(codes < INVALID, axis=1, bitorder="little")
    return packed, valid


def unpack_2bit(packed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_2bit: uint8 codes [B, L] (INVALID where the validity
    bit is clear) from [B, L/4] codes and [B, L/8] little-endian bits."""
    b = packed.shape[0]
    p = packed.to(torch.int32)
    codes = torch.stack([(p >> (2 * j)) & 3 for j in range(4)], dim=-1).reshape(b, -1)
    v = valid.to(torch.int32)
    ok = torch.stack([(v >> j) & 1 for j in range(8)], dim=-1).reshape(b, -1)
    return torch.where(ok == 1, codes, INVALID).to(torch.uint8)
