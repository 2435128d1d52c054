"""Kraken 2's minimizers in plain torch, written from the published
definition (Wood et al. 2019, Genome Biol 20:257; Slacken's
MinimizerPriorities): the m-mer at each position, the smaller of it and its
reverse complement, XOR a toggle mask, the spaced-seed bits cleared; a
k-mer window's minimizer is the least such priority over its k - m + 1
m-mers. Nothing of the program is used."""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_TOGGLE_MASK = 0xE37E28C4271B5A2D


class MinimizerSpec(NamedTuple):
    k: int
    m: int
    spaces: int
    toggle_mask: int = DEFAULT_TOGGLE_MASK

    @classmethod
    def of(cls, config: dict) -> "MinimizerSpec":
        idx = config["index"]
        if idx.get("ordering", "xor") != "xor" or not idx.get("canonical", True) or idx["m"] > 31:
            raise ValueError("the reference computes canonical XOR-ordered minimizers with m <= 31")
        toggle = idx.get("toggle_mask", DEFAULT_TOGGLE_MASK)
        return cls(idx["k"], idx["m"], idx["spaces"], int(toggle, 16) if isinstance(toggle, str) else int(toggle))

    def priority_masks(self):
        """(toggle, space) masks over the 2m bits of an m-mer, as int64."""
        full = (1 << (2 * self.m)) - 1
        space = full
        for j in range(self.spaces):
            space &= ~(0b11 << (2 * (2 * j + 1)))
        return _signed(self.toggle_mask & full), _signed(space)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def priorities(codes: torch.Tensor, spec: MinimizerSpec) -> torch.Tensor:
    """int64 [..., L - m + 1]: the priority of the m-mer starting at each
    position of the last axis of `codes` (values 0-3; a position whose m-mer
    holds another value gets -1)."""
    m = spec.m
    c = codes.to(torch.int64)
    n = c.shape[-1] - m + 1
    fwd = torch.zeros(c.shape[:-1] + (n,), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    bad = torch.zeros(fwd.shape, dtype=torch.bool, device=c.device)
    for j in range(m):
        x = c[..., j : j + n]
        fwd = (fwd << 2) | (x & 3)
        rev = rev | ((3 - (x & 3)) << (2 * j))
        bad |= x > 3
    toggle, space = spec.priority_masks()
    p = (torch.minimum(fwd, rev) ^ toggle) & space
    return torch.where(bad, torch.full_like(p, -1), p)


def window_minimizers(codes: torch.Tensor, spec: MinimizerSpec) -> torch.Tensor:
    """int64 [..., L - k + 1]: the minimizer of the k-mer window starting at
    each position, -1 where the window holds a base other than A, C, G, T."""
    p = priorities(codes, spec)
    w = spec.k - spec.m + 1
    n = codes.shape[-1] - spec.k + 1
    big = torch.iinfo(torch.int64).max
    q = torch.where(p < 0, big, p)
    out = q[..., :n]
    for j in range(1, w):
        out = torch.minimum(out, q[..., j : j + n])
    bad = (p < 0)[..., :n]
    for j in range(1, w):
        bad = bad | (p < 0)[..., j : j + n]
    return torch.where(bad, torch.full_like(out, -1), out)
