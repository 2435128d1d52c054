"""The mask idioms the minimizer scan is built from, one function each
(counterparts of the Pallas micro-kernels of `exp_pallas_probe`; the
CUDA source names their place): a select on a comparison, a bool cast, a
shift by concatenation, one carry-forward step, and a bool sum.

Each takes an int32 [R, C] tensor (C >= 16) and returns one of the same
shape. `run(name, x)` launches the idiom's hand-written kernel
(kernels/mask_idioms.cu) on a CUDA tensor, or raises; on a CPU tensor it runs
the plain PyTorch twin (`PLAIN[name]`), which is also what the kernels are
held against.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

THRESHOLD = 64
CARRY_SHIFT = 16


def _shift_right(t: torch.Tensor, by: int) -> torch.Tensor:
    """Columns moved right by `by` within each row, zeros shifted in."""
    out = torch.zeros_like(t)
    out[:, by:] = t[:, :-by]
    return out


def select_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > THRESHOLD, 1, 0).to(torch.int32)


def astype_plain(x: torch.Tensor) -> torch.Tensor:
    return (x > THRESHOLD).to(torch.int32)


def concat_plain(x: torch.Tensor) -> torch.Tensor:
    """m & (m shifted left by one column), false at each row's end."""
    m = x > THRESHOLD
    nxt = torch.zeros_like(m)
    nxt[:, :-1] = m[:, 1:]
    return torch.where(m & nxt, 1, 0).to(torch.int32)


def carry_plain(x: torch.Tensor) -> torch.Tensor:
    """One step of the scan's doubling carry-forward: where the mask is
    clear and set CARRY_SHIFT columns back, take the value from there."""
    m = x > THRESHOLD
    take = ~m & _shift_right(m, CARRY_SHIFT)
    return torch.where(take, _shift_right(x, CARRY_SHIFT), x)


def sum_bool_plain(x: torch.Tensor) -> torch.Tensor:
    """x plus the count of x > THRESHOLD over the whole array."""
    return x + (x > THRESHOLD).sum().to(torch.int32)


PLAIN: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "select": select_plain,
    "astype": astype_plain,
    "concat": concat_plain,
    "carry": carry_plain,
    "sum_bool": sum_bool_plain,
}


def run(name: str, x: torch.Tensor) -> torch.Tensor:
    """The idiom `name` on x: its CUDA kernel for a CUDA tensor, its plain
    twin for a CPU tensor."""
    if x.device.type == "cpu":
        return PLAIN[name](x)
    from . import cuda_kernels

    return cuda_kernels.mask_idiom_cuda(name, x)

