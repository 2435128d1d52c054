"""slacken_tpu_torch: the slacken_tpu classifier on PyTorch and CUDA.

A port of the JAX package for NVIDIA Hopper GPUs: the minimizer scan and the
index probe are hand-written CUDA kernels (ops/kernels/*.cu, built with nvcc
at first use), everything around them is PyTorch. It imports no JAX; the
JAX-free host modules of slacken_tpu (taxonomy, report, native packer,
storage) are shared. Every entry point takes an explicit device.
"""

from __future__ import annotations

import numpy as np
import torch


def get_device(name: str = "cuda") -> torch.device:
    """The torch device `name`; "cuda" raises when CUDA is unavailable
    instead of quietly running on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass --device cpu "
            "(device='cpu') to run the plain PyTorch path"
        )
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array to `device`: through pinned memory and an asynchronous
    copy on CUDA, as is on the CPU."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
