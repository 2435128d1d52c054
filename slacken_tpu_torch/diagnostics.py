"""Kernel diagnostics: run the five mask-idiom kernels and hold each against
its plain PyTorch twin (counterpart of the JAX package's `exp_pallas_probe`
experiment; kernels/mask_idioms.cu names its place).

    python -m slacken_tpu_torch.diagnostics [--device cuda]

prints one JSON object, name -> "ok" or the mismatch, and exits non-zero on
any mismatch. The default device is cuda; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from . import get_device
from .ops import mask_idioms

SEED = 20260816


def probe_inputs(device) -> Dict[str, torch.Tensor]:
    """The experiment's [8, 128] ramp and a [4096, 128] seeded random array
    with values in [0, 129), both int32 on `device`."""
    rng = np.random.default_rng(SEED)
    return {
        "[8, 128] arange": torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128).to(device),
        "[4096, 128] random": torch.from_numpy(
            rng.integers(0, 129, (4096, 128)).astype(np.int32)).to(device),
    }


def kernel_probe(device) -> Dict[str, str]:
    """Run every mask idiom on `device` at both inputs and compare with the
    plain twin computed on the same tensor: name -> "ok" or the mismatch."""
    device = torch.device(device)
    out = {}
    inputs = probe_inputs(device)
    for name, plain in mask_idioms.PLAIN.items():
        verdict = "ok"
        for label, x in inputs.items():
            got, want = mask_idioms.run(name, x), plain(x)
            if got.dtype != want.dtype or not torch.equal(got, want):
                bad = int((got != want).sum()) if got.shape == want.shape else -1
                verdict = f"mismatch at {label}: {bad} elements differ ({got.dtype} vs {want.dtype})"
                break
        out[name] = verdict
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slacken_tpu_torch.diagnostics", description=__doc__)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    result = kernel_probe(get_device(args.device))
    print(json.dumps(result))
    return 0 if all(v == "ok" for v in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
