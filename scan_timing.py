#!/usr/bin/env python3
"""Time the minimizer-scan kernels on one NVIDIA GPU at the main path's
shapes, to compare two versions of the kernels inside one run on one card.

    python3 scan_timing.py [--root DIR]

`--root` imports slacken_tpu_torch from DIR, another checkout of the
repository (the parent commit unpacked into a git-ignored directory, say);
by default this one. It builds that checkout's kernels, prints the scan
instances' registers and stack frames (ptxas), then one line a (kernel,
parameters, shape): the device time alone (torch.profiler, as
chip_smoke.device_ms) and back to back through the wrapper (CUDA events, as
chip_smoke.cuda_ms). The rows are random codes with 5% N (seed 20260816).
Run parent, change, change, parent in one command to compare two trees.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

import chip_smoke

#: (label, (k, m, s), rank-table m or None, shapes)
CASES = [
    ("scan", (35, 31, 7), None, [*chip_smoke.SCAN_SHAPES, chip_smoke.LONG_ROWS]),
    ("scan_lut", (35, 13, 3), 13, [chip_smoke.SCAN_SHAPES[0], chip_smoke.LONG_ROWS]),
    ("scan_wide", (50, 45, 7), None, [*chip_smoke.SCAN_SHAPES, chip_smoke.LONG_ROWS]),
    ("scan_wide", (35, 33, 0), None, [chip_smoke.SCAN_SHAPES[0]]),
    ("scan_wide", (80, 63, 7), None, [chip_smoke.SCAN_SHAPES[0]]),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_timing: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from slacken_tpu_torch.ops import cuda_kernels, encode
    from slacken_tpu_torch.ops.minimizers import MinimizerParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; kernels from {cuda_kernels.__file__}", flush=True)
    dev = torch.device("cuda")
    name = os.path.relpath(args.root)
    cuda_kernels.build(verbose=True)
    lines = cuda_kernels.build_info[1].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "scan" in line:
            used = next((x.strip() for x in lines[i + 1:i + 4] if "Used" in x), "")
            print(f"[{name}] {line.split(chr(39))[1][-60:]}: {used}", flush=True)
    rng = np.random.default_rng(20260816)
    for label, kms, lut_m, shapes in CASES:
        mp = MinimizerParams(*kms)
        lut = None
        if lut_m is not None:
            lut = torch.from_numpy(rng.permutation(1 << (2 * lut_m)).astype(np.int32)).to(dev)
        for shape in shapes:
            codes = chip_smoke.random_codes(rng, shape)
            packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(codes))
            run = lambda: cuda_kernels.window_minimizers_cuda(packed, valid, mp, lut)  # noqa: E731
            ms = chip_smoke.cuda_ms(run)
            each = chip_smoke.device_ms(run, by_kernel=True)
            alone = {re.search(r"\w+_kernel(<[^>]*>)?", k).group(0) if "_kernel" in k else k[:40]: round(v, 4)
                     for k, v in each.items()}
            print(f"[{name}] {label} {kms} {list(shape)}: back to back {ms:.4f} ms; alone {alone}", flush=True)
        del lut
    return 0

if __name__ == "__main__":
    sys.exit(main())
