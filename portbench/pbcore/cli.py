"""The command line of portbench/run.py."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import guard, manifest

def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float, device: Optional[str] = None) -> int:
    args = parse(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = "cuda"
    from . import harness

    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    except guard.Forbidden as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0
