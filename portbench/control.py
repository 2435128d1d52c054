"""The control of a cell: the plain reference put in the program's place,
with keys kept only to their top bits (as a compact hash table that stores
a fragment of each key, Kraken 2's own trade of exactness for memory), run
through the cell's set-up, a short window and its check, on each seed in
one process. Every line printed is one seed's compared numbers; the control
has to come out not correct on each.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 10] [--drop-bits 30]

The benchmark's own runs never run it."""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.pbcore import harness, manifest  # noqa: E402

#: key bits the control drops: 62-bit keys kept to their top 32
DROP_BITS = 30


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--drop-bits", type=int, default=DROP_BITS)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run(cell, seed, args.seconds, False, device, time.perf_counter(), control=args.drop_bits)
        print(json.dumps({"workload": cell.name, "seed": seed, "drop_bits": args.drop_bits,
                          "correct": r["correct"], "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
