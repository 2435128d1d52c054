"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of standard
output (see portbench/README.md). Exits with another code than 0, and
prints no result, without a CUDA device, with fewer devices than the cell
asks for, or when the process holds JAX or the JAX package."""

import os
import sys
import time

T_START = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = _ROOT  # import the benchmark as the package portbench, and the port beside it

from portbench.pbcore.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
