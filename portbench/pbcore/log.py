"""Progress lines of a run on standard error."""

import sys
import time


class Phases:
    """Prints the seconds of each named step of a set-up as it ends."""

    def __init__(self, what: str):
        self.what, self.t = what, time.perf_counter()

    def __call__(self, step: str) -> None:
        now = time.perf_counter()
        print(f"portbench: {self.what}: {step} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now
