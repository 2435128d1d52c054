"""What the host gave a run, printed on standard error and in the result
line (`host`), so that runs that read apart can be told apart by the host:
the threads and cores the process had, a fixed probe of the host's speed at
the start of set-up and after the window, and over the window the process's
own CPU time and the pauses of Python's garbage collector."""

from __future__ import annotations

import gc
import os
import resource
import time
from typing import Dict, List

import numpy as np


def probe() -> float:
    """Seconds of a fixed piece of host work (Python and numpy), the least
    of three tries."""
    data = np.random.default_rng(0).random(1 << 20)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        sum(i * i for i in range(400_000))
        np.sort(data)
        best = min(best, time.perf_counter() - t)
    return best


class HostWatch:
    """Readings at the start of set-up, at the window's start and after it."""

    def __init__(self):
        self.probe_setup_s = probe()
        self.pauses: List[float] = []
        self._gc_start = None

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self.pauses.append(time.perf_counter() - self._gc_start)
            self._gc_start = None

    def window_start(self):
        self.t0, self.ru0 = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._on_gc)

    def window_end(self) -> Dict[str, object]:
        t1, ru1 = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.remove(self._on_gc)
        import torch

        return {
            "torch_threads": torch.get_num_threads(),
            "cpus_allowed": len(os.sched_getaffinity(0)),
            "probe_setup_s": self.probe_setup_s,
            "probe_after_s": probe(),
            "process_cpu_share": (ru1.ru_utime + ru1.ru_stime - self.ru0.ru_utime - self.ru0.ru_stime) / (t1 - self.t0),
            "gc_pauses": len(self.pauses),
            "gc_s": sum(self.pauses),
            "gc_max_s": max(self.pauses, default=0.0),
        }
