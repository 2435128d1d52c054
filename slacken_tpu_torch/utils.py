"""Host-side pipeline utilities (counterpart of slacken_tpu/utils.py: the
named-task timer, the phase timers and the prefetch iterator; the tracing
hooks of that module are not used by this package)."""

from __future__ import annotations

import contextlib
import queue
import sys
import threading
import time
from typing import Dict, Iterable, Optional


class Timer:
    """Named task timer, printing Start/Finish lines to stderr like the
    reference."""

    def __init__(self, task: str, quiet: bool = False):
        self.task = task
        self.quiet = quiet
        self.start = time.time()
        self.elapsed: Optional[float] = None
        if not quiet:
            print(f"Start task: {task}", file=sys.stderr)

    def finish(self) -> float:
        self.elapsed = time.time() - self.start
        if not self.quiet:
            s = int(self.elapsed)
            print(f"Finish task: {self.task} [{s // 60} min {s % 60} s]", file=sys.stderr)
        return self.elapsed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class PhaseTimers:
    """Wall seconds by phase (counterpart of slacken_tpu/utils.py's
    PhaseTimers, which STPU_BUILD_TRACE turns on there): `with
    timers.phase(name):` adds the block's wall to `seconds[name]`, timed
    with Timer. Phases nest, and a phase's seconds exclude those of the
    phases inside it, so the walls add up to the whole. With `device` (a
    torch device) each phase starts and ends by waiting for the device's
    queued work, so that device work counts in the phase that queued it.
    Disabled (the default), `phase` times nothing and costs nothing."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.device = device
        self.seconds: Dict[str, float] = {}
        self._inner = [0.0]  # seconds of the phases inside each open phase

    def _sync(self):
        if self.device is not None and getattr(self.device, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t = Timer(name, quiet=True)
        self._inner.append(0.0)
        try:
            yield
        finally:
            self._sync()
            dt = t.finish()
            inner = self._inner.pop()
            self._inner[-1] += dt
            self.seconds[name] = self.seconds.get(name, 0.0) + dt - inner

    def timed(self, name: str, items: Iterable):
        """`items`, each step of the iteration timed under `name`."""
        if not self.enabled:
            yield from items
            return
        it = iter(items)
        while True:
            with self.phase(name):
                item = next(it, _END)
            if item is _END:
                return
            yield item


_END = object()


def prefetch_iterator(it, depth: int = 2):
    """Run a (possibly expensive) iterator in a background thread, keeping up
    to `depth` items ready ahead of the consumer.

    Used to overlap host-side input parsing (the C++ FASTQ/FASTA packer
    releases the GIL during parse) with device compute — the analogue of
    the reference's Spark input stage running concurrently with the shuffle
    (FileInputs.scala readers are lazy Datasets pulled by executor threads).
    Exceptions raised by the producer re-raise at the consumer site."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    error = []

    def worker():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            error.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="stpu-prefetch")
    t.start()
    while True:
        x = q.get()
        if x is sentinel:
            if error:
                raise error[0]
            return
        yield x
