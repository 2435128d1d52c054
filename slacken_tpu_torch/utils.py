"""Host-side pipeline utilities (counterpart of slacken_tpu/utils.py: the
named-task timer and the prefetch iterator; the phase timers and tracing
hooks of that module are not used by this package)."""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Optional


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
