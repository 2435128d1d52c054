"""Host-side pipeline utilities (counterpart of slacken_tpu/utils.py; the
timers and tracing hooks of that module are not used by this package)."""

from __future__ import annotations

import queue
import threading


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
