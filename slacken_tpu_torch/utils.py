"""Host-side pipeline utilities (counterpart of slacken_tpu/utils.py: the
named-task timer, the phase timers and the prefetch iterator), and the
port's one recorder of spans and counters.

Spans record while a torch profiler runs in the process (and wherever a
PhaseTimers is enabled); otherwise a span costs one attribute read. To see
them, run the program under `torch.profiler.profile` and merge
`chrome_events()` into the profile's Chrome trace: both are on Unix time,
so subtracting the trace's `baseTimeNanoseconds / 1000` from each event's
`ts` puts the spans of every thread beside the device's kernels and copies.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function


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


class Span:
    """One recorded span: its name, start and end (time.perf_counter_ns),
    the native id of its thread, the id of the span that encloses it in
    that thread (None at the thread's top), the id of its request (None
    outside one) and its counts."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent", "request", "counts", "child_ns")

    def __init__(self, id: int, name: str, thread: int, parent: Optional[int], request: Optional[int]):
        self.id, self.name, self.thread, self.parent, self.request = id, name, thread, parent, request
        self.counts: Dict[str, int] = {}
        self.start_ns = self.end_ns = 0
        self.child_ns = 0  # the part of the span that its children cover

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_seconds(self) -> float:
        """The span's duration less the part of it that its children cover."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e9


#: per thread: `stack`, its open spans (innermost last), and `request`, its request id
_local = threading.local()
#: every span recorded and ended, in the order they ended
_spans: List[Span] = []
_ids = itertools.count(1)
_requests = itertools.count(1)
_offset_ns: Optional[int] = None  # Unix time less perf_counter, sampled once


def span(name: str, request: bool = False, record: bool = False):
    """A context manager that records a span named `name` while a torch
    profiler runs (or always, with `record`) and yields the Span, or
    yields None and costs one attribute read. Spans nest per thread; one
    opened with `request=True` outside a request starts a new request id,
    which every span of its thread takes until it ends (and
    prefetch_iterator carries into its worker). On the main thread a
    recorded span runs inside a `record_function(name)`, so that it shows
    by name in the profiler's trace; its own interval excludes that
    record_function's enter and exit."""
    if not (record or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, request)


def count(name: str, n: int) -> None:
    """Add n to the count `name` of this thread's innermost open span,
    while a torch profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + int(n)


def spans() -> List[Span]:
    """Every span recorded and ended, in the order they ended."""
    return list(_spans)


def reset() -> None:
    _spans.clear()


def chrome_events() -> List[dict]:
    """Every recorded span as a Chrome trace "X" event: ts and dur in
    microseconds of Unix time, tid the thread, args its id, request,
    parent and counts."""
    off, pid = _offset_ns or 0, os.getpid()
    return [{"name": s.name, "cat": "program_span", "ph": "X", "pid": pid, "tid": s.thread,
             "ts": (s.start_ns + off) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "request": s.request, "parent": s.parent, "counts": dict(s.counts)}}
            for s in _spans]


class _Open:
    """An open span: entered, it records; exited, it ends."""

    __slots__ = ("name", "request", "span", "rf", "owns_request")

    def __init__(self, name: str, request: bool):
        self.name, self.request = name, request

    def __enter__(self) -> Span:
        global _offset_ns
        if _offset_ns is None:
            _offset_ns = time.time_ns() - time.perf_counter_ns()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = getattr(_local, "request", None)
        self.owns_request = self.request and outer is None
        if self.owns_request:
            outer = _local.request = next(_requests)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled and threading.current_thread() is threading.main_thread():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        s = self.span = Span(next(_ids), self.name, threading.get_native_id(),
                             stack[-1].id if stack else None, outer)
        stack.append(s)
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end_ns = time.perf_counter_ns()
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += s.end_ns - s.start_ns
        _spans.append(s)
        if self.owns_request:
            _local.request = None
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


class PhaseTimers:
    """Wall seconds by phase (counterpart of slacken_tpu/utils.py's
    PhaseTimers, which STPU_BUILD_TRACE turns on there): `with
    timers.phase(name):` is a `span`, and its self time (the
    block's wall less that of the spans inside it) adds to
    `seconds[name]`, so the walls add up to the whole. Enabled, it records
    whether or not a profiler runs, and with `device` (a torch device) each
    phase starts and ends by waiting for the device's queued work, so that
    device work counts in the phase that queued it. Disabled (the default),
    a phase is an ordinary span: recorded only under a profiler, with no
    wait on the device."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.device = device
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.enabled and self.device is not None and getattr(self.device, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name, record=self.enabled) as s:
            if s is not None:
                self._sync()
            try:
                yield
            finally:
                if s is not None:
                    self._sync()
        if s is not None:
            self.seconds[name] = self.seconds.get(name, 0.0) + s.self_seconds

    def timed(self, name: str, items: Iterable):
        """`items`, each step of the iteration timed under `name`."""
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
    Exceptions raised by the producer re-raise at the consumer site. The
    thread's spans take the consumer's request id; the consumer's waits are
    `input.wait` spans. Closing the generator early stops the thread (after
    the item it is producing) and closes `it`."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    error = []
    stop = threading.Event()
    request = getattr(_local, "request", None)

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        _local.request = request
        try:
            for x in it:
                if not put(x):
                    break
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            error.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="stpu-prefetch")
    t.start()
    try:
        while True:
            with span("input.wait"):
                x = q.get()
            if x is sentinel:
                if error:
                    raise error[0]
                return
            yield x
    finally:
        stop.set()
