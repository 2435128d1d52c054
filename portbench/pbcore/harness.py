"""One run of one cell: set-up, a closed loop of requests from one client
for the window, the check against the plain reference, and the result
line. The cell's traffic file names a traffic kind (portbench/kinds/<kind>.py)
whose `Traffic` makes the inputs from the seed, sets up the system under
test, serves one request, and compares the outputs that the window produced.
"""

from __future__ import annotations

import gc
import importlib
import json
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from . import guard, manifest
from .host import HostWatch
from .trace import Tracer, warm_up

#: the traced stretch starts with the first request after this share of the window
TRACE_START = 0.4


class Memory:
    """The device's allocation peak over the run, across the resets that a
    request's own peak needs."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.peak = 0
        self.win = 0  # the window's peak across those resets

    def request_peak(self, fn):
        """fn's peak above what was allocated before it (0 off the card)."""
        if not self.cuda:
            fn()
            return 0
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        self.win = max(self.win, torch.cuda.max_memory_allocated())
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        self.peak = max(self.peak, top)
        self.win = max(self.win, top)
        return top - before

    def window_start(self) -> None:
        """Start the window's own peak (the set-up's stays in the run's)."""
        if self.cuda:
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            self.win = 0

    def window_peak(self) -> int:
        """The allocation peak since window_start (0 off the card): what the
        index and the requests held on the card at once."""
        return max(self.win, torch.cuda.max_memory_allocated()) if self.cuda else 0

    def run_peak(self) -> int:
        return max(self.peak, torch.cuda.max_memory_allocated()) if self.cuda else 0


class Context:
    """What a traffic kind gets: the cell, the seed, the device, a work directory
    (removed at the end of the run), the memory tracker, whether the run
    traces, and `control`: 0, or the key bits that the control's reference
    drops when it serves in the program's place (portbench/control.py)."""

    def __init__(self, cell: manifest.Cell, seed: int, device, workdir: str, memory: Memory, trace: bool,
                 control: int = 0):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.workdir, self.memory, self.trace, self.control = workdir, memory, trace, control


def traffic_class(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}").Traffic


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        bench_dir: str = manifest.BENCH_DIR, control: int = 0) -> dict:
    """Run the cell and return the result line's object. `t_start`: the
    process's start on the clock of time.perf_counter, where set-up begins."""
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(cell, seed, seconds, trace, device, t_start, workdir, bench_dir, control)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, workdir, bench_dir, control) -> dict:
    host = HostWatch()
    memory = Memory(device)
    ctx = Context(cell, seed, device, workdir, memory, trace, control)
    drv = traffic_class(cell.traffic["kind"])(ctx)
    drv.setup()
    cuda = ctx.device.type == "cuda"
    if trace and cuda:
        warm_up()
    gc.collect()  # the set-up's garbage is the set-up's to collect, not the window's
    gc.freeze()  # and its objects are not walked again by the window's collections
    if cuda:
        torch.cuda.synchronize()
    memory.window_start()
    host.window_start()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    done: List[dict] = []
    attempted = failed = 0
    tracer: Optional[Tracer] = None
    traced: List[int] = []
    n_traced = int(cell.traffic.get("trace_requests", 1))
    last = t0
    while time.perf_counter() - t0 < seconds:
        i = attempted
        attempted += 1
        profiled = trace and cuda and tracer is None and time.perf_counter() - t0 >= TRACE_START * seconds
        if profiled:
            tracer = Tracer(workdir)
            tracer.__enter__()
        if tracer is not None and tracer.reading is None and len(traced) < n_traced:
            traced.append(i)
        try:
            units = drv.request(i, traced=i in traced)
        except Exception as e:  # a failed request is counted and reported, and the run is not correct
            failed += 1
            print(f"portbench: request {i} failed: {e!r}", file=sys.stderr)
            units = None
        if cuda:
            torch.cuda.synchronize()
        last = time.perf_counter()
        if units is not None:
            done.append({"i": i, "units": units, "end": last - t0})
        if tracer is not None and tracer.reading is None and len(traced) >= n_traced and i == traced[-1]:
            tracer.__exit__(None, None, None)
    if tracer is not None and tracer.reading is None:
        tracer.__exit__(None, None, None)
    elapsed = last - t0
    host_info = host.window_end()
    gc.unfreeze()
    window_peak = memory.window_peak()
    peak = memory.run_peak()
    ends = [0.0] + [d["end"] for d in done]
    print(f"portbench: set-up {setup_s:.3f} s; window {elapsed:.3f} s, {len(done)} of {attempted} requests done; "
          f"request walls {[round(b - a, 3) for a, b in zip(ends, ends[1:])]}",
          file=sys.stderr, flush=True)
    print(f"portbench: host {json.dumps(host_info)}", file=sys.stderr, flush=True)
    drv.close_window(done)
    t_check = time.perf_counter()
    checks = drv.check()
    print(f"portbench: check {time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
    correct = failed == 0 and bool(done) and all(v <= lim for _, v, lim in checks)
    found = guard.loaded()
    if found:
        raise guard.Forbidden(found)
    if trace:
        metrics = _layer_metrics(cell, drv, tracer, traced, bench_dir, drv.end_to_end(done, elapsed))
    else:
        metrics = drv.end_to_end(done, elapsed)
        metrics["setup_s"] = setup_s
        metrics["window_peak_gib"] = window_peak / 2**30
        print(f"portbench: end to end {json.dumps(metrics)}", file=sys.stderr, flush=True)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if v is not None and k in units},
        "device": device_info(device, peak),
    }
    if trace and tracer is not None and tracer.reading is not None:
        result["device"]["busy_s"] = tracer.reading.busy_s
        result["device"]["window_s"] = tracer.reading.window_s
        result["breakdown"] = tracer.reading.breakdown()
    result["host"] = host_info
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def _layer_metrics(cell, drv, tracer, traced, bench_dir, window: dict) -> Dict[str, Optional[float]]:
    """Each per-layer metric of the cell, from its reader; None where the
    reader found nothing to read. `window`: the traffic kind's rates over
    the whole window of this (traced) run."""
    context = {"reading": tracer.reading if tracer is not None else None, "traced": traced, "window": window}
    context.update(drv.layer_context(traced))
    return {name: read(context) for name, read in manifest.readers(cell.per_layer, bench_dir).items()}


def device_info(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": peak}


def print_result(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    print(f"correct: {str(result['correct']).lower()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
