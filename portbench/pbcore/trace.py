"""The traced stretch of a run: torch.profiler over whole requests, read
from its Chrome trace. Device busy time is the union of the kernel, copy
and set intervals (overlapping copies and kernels count once), clipped to
the stretch; each idle gap is named by the innermost span of the
benchmark's own (record_function, prefix SPAN) that covers its middle."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN = "portbench:"
WINDOW = SPAN + "traced stretch"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A span of the benchmark's own around a call into the program."""
    return record_function(SPAN + name)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Reading:
    """What a traced stretch showed: busy_s and window_s (seconds), device
    seconds by operation name, and idle seconds by what the host was doing."""

    def __init__(self, busy_s: float, window_s: float, device_ops: Dict[str, float],
                 idle_gaps: Dict[str, float]):
        self.busy_s, self.window_s = busy_s, window_s
        self.device_ops, self.idle_gaps = device_ops, idle_gaps

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]  # noqa: E731
        return {"device_ops": top(self.device_ops), "idle_gaps": top(self.idle_gaps)}


def idle_pct(reading: Optional[Reading]) -> Optional[float]:
    """The device's idle share of a traced stretch (%), None without a
    stretch or device time."""
    if reading is None or reading.window_s <= 0 or reading.busy_s <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)


def read_trace(events: List[dict]) -> Reading:
    """Reduce a Chrome trace's events to a Reading. The stretch is the
    WINDOW span; without one, the extent of the device events."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    spans = [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(SPAN)]
    win = [e for e in spans if e["name"] == WINDOW]
    if win:
        w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    elif dev:
        w0 = min(float(e["ts"]) for e in dev)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    else:
        return Reading(0.0, 0.0, {}, {})
    busy = union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev
                  if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0])
    busy_us = sum(b - a for a, b in busy)
    ops: Dict[str, float] = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    inner = [e for e in spans if e["name"] != WINDOW]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        covering = [e for e in inner if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = (min(covering, key=lambda e: float(e["dur"]))["name"][len(SPAN):] if covering
                 else "between requests")
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return Reading(busy_us / 1e6, (w1 - w0) / 1e6, ops, gaps)


def warm_up() -> None:
    """One short profile, so that the profiler's and CUPTI's
    first-use start-up falls in set-up and not in the traced stretch."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with span("profiler warm-up"):
            torch.ones(1 << 20, device="cuda").cumsum(0)
        torch.cuda.synchronize()


class Tracer:
    """Profiles what runs inside `with tracer:`; `reading` after it."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "trace.json")
        self.reading: Optional[Reading] = None

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._win = record_function(WINDOW)
        self._win.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                events = json.load(f).get("traceEvents", [])
            os.remove(self.path)
            self.reading = read_trace(events)
        return False
