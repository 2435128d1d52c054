"""The port's own spans and counters, read in the benchmark's process: the
recorder of slacken_tpu_torch.utils, which records while a torch profiler
runs. The recorder holds every span since the process started, so a
reader keeps those of the traced requests: the last len(context["traced"])
request ids (ids only increase, and only profiled requests take one). A
program without that recorder gives no spans, and every reader of them then
returns None."""

from __future__ import annotations

from typing import Iterable, List, Optional


def recorded(context: dict, names: Optional[Iterable[str]] = None) -> list:
    """The program's spans of the traced requests (those named in `names`,
    if given)."""
    from slacken_tpu_torch import utils

    get = getattr(utils, "spans", None)
    found = list(get()) if callable(get) else []
    n = len(context.get("traced") or ())
    requests = set(sorted({s.request for s in found if s.request is not None})[-n:]) if n else set()
    found = [s for s in found if s.request in requests]
    if names is not None:
        names = set(names)
        found = [s for s in found if s.name in names]
    return found


def busy_pct(context: dict, names: Iterable[str]) -> Optional[float]:
    """The seconds of the spans named `names` over the traced stretch (%);
    the names must not nest in one another."""
    r = context.get("reading")
    found = recorded(context, names)
    if r is None or r.window_s <= 0 or not found:
        return None
    return 100.0 * sum((s.end_ns - s.start_ns) / 1e9 for s in found) / r.window_s


def total(found: List, counter: str) -> int:
    """The counter `counter` summed over the spans `found`."""
    return sum(s.counts.get(counter, 0) for s in found)


def reads(context: dict) -> int:
    """Reads classified in the traced requests."""
    return total(recorded(context, ["classify.request"]), "reads")


def per_read(context: dict, counter: str) -> Optional[float]:
    """The counter `counter`, summed over every span of the traced
    requests, per read classified."""
    n = reads(context)
    return total(recorded(context), counter) / n if n else None
