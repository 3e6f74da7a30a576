"""What the per-layer metric readers (``portbench/metrics/<name>.py``) share:
a kernel's launches and device time from the trace, its roofline share.
A reader that finds nothing to read returns None, and the metric is left
out of the line."""

from __future__ import annotations

import re

from portbench.counts import peaks


def kernel(trace: dict, pattern: str):
    """(launches, device seconds) of the trace's operations whose name
    matches ``pattern``."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, seconds) in trace["ops"].items():
        if rx.search(name):
            n += count
            s += seconds
    return n, s


def roofline(trace, pattern: str, cost, call_pattern=None, dtype: str = "fp32"):
    """Percent of a kernel's time that its bound takes: the bound of one call
    (``cost`` = (operations, bytes)) times the calls, over the device time of
    every launch matching ``pattern``; None when the trace holds none."""
    if not trace:
        return None
    calls, _ = kernel(trace, call_pattern or pattern)
    _, seconds = kernel(trace, pattern)
    if calls == 0 or seconds <= 0:
        return None
    return 100.0 * calls * peaks.bound_s(*cost, dtype) / seconds


def idle_percent(busy_s: float, wall_s: float):
    if wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / wall_s)


def device_ms_per(rec: dict, count: str):
    """Device busy time (the union of the intervals in which an operation
    ran on the card) per unit of work traced (``counts[count]``), in ms."""
    t, n = rec["trace"], rec["counts"].get(count, 0)
    if not t or not n:
        return None
    return 1e3 * t["busy_s"] / n


def idle_share(rec: dict, spans=None):
    """Percent of the traced window in which no operation ran on the card;
    with ``spans``, of the wall time of those spans (the calls into the
    program) instead."""
    t = rec["trace"]
    if not t:
        return None
    if spans is None:
        return idle_percent(t["busy_s"], t["window_s"])
    return idle_percent(sum(t["span_busy_s"].get(k, 0.0) for k in spans),
                        sum(t["span_s"].get(k, 0.0) for k in spans))


def mfu(flops: float, wall_s: float, dtype: str):
    """Percent of the published peak of ``dtype`` that ``flops`` over
    ``wall_s`` reach."""
    if flops <= 0 or wall_s <= 0:
        return None
    return 100.0 * flops / wall_s / peaks.FLOPS[dtype]
