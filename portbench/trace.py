"""Spans around the benchmark's calls into the program, and the reading of a
``torch.profiler`` trace: the device's busy time (the union of the intervals
in which a kernel, copy or fill ran), the idle gaps named by the span open
during them, and the device time of each kernel by name.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple

class Spans:
    """Host-clock spans by name.  ``with spans("feed"):`` adds the span's
    wall time to its name's total; while a profiler records, the span is also
    a ``record_function`` range of that name, so the trace holds it."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.recording = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.recording:
            import torch

            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self.total[name] = self.total.get(name, 0.0) + dt

    def reset(self):
        self.total.clear()


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ")[:160]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(merged: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of ``merged`` (sorted, disjoint) inside [lo, hi)."""
    i = max(0, bisect.bisect_right(merged, (lo, lo)) - 1)
    total = 0
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        total += max(0, min(e, hi) - max(s, lo))
        i += 1
    return total


def summarize(events, span_names, window_name: str = "window") -> dict:
    """The numbers a trace gives, from ``(kind, name, start_ns, end_ns)``
    events (``_events``): "kernel" for a device operation, "user_annotation"
    for a span the benchmark opened.

    Returns ``window_s`` (the span ``window_name``), ``busy_s`` (union of
    the device operations inside it), ``ops`` ({name: [count, seconds]}),
    ``span_s`` / ``span_busy_s`` ({span: wall seconds, device-busy seconds
    inside it}), ``idle_gaps`` ([[span, seconds]] of the device's idle time
    in the window by the span open at each gap's midpoint, "none" where
    none is) and ``device_ops`` (the ten names of most device time)."""
    win = [(s, e) for k, n, s, e in events if k == "user_annotation" and n == window_name]
    if not win:
        raise RuntimeError(f"trace: no '{window_name}' span")
    w0, w1 = win[0]
    dev, ops = [], {}
    spans = []
    for kind, name, s, e in events:
        if kind == "kernel":
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            dev.append((s, e))
            short = short_name(name)
            c = ops.setdefault(short, [0, 0.0])
            c[0] += 1
            c[1] += (e - s) / 1e9
        elif kind == "user_annotation" and name in span_names and s < w1 and e > w0:
            spans.append((max(s, w0), min(e, w1), name))
    merged = union(dev)
    busy = sum(e - s for s, e in merged)
    span_s: Dict[str, float] = {}
    span_busy: Dict[str, float] = {}
    for s, e, name in spans:
        span_s[name] = span_s.get(name, 0.0) + (e - s) / 1e9
        span_busy[name] = span_busy.get(name, 0.0) + overlap(merged, s, e) / 1e9
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1  # the benchmark's spans do not nest
        name = spans[i][2] if i >= 0 and spans[i][1] > mid else "none"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "ops": ops,
        "span_s": span_s,
        "span_busy_s": span_busy,
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
        "device_ops": sorted(([k, v[1]] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
    }


class Tracer:
    """One ``torch.profiler`` recording of a part of the window, on demand.
    ``begin`` and ``end`` return the seconds they took, which the window
    leaves out of its time; the trace is read after the window
    (``summary``)."""

    def __init__(self, spans: Spans, enabled: bool):
        self.spans = spans
        self.enabled = enabled
        self._prof = self._win = self._done = None
        self._summary: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def pending(self) -> bool:
        """Enabled and not yet recorded."""
        return self.enabled and self._prof is None and self._done is None

    def begin(self) -> float:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._win = record_function("window")
        self._win.__enter__()
        self.spans.recording = True
        return time.perf_counter() - t0

    def end(self, span_names) -> float:
        if self._prof is None:
            return 0.0
        import torch

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self.spans.recording = False
        self._win.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._names, self._prof = self._prof, set(span_names), None
        return time.perf_counter() - t0

    @property
    def summary(self) -> Optional[dict]:
        if self._summary is None and self._done is not None:
            self._summary = summarize(_events(self._done, self._names), self._names)
            self._done = True
        return self._summary


def _events(prof, span_names):
    """(kind, name, start_ns, end_ns) of every event of a finished profile:
    "user_annotation" for the host side of the benchmark's spans,
    "gpu_user_annotation" for their device side, "kernel" for every other
    device operation (kernels, copies, fills), "cpu_op" for the rest."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = set(span_names) | {"window"}
    out = []
    for e in prof.profiler.kineto_results.events():
        name, on_device = e.name(), e.device_type() == cuda
        if name in names:
            kind = "gpu_user_annotation" if on_device else "user_annotation"
        else:
            kind = "kernel" if on_device else "cpu_op"
        if hasattr(e, "start_ns"):
            t0, dt = e.start_ns(), e.duration_ns()
        else:
            t0, dt = e.start_us() * 1000, e.duration_us() * 1000
        out.append((kind, name, t0, t0 + dt))
    return out
