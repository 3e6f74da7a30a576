"""A cell's traced run with the program's own spans recorded: where the
host's time goes inside the benchmark's calls.

    python -m portbench.tools.spans --workload e8-mux-live --seed 7 --seconds 20

Runs the cell as ``python -m portbench.run --trace 1`` does (set-up, the
window with its profiled slice, the output check, the per-layer metrics
read by the same readers), with the program's recorder
(``cleanumamba_tpu_torch.tracing``) on from the window's start, and the
benchmark's spans recorded by it too, so that the program's spans nest
inside them.  Prints one JSON line: the run's result, and ``spans``:

- ``metrics``: readings of the program's spans, each a mean over the
  window's spans that do not overlap the profiled slice (where the
  profiler slows the host), for the cells that record them:
  ``tick_host_ms.live`` (a ``mux.tick``'s wall less its ``mux.copy_out``'s:
  packing, the input copy, the replay's launch, the hand-out),
  ``admit_ms.live`` (a ``mux.admit``'s wall), ``params_sync_ms.offline`` (a
  ``graphs.params_sync``'s wall), ``launch_host_ms.offline`` and
  ``launch_host_ms.train`` (a call's ``graphs.copy_in`` and
  ``graphs.replay`` walls, over the replays of the cell's graph);
- ``span_ms``: each span name's count and mean wall, on the same spans;
- ``idle_gaps``: the device's idle time in the profiled slice by the
  benchmark's span open at each gap's midpoint (as ``trace.summarize``
  names it; ``none`` outside them) and the chain of the program's spans
  open there, joined by ``/`` (``feed/mux.tick/mux.copy_out``);
  ``slice_span_ms``: the spans' count and mean wall inside the slice,
  where the profiler slows the host;
- ``clock_fit_us``: the spans are mapped onto the profiler's clock by a
  line fit by least squares to both ends of every benchmark span of the
  profiled slice against its ``record_function`` range, with the host's
  mean distance from the trace's reading at a range's ends
  (``clock_lag_us``: the range's own cost) fit beside it; the error is the
  (largest, 99th percentile, median) residual.  ``anchors_fit_us``: the
  same readings under the line through the ``window`` range's two ends
  alone, read just after it is entered and just before it is left;
- ``launches``: each ``cudaGraphLaunch`` of the slice, mapped: the share
  inside a ``graphs.replay`` span, the farthest outside one, and the time
  from its return to the next device operation (``launches_anchors``:
  under the two-end line);
- ``span_ns``: a span's enter and exit on this host, recorder off and on,
  and the empty loop around them;
- ``counts``: spans by name in the window, ``graphs.capture`` spans in the
  window, spans dropped by a full store.

Set-up, the window and the check run as in a traced run; the recorder
costs the host a fraction of a microsecond a span (``span_ns``).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time

import numpy as np

from portbench import trace

NAME, ID, PARENT, KEY, T0, T1 = range(6)

# by driver: the launch reading and the tag of the graph whose calls it reads
LAUNCH = {"offline": ("launch_host_ms.offline", "forward"),
          "train": ("launch_host_ms.train", "train_step")}


class RecordedSpans(trace.Spans):
    """The benchmark's spans, each also a span of the program's recorder
    (inside its ``record_function`` range); ``reset`` (the window's start)
    starts the recorder."""

    def __init__(self):
        super().__init__()
        self.names = set()

    @contextlib.contextmanager
    def __call__(self, name: str):
        from cleanumamba_tpu_torch import tracing

        self.names.add(name)
        with super().__call__(name), tracing.span(name):
            yield

    def reset(self):
        from cleanumamba_tpu_torch import tracing

        super().reset()
        tracing.start()


class _ReadClockOnExit:
    """A ``record_function`` range whose exit first reads the host clock."""

    def __init__(self, rf, out: list):
        self.rf, self.out = rf, out

    def __exit__(self, *exc):
        self.out.append(time.perf_counter_ns())
        return self.rf.__exit__(*exc)


class AnchoredTracer(trace.Tracer):
    """The benchmark's tracer, reading the host clock just after the
    ``window`` range is entered and just before it is left (``anchors``),
    and keeping the trace's events (``events``)."""

    def __init__(self, spans, enabled: bool):
        super().__init__(spans, enabled)
        self.anchors = []
        self.events = None

    def begin(self) -> float:
        paused = super().begin()
        self.anchors.append(time.perf_counter_ns())
        self._win = _ReadClockOnExit(self._win, self.anchors)
        return paused

    @property
    def summary(self):
        if self._summary is None and self._done is not None:
            self.events = trace._events(self._done, self._names)
            self._summary = trace.summarize(self.events, self._names)
            self._done = True
        return self._summary


class ClockMap:
    """Host ``perf_counter_ns`` <-> the trace's clock, ``k = k0 + off +
    scale * (h - h0)``, fit by least squares to readings ``(h, k, side)``.
    ``side`` is +1 where the host read its clock just after the trace's
    reading (a range's start), -1 just before it (its end), 0 where the
    two are taken as one instant; with both sides the fit takes ``lag``,
    the host's mean distance from the trace's reading, as a third unknown,
    so that the cost of entering and leaving a ``record_function`` range
    is not read as the clocks' error.  Two readings: the line through
    both."""

    def __init__(self, readings):
        self.h0, self.k0 = readings[0][0], readings[0][1]
        x = np.array([h - self.h0 for h, _, _ in readings], np.float64)
        y = np.array([k - self.k0 for _, k, _ in readings], np.float64)
        side = np.array([d for _, _, d in readings], np.float64)
        cols = [np.ones_like(x), x]
        if len(readings) > 2 and (side > 0).any() and (side < 0).any():
            cols.append(side)
        coef = np.linalg.lstsq(np.stack(cols, 1), y, rcond=None)[0]
        self.off, self.scale = float(coef[0]), float(coef[1])
        self.lag = -float(coef[2]) if len(coef) > 2 else 0.0

    def to_trace(self, h: int) -> int:
        return self.k0 + round(self.off + (h - self.h0) * self.scale)

    def to_host(self, k: int) -> int:
        return self.h0 + round((k - self.k0 - self.off) / self.scale)

    def error_us(self, readings):
        """(largest, 99th percentile, median) distance in microseconds
        between a reading in the trace and the host's reading mapped (its
        side's lag taken off)."""
        errs = np.array([abs(self.to_trace(h) - self.lag * d - k) / 1e3
                         for h, k, d in readings])
        return [float(errs.max()), float(np.percentile(errs, 99)), float(np.median(errs))]


def window_spans(spans, bench_names):
    """The spans from the recorder's start to the end of the benchmark's
    last span (after it the harness's correctness check runs), and the window's (start,
    end): the earliest span's start, the last benchmark span's end."""
    ends = [s[T1] for s in spans if s[NAME] in bench_names]
    if not ends:
        return [], None
    end = max(ends)
    kept = [s for s in spans if s[T1] <= end]
    return kept, (min(s[T0] for s in kept), end)


def outside(spans, lo: float, hi: float):
    """The spans that do not overlap [lo, hi]."""
    return [s for s in spans if s[T1] < lo or s[T0] > hi]


def inside(spans, lo: float, hi: float):
    """The spans that lie within [lo, hi]."""
    return [s for s in spans if lo <= s[T0] and s[T1] <= hi]


def _mean_ms(values):
    return 1e-6 * sum(values) / len(values) if values else None


def readings(spans, kind: str) -> dict:
    """The per-layer readings of ``spans`` for a cell of driver ``kind``
    (``mux_live``, ``offline``, ``train``); a reading with no span of its
    kind is left out."""
    mean_ms = {k: v[1] for k, v in span_walls(spans).items()}
    out = {}
    if kind == "mux_live":
        ticks = {s[ID]: s[T1] - s[T0] for s in spans if s[NAME] == "mux.tick"}
        for s in spans:
            if s[NAME] == "mux.copy_out" and s[PARENT] in ticks:
                ticks[s[PARENT]] -= s[T1] - s[T0]
        out["tick_host_ms.live"] = _mean_ms(list(ticks.values()))
        out["admit_ms.live"] = mean_ms.get("mux.admit")
    else:
        name, tag = LAUNCH[kind]
        calls = sum(1 for s in spans if s[NAME] == "graphs.replay" and s[KEY] == tag)
        host = sum(s[T1] - s[T0] for s in spans
                   if s[NAME] in ("graphs.copy_in", "graphs.replay") and s[KEY] == tag)
        out[name] = 1e-6 * host / calls if calls else None
        if kind == "offline":
            out["params_sync_ms.offline"] = mean_ms.get("graphs.params_sync")
    return {k: v for k, v in out.items() if v is not None}


def span_walls(spans) -> dict:
    """{name: [count, mean wall ms]}."""
    wall = {}
    for s in spans:
        wall.setdefault(s[NAME], []).append(s[T1] - s[T0])
    return {k: [len(v), _mean_ms(v)] for k, v in sorted(wall.items())}


def chain_at(t: float, starts, ordered, by_id) -> str:
    """The names of the spans open at host time ``t``, outermost first,
    joined by ``/``; "none" where no span is open.  ``ordered``: the spans
    by start (``starts`` their starts).  Spans of one thread nest, so the
    spans open at ``t`` are the last span started by then and its
    ancestors, less those that have ended."""
    i = bisect.bisect_right(starts, t) - 1
    s = ordered[i] if i >= 0 else None
    while s is not None and not s[T0] <= t < s[T1]:
        s = by_id.get(s[PARENT])
    names = []
    while s is not None:
        names.append(s[NAME])
        s = by_id.get(s[PARENT])
    return "/".join(reversed(names)) or "none"


def chain_gaps(events, spans, cmap: ClockMap, bench_names, window_name: str = "window"):
    """The device's idle time inside the trace's ``window`` range, by the
    benchmark's span open at each gap's midpoint in the trace ("none"
    where none is: ``trace.summarize``'s name of the gap) and after it the
    chain of the program's spans open there, mapped by ``cmap``:
    [[name, seconds]], the largest first."""
    w0, w1 = next((s, e) for k, n, s, e in events
                  if k == "user_annotation" and n == window_name)
    busy = trace.union([(max(s, w0), min(e, w1)) for k, _, s, e in events
                        if k == "kernel" and min(e, w1) > max(s, w0)])
    bench = sorted((max(s, w0), min(e, w1), n) for k, n, s, e in events
                   if k == "user_annotation" and n in bench_names and s < w1 and e > w0)
    bench_starts = [b[0] for b in bench]
    ordered = sorted((s for s in spans if s[NAME] not in bench_names), key=lambda s: s[T0])
    starts = [s[T0] for s in ordered]
    by_id = {s[ID]: s for s in ordered}
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(bench_starts, mid) - 1
        name = bench[i][2] if i >= 0 and bench[i][1] > mid else "none"
        inner = chain_at(cmap.to_host(mid), starts, ordered, by_id)
        if inner != "none":
            name = f"{name}/{inner}"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e9
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])


def span_pairs(events, spans, names):
    """Readings ``(host, trace, side)`` of both ends of each span of
    ``spans`` named in ``names`` (the benchmark's, of the profiled slice:
    each opened just inside its ``record_function`` range) against that
    range in the trace, matched in order; None where the two lists
    differ."""
    mine = sorted((s for s in spans if s[NAME] in names), key=lambda s: s[T0])
    ranges = sorted((s, e, n) for k, n, s, e in events if k == "user_annotation" and n in names)
    if not mine or [s[NAME] for s in mine] != [n for _, _, n in ranges]:
        return None
    return [p for s, (a, b, _) in zip(mine, ranges) for p in ((s[T0], a, 1), (s[T1], b, -1))]


def launch_check(events, spans, cmap: ClockMap) -> dict:
    """Each graph launch the trace holds (``cudaGraphLaunch`` on the host),
    mapped: the share that lies inside a ``graphs.replay`` span, the
    largest distance outside one (us), and the median and 90th percentile
    of the time from the launch's return to the next device operation's
    start (us); empty where the trace holds no launch."""
    launches = sorted((s, e) for k, n, s, e in events
                      if k == "cpu_op" and n.startswith("cudaGraphLaunch"))
    replays = sorted((s[T0], s[T1]) for s in spans if s[NAME] == "graphs.replay")
    device = sorted(s for k, _, s, _ in events if k == "kernel")
    if not launches or not replays:
        return {}
    outside_us, delay_us = [], []
    for ks, ke in launches:
        hs, he = cmap.to_host(ks), cmap.to_host(ke)
        i = bisect.bisect_right(replays, (hs, hs))
        outside_us.append(min(max(0, r0 - hs, he - r1) for r0, r1 in
                              replays[max(0, i - 1):i + 1]) / 1e3)
        j = bisect.bisect_left(device, ke)
        if j < len(device):
            delay_us.append((device[j] - ke) / 1e3)
    out = {"launches": len(launches),
           "inside_share": sum(1 for d in outside_us if d == 0) / len(outside_us),
           "outside_max_us": max(outside_us)}
    if delay_us:
        out.update(to_device_us_p50=float(np.median(delay_us)),
                   to_device_us_p90=float(np.percentile(delay_us, 90)))
    return out


def report(ctx, recorded) -> dict:
    """The readings of a traced run's recorded spans (``ctx``: its context,
    with a :class:`RecordedSpans` and an :class:`AnchoredTracer`)."""
    spans, window = window_spans(recorded, ctx.spans.names)
    tr = ctx.tracer
    out = {"counts": {k: v[0] for k, v in span_walls(spans).items()},
           "captures_in_window": sum(1 for s in spans if s[NAME] == "graphs.capture")}
    if window is None or tr.events is None or len(tr.anchors) != 2:
        return out
    w0, w1 = next((s, e) for k, n, s, e in tr.events
                  if k == "user_annotation" and n == "window")
    anchors = ClockMap([(tr.anchors[0], w0, 1), (tr.anchors[1], w1, -1)])
    pairs = span_pairs(tr.events, inside(spans, *tr.anchors), ctx.spans.names)
    cmap = ClockMap(pairs) if pairs else anchors
    steady = outside(spans, *tr.anchors)
    out.update(metrics=readings(steady, ctx.workload["driver"]), span_ms=span_walls(steady),
               idle_gaps=chain_gaps(tr.events, spans, cmap, ctx.spans.names)[:16],
               slice_span_ms=span_walls(inside(spans, *tr.anchors)),
               clock_fit_us=cmap.error_us(pairs) if pairs else None,
               anchors_fit_us=anchors.error_us(pairs) if pairs else None,
               clock_pairs=len(pairs or ()), clock_lag_us=cmap.lag / 1e3,
               launches=launch_check(tr.events, inside(spans, *tr.anchors), cmap),
               launches_anchors=launch_check(tr.events, inside(spans, *tr.anchors), anchors),
               window_s=(window[1] - window[0]) / 1e9,
               slice_s=(tr.anchors[1] - tr.anchors[0]) / 1e9)
    return out


def span_cost(n: int = 100_000) -> dict:
    """Nanoseconds a ``with tracing.span(...)`` takes on this host, recorder
    off and on, and the empty loop (the best of three loops of ``n``)."""
    from cleanumamba_tpu_torch import tracing

    def loop(body):
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter_ns()
            body()
            best = min(best, (time.perf_counter_ns() - t) / n)
        return best

    def spans():
        for _ in range(n):
            with tracing.span("x", 1):
                pass

    def empty():
        for _ in range(n):
            pass

    off = loop(spans)
    tracing.start()
    try:
        on = loop(spans)
    finally:
        tracing.stop()
    return {"off": off, "on": on, "empty_loop": loop(empty)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    from portbench.run import power_limit, prepare_environment

    prepare_environment(os.getcwd())
    import torch

    from cleanumamba_tpu_torch import tracing
    from portbench.harness import Manifest, finish, make_context

    if not torch.cuda.is_available():
        print("portbench.tools.spans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"spans: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    cost = span_cost()
    manifest = Manifest()
    ctx = make_context(manifest, args.workload, args.seed, args.seconds, True,
                       torch.device("cuda:0"), t0)
    ctx.spans = RecordedSpans()
    ctx.tracer = AnchoredTracer(ctx.spans, True)
    try:
        result, lines = finish(manifest, ctx)
    finally:
        recorded, dropped = tracing.stop(), tracing.dropped()
    out = report(ctx, recorded)
    out.update(span_ns=cost, dropped=dropped)
    result["spans"] = out
    for line in lines:
        print(line, file=sys.stderr)
    print(f"spans: clock fit {out.get('clock_fit_us')} us; metrics {out.get('metrics')}",
          file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
