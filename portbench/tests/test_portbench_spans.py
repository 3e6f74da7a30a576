"""``portbench.tools.spans``: the program's spans read beside the trace.

On synthetic spans and events: the idle gaps named by the chain of spans
open at their midpoints, whose sums per benchmark span are the gaps
``trace.summarize`` names; the readings of each cell's spans, and none
without spans; the window's spans.  Under a CPU-only profile: the clock
map fit to the benchmark's spans puts a program span opened inside a
``record_function`` range inside that range, within 20 us.
"""

from __future__ import annotations

import time

import pytest

from portbench import trace
from portbench.tools import spans as ts

MS = 1_000_000


def _span(name, sid, parent, t0, t1, key=-1):
    return (name, sid, parent, key, t0, t1)


def test_idle_gaps_named_by_the_chain_of_open_spans():
    ev = [("user_annotation", "window", 0, 100 * MS),
          ("user_annotation", "feed", 10 * MS, 40 * MS),
          ("user_annotation", "wait", 40 * MS, 60 * MS),
          ("kernel", "gemm", 14 * MS, 20 * MS),
          ("kernel", "copy", 30 * MS, 32 * MS),
          ("kernel", "late", 90 * MS, 120 * MS)]
    spans = [_span("feed", 0, -1, 10 * MS, 40 * MS),
             _span("mux.tick", 1, 0, 11 * MS, 36 * MS),
             _span("mux.pack", 2, 1, 11 * MS, 13 * MS),
             _span("graphs.replay", 3, 1, 13 * MS, 14 * MS, "step"),
             _span("mux.copy_out", 4, 1, 21 * MS, 32 * MS),
             _span("wait", 5, -1, 40 * MS, 60 * MS)]
    identity = ts.ClockMap([(0, 0, 1), (100 * MS, 100 * MS, -1)])
    gaps = dict(ts.chain_gaps(ev, spans, identity, {"feed", "wait"}))
    # 0-14 (mid 7) none, 20-30 (mid 25) in the copy out, 32-90 (mid 61) none
    assert gaps == pytest.approx({"none": 0.014 + 0.058, "feed/mux.tick/mux.copy_out": 0.010})
    assert ts.chain_at(12 * MS, *_index(spans)) == "feed/mux.tick/mux.pack"
    assert ts.chain_at(37 * MS, *_index(spans)) == "feed"
    assert ts.chain_at(50 * MS, *_index(spans)) == "wait"
    assert ts.chain_at(70 * MS, *_index(spans)) == "none"
    # a gap inside a benchmark span's range but in none of the program's
    # spans keeps the benchmark's name
    late = ev + [("kernel", "k", 33 * MS, 37 * MS), ("kernel", "k", 39 * MS, 95 * MS)]
    gaps_late = dict(ts.chain_gaps(late, spans, identity, {"feed", "wait"}))
    assert gaps_late == pytest.approx({"none": 0.014, "feed/mux.tick/mux.copy_out": 0.010,
                                       "feed/mux.tick": 0.001, "feed": 0.002})
    # summed over each chain's first name, the benchmark's own naming
    first = {}
    for chain, v in gaps.items():
        first[chain.split("/")[0]] = first.get(chain.split("/")[0], 0.0) + v
    summary = trace.summarize(ev, {"feed", "wait"})
    assert first == pytest.approx(dict(summary["idle_gaps"]))


def _index(spans):
    ordered = sorted(spans, key=lambda s: s[4])
    return [s[4] for s in ordered], ordered, {s[1]: s for s in spans}


def test_readings_of_each_cell_and_none_without_spans():
    mux = [_span("mux.tick", 0, -1, 0, 5 * MS),
           _span("mux.copy_out", 1, 0, 1 * MS, 4 * MS),
           _span("mux.tick", 2, -1, 10 * MS, 12 * MS),
           _span("mux.copy_out", 3, 2, 11 * MS, 11 * MS + 500_000),
           _span("mux.admit", 4, -1, 20 * MS, 27 * MS, 3)]
    assert ts.readings(mux, "mux_live") == pytest.approx({"tick_host_ms.live": 1.75,
                                                          "admit_ms.live": 7.0})
    assert ts.readings(mux[:4], "mux_live") == pytest.approx({"tick_host_ms.live": 1.75})
    offline = [_span("graphs.params_sync", 0, -1, 0, 300_000),
               _span("graphs.copy_in", 1, -1, 300_000, 400_000, "forward"),
               _span("graphs.replay", 2, -1, 400_000, 600_000, "forward"),
               _span("graphs.params_sync", 3, -1, MS, MS + 500_000),
               _span("graphs.copy_in", 4, -1, 2 * MS, 2 * MS + 100_000, "forward"),
               _span("graphs.replay", 5, -1, 3 * MS, 3 * MS + 200_000, "forward"),
               _span("graphs.replay", 6, -1, 4 * MS, 9 * MS, "other")]
    assert ts.readings(offline, "offline") == pytest.approx(
        {"launch_host_ms.offline": 0.3, "params_sync_ms.offline": 0.4})
    train = [_span("graphs.copy_in", 0, -1, 0, 1 * MS, "train_step"),
             _span("graphs.replay", 1, -1, 1 * MS, 3 * MS, "train_step")]
    assert ts.readings(train, "train") == pytest.approx({"launch_host_ms.train": 3.0})
    for kind in ("mux_live", "offline", "train"):
        assert ts.readings([], kind) == {}


def test_window_spans_end_with_the_benchmarks_last_span():
    spans = [_span("mux.tick", 0, 1, 2, 5), _span("feed", 1, -1, 1, 6),
             _span("mux.tick", 2, -1, 8, 9)]  # after the window: the correctness check
    kept, window = ts.window_spans(spans, {"feed"})
    assert kept == spans[:2] and window == (1, 6)
    assert ts.window_spans(spans[::2], {"feed"}) == ([], None)
    assert ts.outside(spans, 5, 7) == [spans[2]]
    assert ts.inside(spans, 0, 7) == spans[:2]


def test_clock_map_takes_the_ranges_lag_apart_from_the_clocks():
    # the trace's clock: 7 ms ahead and 20 ppm fast; each range's start read
    # by the trace 3 us before the host, its end 3 us after
    def trace_of(h):
        return 7 * MS + round(h * 1.00002)

    readings = []
    for i in range(50):
        h0, h1 = 10 * MS * i + 100, 10 * MS * i + 2 * MS
        readings += [(h0, trace_of(h0) - 3000, 1), (h1, trace_of(h1) + 3000, -1)]
    cmap = ts.ClockMap(readings)
    assert cmap.lag == pytest.approx(3000, abs=1)
    for h in (0, 123_456_789, 490 * MS):
        assert abs(cmap.to_trace(h) - trace_of(h)) <= 2
        assert abs(cmap.to_host(trace_of(h)) - h) <= 2
    assert max(cmap.error_us(readings)) < 0.01
    both = ts.ClockMap(readings[:2])  # two readings: the line through both
    assert both.lag == 0 and both.to_trace(readings[1][0]) == readings[1][1]
    launches = [("cpu_op", "cudaGraphLaunch", trace_of(3 * MS), trace_of(3 * MS + 50_000)),
                ("cpu_op", "cudaGraphLaunch", trace_of(9 * MS), trace_of(9 * MS + 50_000)),
                ("kernel", "gemm", trace_of(3 * MS + 250_000), trace_of(4 * MS)),
                ("kernel", "gemm", trace_of(9 * MS + 150_000), trace_of(10 * MS))]
    replays = [_span("graphs.replay", 0, -1, 3 * MS - 1000, 3 * MS + 60_000, "step"),
               _span("graphs.replay", 1, -1, 9 * MS + 20_000, 9 * MS + 60_000, "step")]
    check = ts.launch_check(launches, replays, cmap)
    assert check["launches"] == 2 and check["inside_share"] == 0.5
    assert check["outside_max_us"] == pytest.approx(20, abs=0.01)
    assert check["to_device_us_p50"] == pytest.approx(150, abs=0.1)
    assert ts.launch_check(launches[2:], replays, cmap) == {}


def test_clock_map_puts_a_program_span_inside_its_range_under_a_cpu_profile(monkeypatch):
    import torch

    from cleanumamba_tpu_torch import tracing

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    bench = ts.RecordedSpans()
    tracer = ts.AnchoredTracer(bench, True)
    bench.reset()
    try:
        tracer.begin()
        for _ in range(30):
            with bench("feed"):
                with tracing.span("mux.tick"):
                    sum(range(2000))
            with bench("wait"):
                time.sleep(0.002)
        tracer.end(("feed", "wait"))
    finally:
        spans = tracing.stop()
    assert tracer.summary is not None and len(tracer.anchors) == 2
    pairs = ts.span_pairs(tracer.events, ts.inside(spans, *tracer.anchors), bench.names)
    assert len(pairs) == 120
    cmap = ts.ClockMap(pairs)
    feeds = sorted((s, e) for k, n, s, e in tracer.events if k == "user_annotation"
                   and n == "feed")
    ticks = sorted(s for s in spans if s[0] == "mux.tick")
    assert len(feeds) == len(ticks) == 30
    for (a, b), t in zip(feeds, sorted(ticks, key=lambda s: s[4])):
        assert cmap.to_trace(t[4]) >= a - 20_000
        assert cmap.to_trace(t[5]) <= b + 20_000
