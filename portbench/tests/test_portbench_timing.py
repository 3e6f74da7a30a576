"""The tail over all hops and the rate as all work over all time, each on a
schedule with a stall injected; the trace's busy union and idle share on a
synthetic trace."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import common, realtime, trace
from portbench.tests import tiny
from portbench.traffic.live import Call


def _ctx(seconds):
    spans = trace.Spans()
    return SimpleNamespace(seconds=seconds, spans=spans, tracer=trace.Tracer(spans, False))


def test_hop_tail_carries_a_stall_to_the_hops_behind_it():
    """Two lines, a hop every 10 ms each, 5 ms apart; one feed stalls for
    60 ms: every hop due during the stall is late by what is left of it, and
    the tail over all hops sees them."""
    hop_s, stall_at, stall = 0.010, 30, 0.060
    fed = []

    def feed(handle, x):
        fed.append(handle)
        if len(fed) == stall_at:
            time.sleep(stall)
        return np.zeros(0, np.float32)

    server = SimpleNamespace(open=lambda: 0, feed=feed, finish=None, ticks=lambda: None)
    lines = [[Call(j, 200, np.zeros(200 * 4, np.float32), 0.005 * j)] for j in range(2)]
    sessions = [realtime.Session(c[0], j) for j, c in enumerate(lines)]
    res = realtime.window(_ctx(0.6), server, lines, sessions, hop_s, 3)
    lat = np.asarray(res["lat"])
    assert len(lat) == len(fed) >= 100  # open loop: every due hop was fed
    late = lat > 0.005
    # the stalled hop and the ~11 due during the stall, none of the others
    assert 8 <= late.sum() <= 16
    assert lat.max() >= stall - 0.002
    assert common.percentile(lat * 1e3, 95) > 10.0
    # the tail is over every hop: without the stall it is the feed alone
    assert common.percentile(np.sort(lat)[:-int(late.sum())] * 1e3, 95) < 5.0


def test_next_call_arrives_at_its_own_phase():
    """A line whose call ends opens the next at once, its first hop due at
    the new call's phase within the hop after the old call's next slot, plus
    the network's delay of that hop."""
    hop_s = 0.010
    fed = []

    def feed(handle, x):
        fed.append((handle, time.perf_counter()))
        return np.zeros(0, np.float32)

    handles = iter(range(10))
    server = SimpleNamespace(open=lambda: next(handles), feed=feed,
                             finish=lambda h: np.zeros(0, np.float32), ticks=lambda: 0)
    z = np.zeros(5 * 4, np.float32)
    lines = [[Call(0, 5, z, 0.007), Call(0, 5, z, 0.002),
              Call(0, 50, z, 0.009, np.linspace(0.003, 0.0, 50))]]
    sessions = [realtime.Session(lines[0][0], next(handles))]
    t0 = time.perf_counter()
    res = realtime.window(_ctx(0.12), server, lines, sessions, hop_s, 3)
    assert [len(s.outs) for s in res["done"]] == [6, 6]  # five hops and the flush
    t = {h: [at - t0 for g, at in fed if g == h] for h in (0, 1, 2)}
    # the first call: hops at 7, 17, ..., 47 ms; the next call's first hop is
    # due at 50 + 2 ms, the third's at 100 + 9 ms and its delay of 3 ms
    assert t[0][0] == pytest.approx(0.007, abs=2e-3)
    assert t[1][0] == pytest.approx(0.052, abs=2e-3)
    assert t[2][0] == pytest.approx(0.112, abs=2e-3)
    assert np.diff(t[1]) == pytest.approx([hop_s] * 4, abs=2e-3)


def test_backlog_growth_is_seen():
    assert common.backlog_grows(list(np.linspace(0, 1.0, 90)), 0.016)
    assert not common.backlog_grows([0.001] * 90, 0.016)


def test_offline_rate_is_all_clips_over_all_time(monkeypatch):
    """A call that stalls for 0.3 s lowers the rate by that time: the rate is
    the clips of the window over the window's wall time."""
    from cleanumamba_tpu_torch import graphs

    calls = []
    real = graphs.ForwardGraphs.__call__

    def slow(self, *a):
        calls.append(1)
        if len(calls) == 6:
            time.sleep(0.3)
        return real(self, *a)

    monkeypatch.setattr(graphs.ForwardGraphs, "__call__", slow)
    ctx = tiny.context("e8-offline", seconds=0.8, traffic={"items": 2, "seconds": 0.5})
    out = tiny.run(ctx)
    c = out["counts"]
    clip_s = c["clip_samples"] / ctx.traffic["sample_rate"]
    assert out["e2e"]["denoised_audio_rate"] == pytest.approx(c["clips"] * clip_s
                                                              / c["window_s"])
    assert c["window_s"] >= 0.8 and c["clips"] >= 3


def test_busy_union_idle_gaps_and_spans_on_a_synthetic_trace():
    ms = 1_000_000
    ev = [("user_annotation", "window", 0, 100 * ms),
          ("user_annotation", "feed", 10 * ms, 30 * ms),
          ("user_annotation", "wait", 30 * ms, 60 * ms),
          ("user_annotation", "feed", 60 * ms, 90 * ms),
          ("kernel", "void mega_kernel<float>(IO)", 12 * ms, 20 * ms),
          ("kernel", "gemm", 15 * ms, 25 * ms),  # overlaps the first: counted once
          ("kernel", "Memcpy DtoH", 26 * ms, 28 * ms),  # a copy is device work too
          ("kernel", "void mega_kernel<float>(IO)", 70 * ms, 80 * ms),
          ("gpu_user_annotation", "feed", 10 * ms, 30 * ms),  # not a device operation
          ("kernel", "late", 95 * ms, 120 * ms)]  # clipped to the window
    s = trace.summarize(ev, {"feed", "wait"})
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx((13 + 2 + 10 + 5) / 1e3)
    assert s["span_s"]["feed"] == pytest.approx(0.05)
    assert s["span_busy_s"]["feed"] == pytest.approx((13 + 2 + 10) / 1e3)
    # each gap named by the span open at its midpoint: 0-12 none, 25-26 feed,
    # 28-70 wait (midpoint 49), 80-95 feed
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"wait": 0.042, "feed": 0.016, "none": 0.012})
    assert sum(gaps.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    ops = dict(s["device_ops"])
    assert ops["mega_kernel<float>"] == pytest.approx(0.018)
    assert trace.short_name("void (anonymous namespace)::mega_kernel<float>(IO, float const*)") \
        == "(anonymous namespace)::mega_kernel<float>"
    from portbench import readers

    assert readers.kernel(s, r"\bmega_kernel\b") == (2, pytest.approx(0.018))
    idle = readers.idle_percent(s["span_busy_s"]["feed"], s["span_s"]["feed"])
    assert idle == pytest.approx(100 * (1 - 25 / 50))
