"""The real-time loop of the live-call cells, shared by their drivers.

One thread serves every line in due order, as a server's pump would: it
waits until the earliest hop is due (``common.wait_until``), feeds it, and
takes (time ``feed`` returned - time the hop was due: its slot on the
call's schedule plus the network's delay of that hop) as that hop's
latency, so a hop that queues behind other calls' work or a flush carries
the wait.  Open loop: a hop is due at its time whether or not the card
kept up.  When a call's last hop is in, the call is flushed and closed
(span ``flush``) and the line's next call opens at once: its first hop is
due at its own phase within the hop after the last call's next slot.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from portbench import common


@dataclasses.dataclass
class Session:
    call: object  # traffic.live.Call
    handle: object
    fed: int = 0  # hops fed
    outs: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def output(self) -> np.ndarray:
        return np.concatenate(self.outs) if self.outs else np.zeros(0, np.float32)

    @property
    def delay(self) -> float:
        """The network's delay of the next hop, seconds."""
        d = self.call.delay
        return 0.0 if d is None or self.fed >= len(d) else float(d[self.fed])

    @property
    def fed_audio(self) -> np.ndarray:
        hop = self.call.audio.shape[0] // self.call.hops
        return self.call.audio[:self.fed * hop]


def open_lines(server, lines, hops: int) -> List[Session]:
    """Open each line's first call and feed its first ``hops`` hops (set-up)."""
    out = []
    for calls in lines:
        s = Session(calls[0], server.open())
        _feed_hops(server, s, hops)
        out.append(s)
    return out


def _feed_hops(server, s: Session, n: int) -> None:
    hop = s.call.audio.shape[0] // s.call.hops
    for _ in range(n):
        s.outs.append(server.feed(s.handle, s.call.audio[s.fed * hop:(s.fed + 1) * hop]))
        s.fed += 1


def window(ctx, server, lines, sessions: List[Session], hop_s: float, prime_hops: int,
           trace_seconds: float = 0.0) -> dict:
    """Serve every line for ``ctx.seconds`` from now.  ``server`` has
    ``open() -> handle``, ``feed(handle, samples) -> output``, ``finish``
    (``finish(handle) -> output``: flush and close; None where the cell's
    calls never end) and ``ticks() -> int | None`` (the program's count of
    batched steps).  Returns the hop latencies, the finished sessions and
    the counts the readers use."""
    spans, tracer = ctx.spans, ctx.tracer
    spans.reset()
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    slot = t_start + np.array([s.call.phase for s in sessions])  # each line's schedule
    due = slot + [s.delay for s in sessions]
    nxt = [1] * len(lines)  # index of each line's next call
    lat, done = [], []
    live_rows = admitted = trace_hops = 0
    paused = 0.0  # starting and stopping the profiler: left out of the window
    ticks0 = server.ticks()
    trace_from = t_start + max(0.0, (ctx.seconds - trace_seconds) / 2)
    trace_to = float("inf")
    while True:
        now = time.perf_counter()
        if (tracer.pending and now >= trace_from) or (tracer.active and now >= trace_to):
            p = tracer.begin() if tracer.pending else tracer.end(("feed", "flush", "wait"))
            slot += p
            due += p
            t_end += p
            paused += p
            trace_to = time.perf_counter() + trace_seconds
            continue
        j = int(np.argmin(due))
        t_due = due[j]
        if not t_due < t_end:
            break
        with spans("wait"):
            common.wait_until(t_due)
        s = sessions[j]
        hop = s.call.audio.shape[0] // s.call.hops
        with spans("feed"):
            out = server.feed(s.handle, s.call.audio[s.fed * hop:(s.fed + 1) * hop])
        lat.append(time.perf_counter() - t_due)
        s.outs.append(out)
        if s.fed >= prime_hops:
            live_rows += 1  # a primed session's hop is stepped in exactly one tick
        s.fed += 1
        if tracer.active:
            trace_hops += 1
        slot[j] += hop_s
        if s.fed == s.call.hops and server.finish is None:
            due[j] = float("inf")  # a call that never ends has run out of audio
            continue
        if s.fed == s.call.hops:
            t0 = server.ticks()
            with spans("flush"):
                s.outs.append(server.finish(s.handle))
            live_rows += server.ticks() - t0  # a flush's ticks step only its session
            done.append(s)
            call = lines[j][nxt[j]]
            nxt[j] += 1
            slot[j] += call.phase - s.call.phase
            sessions[j] = Session(call, server.open())
            admitted += 1
        due[j] = slot[j] + sessions[j].delay
    t_close = time.perf_counter()
    if tracer.active:
        paused += tracer.end(("feed", "flush", "wait"))
    ticks = None if ticks0 is None else server.ticks() - ticks0
    return {"lat": lat, "done": done, "t_start": t_start, "t_close": t_close,
            "counts": {"hops": len(lat), "live_rows": live_rows, "ticks": ticks,
                       "admitted": admitted, "trace_hops": trace_hops,
                       "feed_s": spans.total.get("feed", 0.0),
                       "flush_s": spans.total.get("flush", 0.0),
                       "window_s": t_close - t_start - paused}}


def finish_all(server, sessions: List[Session]) -> None:
    """After the window: flush every open call (not timed)."""
    for s in sessions:
        if server.finish is not None and s.fed >= 1:
            s.outs.append(server.finish(s.handle))


def e2e_and_info(res: dict, hop_s: float, setup_s: float) -> tuple:
    lat_ms = np.asarray(res["lat"]) * 1e3
    p95 = common.percentile(lat_ms, 95)
    c = res["counts"]
    grows = common.backlog_grows(res["lat"], hop_s)
    info = [f"hops {len(lat_ms)} in {c['window_s']:.3f} s: latency p50 "
            f"{common.percentile(lat_ms, 50)!r} p95 {p95!r} max {float(lat_ms.max())!r} ms; "
            f"{int((lat_ms > hop_s * 1e3).sum())} later than a hop; backlog grows: {grows}; "
            f"calls opened in the window {c['admitted']}; ticks {c['ticks']}; "
            f"set-up {setup_s!r} s"]
    c["backlog_grows"] = grows
    return {"hop_p95_ms": p95, "setup_s": setup_s}, info
