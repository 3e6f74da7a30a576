"""Driver: live calls through ``serve.SessionMultiplexer``, the service that
holds many calls on one card.

Set-up: the weights from the seed on the card, a multiplexer of the
workload's ``slots``, ``block`` and ``weights`` (state and activations in
fp32, as ``cli/serve.py``'s serving path builds it), two throwaway sessions
through prime (eager, then captured), three ticks (eager, captured,
replayed) and their flushes, then every line's first call opened and
primed.  Window: ``realtime.window``.  Check: after the window every open call
is flushed; the program is freed; each session's whole output (admission,
the splice into the pool, the paused rows, every tick and the flush's
padding) against the plain reference streaming the same audio, padded as
the flush pads it, in fp32 from the weights as stored.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import common, realtime
from portbench.reference import model as ref
from portbench.weights import make_params


def _server(mux):
    def finish(sid):
        out = mux.flush(sid)
        mux.close(sid)
        return out

    return SimpleNamespace(open=mux.open, feed=mux.feed, finish=finish, ticks=lambda: mux.ticks)


def _warm(mux, hop: int, prime_hops: int, rng) -> None:
    z = (rng.standard_normal(hop * (prime_hops + 1)) * 0.1).astype(np.float32)
    a = mux.open()
    mux.feed(a, z[:prime_hops * hop])  # prime: eager
    b = mux.open()
    mux.feed(b, z[:prime_hops * hop])  # prime: captured
    for sid in (a, a, b):  # tick: eager, captured, replayed
        mux.feed(sid, z[prime_hops * hop:])
    for sid in (a, b):
        mux.flush(sid)
        mux.close(sid)


def run(ctx) -> dict:
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    dev, cfg, tr, gen = ctx.device, ctx.model_config(), ctx.traffic, ctx.generator_module
    hop, hop_s = gen.hop_samples(tr), tr["hop_ms"] / 1000.0
    prime_hops = math.ceil(cfg.frame_length / hop)
    if hop != cfg.total_stride or prime_hops != gen.PRIME_HOPS:
        raise ValueError(f"{ctx.name}: a hop of {hop} samples for a model stepping "
                         f"{cfg.total_stride} over frames of {cfg.frame_length}")
    setup = ctx.workload["setup"]
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    mux = SessionMultiplexer(params, cfg, slots=setup["slots"], block=setup["block"],
                             weights=setup["weights"], device=dev)
    lines = gen.plan(tr, ctx.rng("calls"), ctx.seconds)
    gen.fill_audio(lines, tr, ctx.torch_generator("audio"))
    _warm(mux, hop, prime_hops, ctx.rng("warm"))
    server = _server(mux)
    sessions = realtime.open_lines(server, lines, prime_hops)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t0
    res = realtime.window(ctx, server, lines, sessions, hop_s, prime_hops,
                          ctx.workload["trace"]["seconds"])
    e2e, info = realtime.e2e_and_info(res, hop_s, setup_s)
    realtime.finish_all(server, sessions)
    device = common.device_record(dev)
    checked = [s for s in res["done"] + sessions if s.fed >= 1]
    del mux, server  # the program's stored weights and pool go with it
    common.release(dev)

    t_check = time.perf_counter()
    # the plain reference, in fp32 from the weights as stored
    P = ref.stored(params, setup["weights"])
    pad = np.zeros(cfg.frame_length + hop, np.float32)
    worst = 0.0
    with torch.no_grad():
        for s in checked:
            x = torch.from_numpy(np.concatenate([s.fed_audio, pad]))[None].to(dev)
            y = ref.stream(P, ctx.geom, x)[0, :s.fed * hop].cpu().numpy()
            worst = max(worst, common.rel_err(s.output, y))
    counts = dict(res["counts"], slots=setup["slots"], compute="fp32")
    info.append(f"sessions checked {len(checked)} in {time.perf_counter() - t_check!r} s")
    return {"e2e": e2e, "counts": counts, "device": device, "info": info,
            "attempted": len(res["lat"]), "failed": 0,
            "compared": [("out_err", worst, ctx.workload["limits"]["out_err"])]}


def control(ctx, precision: str) -> dict:
    """The reference at ``precision`` in the program's place: the out_err it
    reads against the fp32 reference over every call the traffic plans for
    ``ctx.seconds``, each whole and flushed."""
    cfg, tr, gen = ctx.model_config(), ctx.traffic, ctx.generator_module
    hop = gen.hop_samples(tr)
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    lines = gen.plan(tr, ctx.rng("calls"), ctx.seconds)
    gen.fill_audio(lines, tr, ctx.torch_generator("audio"))
    P = ref.stored(params, ctx.workload["setup"]["weights"])
    pad = np.zeros(cfg.frame_length + hop, np.float32)
    worst = 0.0
    with torch.no_grad():
        for c in (c for calls in lines for c in calls):
            x = torch.from_numpy(np.concatenate([c.audio, pad]))[None].to(ctx.device)
            n = c.audio.shape[0]
            y = ref.stream(P, ctx.geom, x)[0, :n].cpu().numpy()
            low = ref.stream(P, ctx.geom, x, ref.Prec(precision))[0, :n].cpu().numpy()
            worst = max(worst, common.rel_err(low, y))
    return {"out_err": worst}
