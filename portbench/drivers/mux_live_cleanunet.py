"""Driver: live calls of CleanUNet (the mha bottleneck) through
``serve.SessionMultiplexer``, each session with its own KV rings.

As ``mux_live``: set-up (the weights from the seed on the card,
``portbench/cleanunet_weights.py``; a multiplexer of the workload's
``slots``, ``block`` and ``weights``, fp32 state, as ``cli/serve.py``
builds it; its prime and tick warmed; every line's first call opened and
primed), the window of ``realtime.window`` and the check: each session's
whole output against the plain reference (``portbench/reference/
cleanunet.py``) streaming the same audio with the configuration's attention
window, padded as the flush pads it, in fp32 from the weights as stored.
Counted besides: the program's ``kv_positions`` over the window and over
its traced slice, and the ticks of that slice, which K6's roofline and the
cell's mfu read.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import common, realtime
from portbench.cleanunet_weights import make_params
from portbench.drivers.mux_live import _server, _warm
from portbench.reference import cleanunet as ref


def _traced_counts(ctx, server, mux):
    """``server`` with its feed and finish counting, while the trace records,
    the ticks and attended positions they run; returns (server, counts)."""
    counts = {"ticks_traced": 0, "kv_positions_traced": 0}

    def counted(fn):
        def call(*args):
            t0, k0 = mux.ticks, mux.kv_positions
            out = fn(*args)
            if ctx.tracer.active:
                counts["ticks_traced"] += mux.ticks - t0
                counts["kv_positions_traced"] += mux.kv_positions - k0
            return out

        return call

    server.feed, server.finish = counted(server.feed), counted(server.finish)
    return server, counts


def run(ctx) -> dict:
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    dev, cfg, tr, gen = ctx.device, ctx.model_config(), ctx.traffic, ctx.generator_module
    hop, hop_s = gen.hop_samples(tr), tr["hop_ms"] / 1000.0
    prime_hops = math.ceil(cfg.frame_length / hop)
    if hop != cfg.total_stride or prime_hops != gen.PRIME_HOPS:
        raise ValueError(f"{ctx.name}: a hop of {hop} samples for a model stepping "
                         f"{cfg.total_stride} over frames of {cfg.frame_length}")
    setup = ctx.workload["setup"]
    window = ctx.config["streaming"]["attention_window"]
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    mux = SessionMultiplexer(params, cfg, slots=setup["slots"], block=setup["block"],
                             weights=setup["weights"], device=dev)
    if mux.kv_window != window:
        raise ValueError(f"{ctx.name}: the program attends to {mux.kv_window} tokens, the "
                         f"configuration states {window}")
    lines = gen.plan(tr, ctx.rng("calls"), ctx.seconds)
    gen.fill_audio(lines, tr, ctx.torch_generator("audio"))
    _warm(mux, hop, prime_hops, ctx.rng("warm"))
    server, traced = _traced_counts(ctx, _server(mux), mux)
    sessions = realtime.open_lines(server, lines, prime_hops)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t0
    kv0 = mux.kv_positions
    res = realtime.window(ctx, server, lines, sessions, hop_s, prime_hops,
                          ctx.workload["trace"]["seconds"])
    kv = mux.kv_positions - kv0
    e2e, info = realtime.e2e_and_info(res, hop_s, setup_s)
    realtime.finish_all(server, sessions)
    device = common.device_record(dev)
    checked = [s for s in res["done"] + sessions if s.fed >= 1]
    del mux, server  # the program's stored weights, rings and pool go with it
    common.release(dev)

    t_check = time.perf_counter()
    P = ref.stored(params, setup["weights"])
    pad = np.zeros(cfg.frame_length + hop, np.float32)
    worst = 0.0
    with torch.no_grad():
        for s in checked:
            x = torch.from_numpy(np.concatenate([s.fed_audio, pad]))[None].to(dev)
            y = ref.stream(P, ctx.geom, x, window)[0, :s.fed * hop].cpu().numpy()
            worst = max(worst, common.rel_err(s.output, y))
    counts = dict(res["counts"], **traced, slots=setup["slots"], compute="fp32",
                  kv_positions=kv)
    info.append(f"attended positions {kv} in the window; sessions checked {len(checked)} in "
                f"{time.perf_counter() - t_check!r} s")
    return {"e2e": e2e, "counts": counts, "device": device, "info": info,
            "attempted": len(res["lat"]), "failed": 0,
            "compared": [("out_err", worst, ctx.workload["limits"]["out_err"])]}


def control(ctx, precision: str) -> dict:
    """The reference at ``precision`` in the program's place: the out_err it
    reads against the fp32 reference over every call the traffic plans for
    ``ctx.seconds``, each whole and flushed."""
    cfg, tr, gen = ctx.model_config(), ctx.traffic, ctx.generator_module
    hop = gen.hop_samples(tr)
    window = ctx.config["streaming"]["attention_window"]
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
            y = ref.stream(P, ctx.geom, x, window)[0, :n].cpu().numpy()
            low = ref.stream(P, ctx.geom, x, window, ref.Prec(precision))[0, :n].cpu().numpy()
            worst = max(worst, common.rel_err(low, y))
    return {"out_err": worst}
