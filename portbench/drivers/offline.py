"""Driver: bulk denoising as ``cli/denoise.py`` runs it: the offline forward
replayed by ``graphs.ForwardGraphs``, one clip a call, host numpy in and
out.

Set-up: the weights from the seed on the card, the pool of clips, the
forward called three times (eager, captured, replayed).  Window: calls over
the pool in order (spans ``forward``: the call, which copies the clip in and
launches the replay; ``copy_out``: the output to the host, which waits for
the card) until ``--seconds`` have passed.  Check: the program freed, the
outputs of a sample of the window's calls drawn from the seed (each call
with the workload's ``check_share`` as its chance) against the plain reference's forward of
their clips in fp32.
"""

from __future__ import annotations

import time

import torch

from portbench import common
from portbench.reference import model as ref
from portbench.weights import make_params

WARM_CALLS = 3  # eager, captured, replayed


def run(ctx) -> dict:
    from cleanumamba_tpu_torch.graphs import ForwardGraphs
    from cleanumamba_tpu_torch.models.cleanumamba import forward

    dev, cfg, tr, gen = ctx.device, ctx.model_config(), ctx.traffic, ctx.generator_module
    if ctx.workload["setup"]["compute"] != "fp32":
        raise ValueError(f"{ctx.name}: the offline driver runs the fp32 forward")
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    _, noisy = gen.make_pool(tr, ctx.torch_generator("audio"))
    clips = [c for c in noisy.reshape(-1, noisy.shape[-1]).cpu().numpy()]
    del noisy
    fwd = ForwardGraphs(lambda p, x: forward(p, x.to(torch.float32), cfg).float(), dev)
    spans, tracer = ctx.spans, ctx.tracer
    sampled = ctx.rng("sample").random(1 << 20) < ctx.workload["setup"]["check_share"]
    kept = []  # (clip, output) of the sampled calls

    def call(i):
        with spans("forward"):
            y = fwd(params, torch.from_numpy(clips[i % len(clips)][None]))
        with spans("copy_out"):
            out = y.cpu().numpy()[0]
        if i >= WARM_CALLS and sampled[(i - WARM_CALLS) % sampled.size]:
            kept.append((i % len(clips), out))

    with torch.no_grad():
        for i in range(WARM_CALLS):
            call(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        spans.reset()
        t_start = time.perf_counter()
        setup_s = t_start - ctx.t0
        n = trace_clips = 0
        paused = 0.0  # starting and stopping the profiler: left out of the window
        t_trace = t_start + max(0.0, ctx.seconds / 2 - 0.5)
        while time.perf_counter() - t_start - paused < ctx.seconds:
            if tracer.pending and time.perf_counter() >= t_trace:
                paused += tracer.begin()
            call(WARM_CALLS + n)
            n += 1
            if tracer.active:
                trace_clips += 1
                if trace_clips == ctx.workload["trace"]["clips"]:
                    paused += tracer.end(("forward", "copy_out"))
        t_close = time.perf_counter()
        if tracer.active:
            paused += tracer.end(("forward", "copy_out"))
    window_s = t_close - t_start - paused
    clip_s = clips[0].shape[0] / tr["sample_rate"]
    rate = n * clip_s / window_s
    device = common.device_record(dev)
    del fwd
    common.release(dev)

    t_check = time.perf_counter()
    worst, refs = 0.0, {}
    with torch.no_grad():
        for k, out in kept:
            if k not in refs:
                y = ref.forward(params, torch.from_numpy(clips[k][None]).to(dev), ctx.geom)
                refs[k] = y[0].cpu().numpy()
            worst = max(worst, common.rel_err(out, refs[k]))
    if not kept:
        worst = float("inf")  # nothing checked is not correct
    info = [f"clips {n} of {clip_s} s in {window_s!r} s: {rate!r} audio-s/s; "
            f"{spans.total.get('forward', 0.0)!r} s in forward calls, "
            f"{spans.total.get('copy_out', 0.0)!r} s in copies out; set-up {setup_s!r} s",
            f"calls checked {len(kept)} ({len(refs)} clips) in "
            f"{time.perf_counter() - t_check!r} s"]
    counts = {"clips": n, "clip_samples": int(clips[0].shape[0]), "batch": 1,
              "window_s": window_s, "trace_clips": trace_clips, "compute": "fp32"}
    return {"e2e": {"denoised_audio_rate": rate, "setup_s": setup_s}, "counts": counts,
            "device": device, "info": info, "attempted": n, "failed": 0,
            "compared": [("out_err", worst, ctx.workload["limits"]["out_err"])]}


def control(ctx, precision: str) -> dict:
    """The reference's forward at ``precision`` in the program's place: the
    out_err it reads against the fp32 forward over the pool's clips."""
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    _, noisy = ctx.generator_module.make_pool(ctx.traffic, ctx.torch_generator("audio"))
    worst = 0.0
    with torch.no_grad():
        for x in noisy.reshape(-1, 1, noisy.shape[-1]):
            y = ref.forward(params, x, ctx.geom)
            low = ref.forward(params, x, ctx.geom, ref.Prec(precision))
            worst = max(worst, common.rel_err(low.cpu().numpy(), y.cpu().numpy()))
    return {"out_err": worst}
