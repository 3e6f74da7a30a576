"""Driver: training as ``cli/train.py`` runs it on one card:
``train.trainer.make_train_step`` (bf16 compute, fp32 master weights, the
workload's loss and Adam with clipping) replayed by ``graph_train_step``.

Set-up: the weights from the seed on the card, a pool of (clean, noisy)
batches from the seed, the optimizer state, and the step object driven
through its first three steps (eager, captured, replayed) on pool items 0,
1 and 2, whose rows all differ.  Readings taken there, before the next step
overwrites them: each step's loss, the norm of each leaf of the first
gradient as the optimizer got it (Adam's first moment after one step over
1 - beta1: the clipped gradient) and of each leaf's change after the three.
Window: the same object, one step a pool item in order (span ``step``: the
call, which copies the batch in and launches the replay; ``sync``: waiting
for the card).  Check: the program freed, the plain reference follows the
same three steps from the same weights in fp32 (``gaps``: a leaf's gap is
taken against the larger of its reference norm and the median leaf's).
Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common
from portbench.reference import train as ref_train
from portbench.weights import leaf_paths, make_params

FIRST_STEPS = 3  # eager, captured, replayed: the steps the reference follows


def leaf_gaps(prog, ref, keep=None) -> np.ndarray:
    """|prog - ref| / max(ref, median(ref)) of each leaf kept (inf where the
    program's norm is not finite)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    g = np.abs(prog - ref) / np.maximum(ref, np.median(ref[keep] if keep is not None else ref))
    g[~np.isfinite(prog)] = np.inf
    return g if keep is None else np.where(keep, g, 0.0)


def gap(prog, ref, keep=None) -> float:
    """The worst leaf's gap."""
    return float(leaf_gaps(prog, ref, keep).max())


def gaps(prog, reference) -> dict:
    """The readings, from (losses, first gradient norms, change norms) of the
    program and of the reference: the worst step's loss gap and the first
    step's, the median leaf's gap of the change and of the first gradient,
    and the worst leaf's of each (``worst_*``).  The worst leaf's change gap
    is the bf16 rounding of the ``x_proj`` leaves' gradients, which Adam
    turns into steps of full size: the program's fp32 step reads it under
    2e-3, a bf16 reference as high as the program (``PERF.md``).  The
    gradient's gaps separate from neither the control nor a fault.  So the
    loss gap and the median leaf's change are compared, the rest read.
    ``moved``: the leaves in the change."""
    (losses, g, d), (r_losses, r_g, r_d) = prog, reference
    r_g, r_d = np.asarray(r_g, np.float64), np.asarray(r_d, np.float64)
    moved = r_g >= 1e-3 * np.median(r_g)
    grad, change = leaf_gaps(g, r_g), leaf_gaps(d, r_d, moved)[moved]
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
    return {"loss_gap": max(loss), "first_loss_gap": loss[0],
            "change_gap": float(np.median(change)), "grad_gap": float(np.median(grad)),
            "worst_grad_gap": float(grad.max()), "worst_change_gap": float(change.max()),
            "moved": moved}


def run(ctx) -> dict:
    from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig, STFTLossConfig
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.train import trainer
    from cleanumamba_tpu_torch.train.optim import make_optimizer

    dev, cfg, tr, gen = ctx.device, ctx.model_config(), ctx.traffic, ctx.generator_module
    setup = ctx.workload["setup"]
    opt, lc = setup["optimization"], setup["loss"]
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    params0 = [t.clone() for t in tensor_leaves(params)]  # the step writes params in place
    paths = [".".join(map(str, p)) for p, _ in leaf_paths(params)]
    clean, noisy = gen.make_pool(tr, ctx.torch_generator("audio"))
    optimizer = make_optimizer(OptimizationConfig(
        n_iters=opt["n_iters"], learning_rate=opt["learning_rate"], betas=tuple(opt["betas"]),
        eps=opt["eps"], clip_grad_norm_max=opt["clip_grad_norm_max"],
        weight_decay=opt["weight_decay"], optimizer=opt["optimizer"]))
    loss_cfg = LossConfig(ell_p=lc["ell_p"], ell_p_lambda=lc["ell_p_lambda"],
                          stft_lambda=lc["stft_lambda"],
                          stft_config=STFTLossConfig(**{k: (tuple(v) if isinstance(v, list)
                                                            else v)
                                                        for k, v in lc["stft_config"].items()}))
    eager = trainer.make_train_step(cfg, loss_cfg, optimizer, bf16=setup["bf16"])
    step = trainer.graph_train_step(eager, dev) if dev.type == "cuda" else eager
    opt_state = optimizer.init(params)
    spans, tracer = ctx.spans, ctx.tracer

    def batch(i):
        k = i % clean.shape[0]
        return clean[k][None], noisy[k][None]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = []
    for i in range(FIRST_STEPS):
        params, opt_state, aux = step(params, opt_state, batch(i))
        losses.append(float(aux["loss"]))
        if i == 0:
            g_norms = (torch.stack([m.float().norm() for m in tensor_leaves(opt_state["mu"])])
                       / (1 - opt["betas"][0])).cpu()
    d_norms = torch.stack([(p.float() - p0).norm()
                           for p, p0 in zip(tensor_leaves(params), params0)]).cpu()
    sync()
    spans.reset()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    n = trace_steps = 0
    paused = 0.0  # starting and stopping the profiler: left out of the window
    t_trace = t_start + max(0.0, ctx.seconds / 2 - 0.5)
    while time.perf_counter() - t_start - paused < ctx.seconds:
        if tracer.pending and time.perf_counter() >= t_trace:
            paused += tracer.begin()
        with spans("step"):
            params, opt_state, aux = step(params, opt_state, batch(FIRST_STEPS + n))
        with spans("sync"):
            sync()
        n += 1
        if tracer.active:
            trace_steps += 1
            if trace_steps == ctx.workload["trace"]["steps"]:
                paused += tracer.end(("step", "sync"))
    t_close = time.perf_counter()
    if tracer.active:
        paused += tracer.end(("step", "sync"))
    window_s = t_close - t_start - paused
    B, L = clean.shape[1], clean.shape[2]
    rate = n * B * L / tr["sample_rate"] / window_s
    device = common.device_record(dev)
    del step, eager, params, opt_state, aux
    common.release(dev)

    t_check = time.perf_counter()
    # the plain reference follows the first three steps in fp32
    with torch.enable_grad():
        r_losses, r_g, r_d = ref_train.steps(make_params(ctx.geom,
                                                         ctx.torch_generator("weights")),
                                             [(c[0], x[0]) for c, x in
                                              (batch(i) for i in range(FIRST_STEPS))],
                                             ctx.geom, lc, opt, "fp32")
    readings = gaps((losses, g_norms, d_norms), (r_losses, r_g, r_d))
    moved = readings.pop("moved")
    limits = ctx.workload["limits"]
    compared = [(k, readings.pop(k), limits[k]) for k in list(readings) if k in limits]
    r_g = np.asarray(r_g, np.float64)
    wg = int(np.argmax(leaf_gaps(g_norms.numpy(), r_g)))
    dg = leaf_gaps(d_norms.numpy(), r_d, moved)
    wd = [(paths[i], float(dg[i]), float(r_g[i] / np.median(r_g))) for i in np.argsort(-dg)[:3]]
    info = [f"read, not compared: {readings}; worst leaf of the gradient {paths[wg]}; worst "
            f"leaves of the change (leaf, gap, its reference gradient over the median leaf's) "
            f"{wd}",
            f"steps {n} of {B} x {L / tr['sample_rate']} s in {window_s!r} s: {rate!r} "
            f"audio-s/s; set-up {setup_s!r} s; losses {losses} (reference {r_losses}); "
            f"leaves compared for the change {int(moved.sum())} of {moved.size}; "
            f"output check {time.perf_counter() - t_check!r} s"]
    counts = {"steps": n, "batch": B, "samples": L, "window_s": window_s,
              "trace_steps": trace_steps, "peak_bytes": device["memory_peak_bytes"],
              "compute": "bf16" if setup["bf16"] else "fp32"}
    return {"e2e": {"train_audio_rate": rate, "setup_s": setup_s}, "counts": counts,
            "device": device, "info": info, "attempted": n, "failed": 0,
            "compared": compared}


def control(ctx, precision: str, half_batch: bool = False) -> dict:
    """The reference's three steps at ``precision`` (or at fp32 on the first
    half of each batch's rows, the mean taken over them) in the program's
    place: the gaps they read against the fp32 reference's."""
    setup, tr = ctx.workload["setup"], ctx.traffic
    clean, noisy = ctx.generator_module.make_pool(tr, ctx.torch_generator("audio"))
    batches = [(clean[i], noisy[i]) for i in range(FIRST_STEPS)]
    params = make_params(ctx.geom, ctx.torch_generator("weights"))
    args = (ctx.geom, setup["loss"], setup["optimization"])
    with torch.enable_grad():
        full = ref_train.steps(params, batches, *args, "fp32")
        if half_batch:
            half = [(c[: c.shape[0] // 2], x[: x.shape[0] // 2]) for c, x in batches]
            low = ref_train.steps(params, half, *args, "fp32")
        else:
            low = ref_train.steps(params, batches, *args, precision)
    out = gaps(low, full)
    out.pop("moved")
    return out
