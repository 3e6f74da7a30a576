#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cleanumamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA device
    python3 chip_smoke.py --fused-only   # K3/K4 alone: their part of phases 3-5, and 13
    python3 chip_smoke.py --scan-only    # K1/K2 alone: their part of phases 3, 6 and 8
    python3 chip_smoke.py --base-k5 DIR  # phase 12 also times DIR's K5 (an earlier checkout)

Phases, each printed as it passes; any failure raises (non-zero exit):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the CUDA kernels (``csrc/*.cu``, one ``nvcc`` each, in
   parallel) into ``_build/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, in fp32 (TF32 off) and bf16.  K1: every lane
   split its plan picks, d_state 1..256, batch 1, 2 and 8, L 1..2,500, the
   pruned checkpoint's ragged d_inner, with and without h0 and D, its chunk
   states, a repeated call bit for bit.  K3/K4: every E8 level at block 1, with and
   without ``prev``; batch 2 and 8 at the four deepest levels; every ragged
   level of the pruned checkpoint; a repeated call bit for bit; the other
   GLU gate activations in fp32.  Their times are device times from a
   ``torch.profiler`` trace of rounds through one frame's 16 level calls
   (per level and launch: us, the bytes it must move, GB/s), beside 16 empty
   launches (the launch floor) and the host's cost per wrapper call;
4. the E8 serving slice at full width (random weights from a seeded
   ``torch.Generator``, bf16 weight view): offline forward on 1 s, prime +
   64 blocks of 16 frames through ``stream_step_block``, then ``Streamer``
   at block 1; every kernel's launch count must be > 0 after this phase;
   then, in fp32, 2 blocks of 16 frames must equal 32 single steps; then a
   profiler window of the block-1 step (device busy and K3 + K4 per frame,
   ``profiles/block1_step_profile.txt``); then the offline forward on 10 s
   at batch 2, fp32 and bf16 (wall, device busy, kernels, K1's share);
5. real weights: ``artifacts/pruned_473k_finetuned.pkl`` offline and
   streamed, streaming == offline with ``normalize_input=False``;
6. K2 (backward scan) against its plain version: all seven gradients at
   the E8 training shape (B=2, L=625, d_inner 2048, d_state 64) and over the
   same range of shapes as K1 (d_state <= 128), fp32 and bf16, a repeated
   call bit for bit; then device time per launch of K1 and K2 from a
   ``torch.profiler`` trace (K1 at the block-16 and training shapes, with
   and without chunk states; K2 with its summing launch apart), each beside
   the bound computed from the tensors timed, and K2's scratch bytes;
7. the E8 training slice at full width: bf16 ``make_train_step`` (Adam,
   lr 1e-4) on batch 2 x 10 s from ``synth_batch`` on the card, a few
   steps on fresh batches, then 12 on one batch, whose loss must fall;
   finite gradients every step; K1 and K2 launch counts > 0; ms per step,
   peak memory and a ``torch.profiler`` window (device-busy share, kernels
   per step);
8. the whole-model fp32 gradient of a small config on the card (kernels)
   against the same step on the CPU (plain versions), every leaf;
9. the training CLI as a subprocess: 3 iterations of E8 on synthetic data,
   then a resumed run, and a forward from the final checkpoint;
10. K5 (the whole-frame kernel) against its plain version at the released
    small geometry ("FullMini": channels 32..64, 8 levels, 3 bottleneck
    layers, d_model 64, d_inner 128): 5 bottleneck families x {fp32, bf16
    packs} x batch {1, 2, 8}, 8 consecutive frames (3 at batch 8) with the
    state carried, in both contracts (``mega_stream_step`` on the normalised
    frame, ``mega_stream_frame`` with the normalisation inside the launch:
    the new tail, count and std too), outputs and every state leaf, a
    repeated launch bit for bit; the MHA ring after it has wrapped; and
    both ``artifacts/*.pkl`` (ragged pruned widths);
11. the small-model block-1 path: ``Streamer(params, cfg, fused="auto")``
    per family, 2 s of audio in 256-sample hops and a flush: it resolves to
    "mega", K5 is launched once per frame stepped, and the output equals the
    same audio through plain ``stream_step``; the pruned checkpoint streamed
    through K5 equals its offline forward; E8-full still resolves to "fused"
    and launches K3/K4;
12. times of that path (CUDA events and host clock, >= 200 frames): K5 alone,
    ``stream_step_mega`` whole, ``stream_step`` through the K3/K4 packs and
    plain, for FullMini mamba and mha with fp32 and bf16 packs; wall per
    ``Streamer.feed``; K5's device time from a trace per family, by depth,
    width and bottleneck layers, per family and pack and at batch 2, 8 and
    32 (with ``--base-k5 DIR``, another checkout's K5 in the same trace, in
    turns); a ``torch.profiler`` window of the mega path (device busy per
    frame, idle share, and one kernel a frame, asserted);
13. K3/K4 with int8 weights (E8 quantized at ``quant_min_size=4096``, bf16
    compute; two levels mix a dense conv with an int8 mix) against their
    plain versions on the same packs: every E8 level at block 1, batch 1, 2
    and 8, with and without ``prev``; every ragged level of both
    ``artifacts/*.pkl`` at batch 2; a repeated call bit for bit; then the
    device time of one frame's 16 int8 level calls from a trace beside the
    bf16 packs' 16 calls in the same trace, the bytes and the bounds;
14. the int8 serving path: E8 ``Streamer(weights="int8", fused=True)`` over
    2 s in 256-sample hops and a flush resolves to "fused", launches the
    int8 K3/K4 at every level of every frame stepped, and equals the same
    ``Streamer`` on the CPU (plain versions) within the bf16 bound;
    ``fused="auto"`` with int8 resolves to "plain";
15. ``SessionMultiplexer`` on E8: three staggered sessions equal each
    streamed alone; slots 8 at block 16 (K1 launched) and slots 1 and 8 at
    block 1, each with bf16 and int8 weights: wall, device busy and kernels
    per tick of its traffic, and the batched step's audio-s/s with every
    slot live (``cli/serve.py --bench`` in process); then ``cli/serve.py``
    (bench and demo), ``cli/denoise.py`` on a reference-format checkpoint
    and ``cli/stream_demo.py --synthetic`` as subprocesses.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
kernels' summary as JSON: each kernel's launches on its path, error, time,
the plain version's time and its bound (the larger of the bytes it must
move over 3.35 TB/s and its operations over the card's peak for their type).
There is no CPU path: without a CUDA device the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CKPT = "artifacts/pruned_473k_finetuned.pkl"
SR = 16000


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Published peaks of one H100 SXM: device memory 3.35 TB/s; 67 TFLOP/s fp32
# outside the tensor cores, 989 TFLOP/s dense bf16 in them; the special-function
# units (exp) have 16 lanes per SM against 128 fp32 lanes: 1/8 of the FMA rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SFU_OPS_PER_S = 67e12 / 2 / 8


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes, flops, dtype=torch.float32, sfu=0) -> tuple:
    """(least ms the card could take, "bytes" | "operations"): every input
    byte read once and every output byte written once at the memory rate,
    against the operations at the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_FLOPS[dtype], sfu / SFU_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class Report:
    """Per-kernel max errors, times and bounds for the summary line."""

    def __init__(self):
        self.err = {}
        self.ms = {}
        self.bound = {}

    def check(self, kernel, label, got, ref, tol, quiet=False):
        err, rel = _rel_err(got, ref)
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        if not quiet:
            print(f"  {kernel} {label}: max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"{kernel} {label}: relative error {rel:.3e} > {tol:g}")


FP32_TOL = 1e-4  # fp32 kernel vs plain, relative to max|ref|: summation order only
BF16_TOL = 2e-2  # bf16 kernel vs the plain version in fp32 on the same bf16-rounded inputs
# whole-model fp32 gradient, card vs CPU, relative to each leaf's max|ref|: the
# Pallas backward's test tolerance (tests/test_pallas_scan.py:60).  The
# summation-order differences of every op (cuFFT, cuBLAS, K1/K2) add up, and
# the log-magnitude STFT loss amplifies them most in dt_proj's gradient.
GRAD_TOL = 2e-4


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

SCAN_KERNELS = ("scan_", "sum_middle")  # names of K1's and K2's kernels in a trace
TRAIN_SHAPE = (2, 625, 2048, 64)  # E8, batch 2 x 10 s: B, L, d_inner, d_state
SERVE_SHAPE = (1, 16, 2048, 64)  # one 16-frame streaming block


def _scan_inputs(g, dev, Bsz, L, Di, Ds, dtype, state=True):
    """Random inputs of K1 and K2 on the card; u, B, C, gy in ``dtype``.
    ``state`` makes h0 and gh_last non-zero."""
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    a = dict(u=rn(Bsz, L, Di), dt=rn(Bsz, L, Di).abs() * 0.1,
             A=-torch.exp(rn(Di, Ds) * 0.5), B=rn(Bsz, L, Ds), C=rn(Bsz, L, Ds),
             D=rn(Di), h0=rn(Bsz, Di, Ds) * 0.1, gy=rn(Bsz, L, Di),
             gh_last=rn(Bsz, Di, Ds) * 0.1)
    if not state:
        a["h0"], a["gh_last"] = torch.zeros_like(a["h0"]), torch.zeros_like(a["gh_last"])
    a = {k: v.to(dev) for k, v in a.items()}
    for k in ("u", "B", "C", "gy"):
        a[k] = a[k].to(dtype)
    return a


SCAN_ARGS = ("u", "dt", "A", "B", "C", "D", "h0")


def _pruned_d_inner(dev):
    """The mixers' (ragged) d_inner in the pruned checkpoint."""
    from cleanumamba_tpu_torch.models.bottleneck_mamba import mixer_dims
    from cleanumamba_tpu_torch.params import load_checkpoint

    _, params = load_checkpoint(CKPT, dev)
    return sorted({mixer_dims(lp["mixer"])[1] for lp in params["bottleneck"]["layers"]})


def _same_bits(name, first, again):
    for i, (x, y) in enumerate(zip(first, again)):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: output {i} of a repeated call differs")


def check_scan(dev, rep: Report):
    """K1 against its plain version: every lane split the plan can pick,
    d_state 1..256, batch 1, 2 and 8, L from 1 to 2,500 (a 40 s clip), ragged
    widths (the pruned checkpoint's mixers), with and without h0 and D, a
    repeated call bit for bit."""
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

    g = torch.Generator().manual_seed(1)
    cases = [(*SERVE_SHAPE, True), (2, 63, 2048, 64, False), (1, 37, 48, 8, True),
             (8, 17, 2048, 64, True), (*TRAIN_SHAPE, True), (1, 2500, 2048, 64, True),
             (2, 15, 512, 128, True), (1, 1, 2048, 16, True), (8, 16, 256, 8, False),
             (1, 5, 33, 1, False), (2, 9, 130, 100, True), (1, 4, 20, 256, True),
             (8, 33, 2048, 16, True)]
    cases += [(2, 40, di, 64, True) for di in _pruned_d_inner(dev)]
    lanes_seen = set()
    for Bsz, L, Di, Ds, state in cases:
        lanes_seen.add(kscan.scan_plan(Bsz, Di, Ds).lanes)
        for dt_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            a = _scan_inputs(g, dev, Bsz, L, Di, Ds, dtype, state)
            args = {k: a[k] for k in SCAN_ARGS}
            if not state:  # the absent h0 and D
                args["h0"] = args["D"] = None
            got = kscan.selective_scan(**args, return_starts=True)
            ref = kscan.plain_scan.selective_scan(
                **{k: (v.float() if v is not None else None) for k, v in args.items()},
                chunk=kscan.scan_chunk(Bsz, Di, Ds), return_starts=True)
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            label = (f"B={Bsz} L={L} d_inner={Di} d_state={Ds} h0,D={state} {dt_name} "
                     f"lanes={kscan.scan_plan(Bsz, Di, Ds).lanes}")
            for name, x, r in zip(("y", "h_last", "h_starts"), got, ref):
                rep.check("selective_scan_fwd", f"{label} {name}", x, r, tol)
            _same_bits("selective_scan_fwd " + label, got,
                       kscan.selective_scan(**args, return_starts=True))
            y, h = kscan.selective_scan(**args)  # the serving launch: no chunk states
            _same_bits("selective_scan_fwd without chunk states " + label, got[:2], (y, h))
    if lanes_seen != set(kscan.LANE_CHOICES):
        raise AssertionError(f"the cases reach lane splits {lanes_seen} of {kscan.LANE_CHOICES}")
    print(f"  selective_scan_fwd: {len(cases)} shapes x 2 dtypes, repeated calls bitwise equal, "
          f"with and without chunk states; lane splits {sorted(lanes_seen)}")


def _trace_scan(fn, iters=20, warmup=3):
    """Device time of K1's and K2's kernels in one call of ``fn``, from a
    ``torch.profiler`` trace of ``iters`` calls: {kernel name: (launches per
    call, median us per launch)}."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                k in e.name for k in SCAN_KERNELS):
            name = e.name.split("<")[0].split("::")[-1].split(" ")[-1]
            spans.setdefault(name, []).append(e.time_range.end - e.time_range.start)
    if not spans or min(len(v) for v in spans.values()) < iters // 2:
        raise AssertionError(f"the trace holds {({k: len(v) for k, v in spans.items()})} scan "
                             f"kernels for {iters} calls")
    return {k: (round(len(v) / iters), _median(v)) for k, v in spans.items()}


def _scan_bounds(shape, tensors, bwd):
    """Per state element and step: K1 one exp and ~6 fp32 operations; K2 the
    state recomputed and the adjoint with its five products (~18), one exp."""
    n_state = shape[0] * shape[1] * shape[2] * shape[3]
    return _bound(_nbytes(*tensors), (18 if bwd else 6) * n_state, sfu=n_state)


def time_scan(dev, rep: Report, smi):
    """Device time of K1 and K2 per launch from a trace, each beside the bound
    computed from the tensors timed: K1 at the block-16 shape and at the
    training shape with and without chunk states, K2 at the training shape
    with its summing launches apart."""
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

    g = torch.Generator().manual_seed(5)

    def total_us(tr):
        return sum(n * us for n, us in tr.values())

    def show(tr):
        return ", ".join(f"{k} x{n} {us:.2f}" for k, (n, us) in sorted(tr.items()))

    for shape in (SERVE_SHAPE, TRAIN_SHAPE):
        Bsz, L, Di, Ds = shape
        for dt_name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            if shape == SERVE_SHAPE and dtype == torch.float32:
                continue
            a = _scan_inputs(g, dev, *shape, dtype)
            fwd = {k: a[k] for k in SCAN_ARGS}
            label = f"B={Bsz} L={L} d_inner={Di} d_state={Ds} {dt_name}"
            for starts in ((False,) if shape == SERVE_SHAPE else (False, True)):
                outs = kscan.selective_scan(**fwd, return_starts=starts)
                tr = _trace_scan(lambda: kscan.selective_scan(**fwd, return_starts=starts))
                bound_ms, by = _scan_bounds(shape, (*fwd.values(), *outs), bwd=False)
                print(f"  K1 {label} chunk states={starts}, device us per launch from a trace "
                      f"on {smi}: {show(tr)}; bound {bound_ms * 1e3:.2f} us ({by}); chunk "
                      f"states {_nbytes(*outs[2:]) / 1e6:.1f} MB")
                if shape == SERVE_SHAPE:
                    plain_ms = _time_ms(lambda: kscan.selective_scan_plain(**fwd), iters=10,
                                        warmup=2)
                    rep.ms["selective_scan_fwd"] = (total_us(tr) / 1e3, plain_ms)
                    rep.bound["selective_scan_fwd"] = (bound_ms, by)
            if shape == SERVE_SHAPE:
                continue
            _, _, hs = kscan.selective_scan(**fwd, return_starts=True)
            bwd = (*(a[k] for k in SCAN_ARGS[:6]), hs, a["gy"], a["gh_last"])
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            grads = kscan.selective_scan_bwd(*bwd)
            scratch = torch.cuda.max_memory_allocated() - before - _nbytes(*grads)
            tr = _trace_scan(lambda: kscan.selective_scan_bwd(*bwd))
            bound_ms, by = _scan_bounds(shape, (*bwd, *grads), bwd=True)
            print(f"  K2 {label}, device us per launch from a trace on {smi}: {show(tr)}; all "
                  f"its launches {total_us(tr):.2f} us; bound {bound_ms * 1e3:.2f} us ({by}); "
                  f"scratch beside the seven gradients {scratch / 1e6:.1f} MB")
            if dtype == torch.bfloat16:  # the training path runs bf16
                # the cluster size is fitted to the card: larger clusters shrink the
                # partials but may not all find room at once
                plan = kscan.scan_plan(Bsz, Di, Ds, bwd=True)
                chunk = kscan.scan_chunk(Bsz, Di, Ds)
                fitted = kscan.fit_cluster(plan, Bsz, 1, Ds, chunk)
                room = {c: kscan.clusters_at_once(1, Ds, chunk, plan.lanes, c)
                        for c in (1, 2, 4, 8)}
                forced = {c: total_us(_trace_scan(
                    lambda c=c: kscan.selective_scan_bwd(*bwd, cluster=c))) for c in (1, 2, 4)}
                print(f"  K2 {label}: {plan.lanes} lanes, {plan.blocks} blocks, clusters of "
                      f"{fitted.cluster} (of {plan.cluster} at most); clusters the card holds at "
                      f"once by size {room}; all its launches with the cluster size forced, us: "
                      + ", ".join(f"{c}: {us:.2f}" for c, us in forced.items()))
                f32 = [x.float() for x in bwd]
                plain_ms = _time_ms(lambda: kscan.plain_scan.selective_scan_bwd(
                    *f32, chunk=kscan.scan_chunk(Bsz, Di, Ds)), iters=3, warmup=1)
                rep.ms["selective_scan_bwd"] = (total_us(tr) / 1e3, plain_ms)
                rep.bound["selective_scan_bwd"] = (bound_ms, by)
    print(f"  plain versions on {smi}: K1 at the block-16 shape "
          f"{rep.ms['selective_scan_fwd'][1]:.4f} ms, K2 at the training shape "
          f"{rep.ms['selective_scan_bwd'][1]:.4f} ms")


def _fp32_pack(pk):
    """The same pack in fp32 (the tiled layout is kept)."""
    arrays, meta = pk
    return {k: v.float() for k, v in arrays.items()}, {**meta, "cdt": torch.float32}


FUSED_KERNELS = ("conv_relu_kernel", "glu_kernel", "convt_kernel", "empty_kernel")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _trace_calls(calls, per_call, iters=20, warmup=3):
    """Device time of each of ``calls`` (thunks that launch ``per_call`` K3/K4
    kernels each) from a ``torch.profiler`` trace of ``iters`` rounds through
    all of them in order, so that a level finds its weights where a frame
    would (a round reads more than the L2 cache holds).  Returns, per call,
    (median us of each kernel, median us the device is busy with them: the
    union of their intervals, which counts an overlap once and no gap that the
    host left between two launches; median us from the first kernel's start
    to the last one's end, gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        for fn in calls:
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in FUSED_KERNELS))
    per_round = per_call * len(calls)
    rounds = len(ev) // per_round
    if rounds < iters // 2:  # a trace may miss the first launches after it starts
        raise AssertionError(f"the trace holds {len(ev)} kernels for {iters} rounds of {per_round}")
    ev = ev[len(ev) - rounds * per_round:]
    out = []
    for c in range(len(calls)):
        groups = [ev[r * per_round + c * per_call: r * per_round + (c + 1) * per_call]
                  for r in range(rounds)]
        kernels = [_median([g[j][1] - g[j][0] for g in groups]) for j in range(per_call)]
        busy = _median([sum(e - max(s, g[j - 1][1] if j else s)
                            for j, (s, e) in enumerate(g) if e > (g[j - 1][1] if j else s))
                        for g in groups])
        out.append((kernels, busy, _median([g[-1][1] - g[0][0] for g in groups])))
    return out


def _enc_case(pk, B, T, rn):
    """Random windows for an encoder pack, in its compute dtype."""
    return rn(B, T, pk[1]["K"] * pk[1]["Cin"]).to(pk[1]["cdt"])


def _dec_case(pk, B, T, rn, has_prev):
    """Random x, skip and prev (or None) for a decoder pack, in its compute dtype."""
    cdt, C_in, SC = pk[1]["cdt"], pk[1]["Cx"], pk[1]["S"] * pk[1]["Cout"]
    x, skip = rn(B, T, C_in).to(cdt), rn(B, T, C_in).to(cdt)
    return x, skip, (rn(B, 1, SC).to(cdt) if has_prev else None)


def _check_enc(rep, sf, win, pk, label):
    cdt = pk[1]["cdt"]
    got = sf.fused_encoder_level(win, *pk)
    if cdt == torch.float32:
        ref = sf.fused_encoder_level_plain(win, *pk)
    else:
        ref = sf.fused_encoder_level_plain(win.to(cdt).float(), *_fp32_pack(pk))
    rep.check("fused_encoder_level", label, got, ref,
              FP32_TOL if cdt == torch.float32 else BF16_TOL)


def _check_dec(rep, sf, x, skip, prev, pk, relu, label):
    cdt = pk[1]["cdt"]
    out, tail = sf.fused_decoder_level(x, skip, prev, *pk, relu=relu)
    if cdt == torch.float32:
        r_out, r_tail = sf.fused_decoder_level_plain(x, skip, prev, *pk, relu=relu)
    else:
        r_out, r_tail = sf.fused_decoder_level_plain(
            x.float(), skip.float(), None if prev is None else prev.float(),
            *_fp32_pack(pk), relu=relu)
    tol = FP32_TOL if cdt == torch.float32 else BF16_TOL
    rep.check("fused_decoder_level", label + " out", out, r_out, tol)
    rep.check("fused_decoder_level", label + " tail", tail, r_tail, tol)


def _level_bytes(sf, pk, *tensors):
    """Bytes a level call must move: its weights and biases once (at their
    logical size, without the pack's padding) and the tensors given."""
    return _nbytes(*sf.unpack_level(*pk).values(), *tensors)


def check_fused(dev, cfg, params, rep: Report, smi):
    """K3/K4 at every E8 level at block 1 (T = 2^(7-i) tokens at encoder
    level i), fp32 and bf16 packs, with and without a decoder prev tail; at
    batch 2 and 8 on the four deepest levels; on the ragged levels of the
    pruned checkpoint; a repeated call bit for bit; then their times."""
    from cleanumamba_tpu_torch.ops.cuda import stream_fused as sf
    from cleanumamba_tpu_torch.params import load_checkpoint

    D, S = cfg.encoder_n_layers, cfg.stride
    g = torch.Generator().manual_seed(2)
    rn = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev)  # noqa: E731
    enc_pk, dec_pk = {}, {}
    enc_calls, dec_calls = [], []
    for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        enc_pk[cdt_name] = [sf.pack_encoder_level(ep, cfg, i, cdt)
                            for i, ep in enumerate(params["encoder"])]
        dec_pk[cdt_name] = [sf.pack_decoder_level(dp, cfg, D - 1 - j, cdt)
                            for j, dp in enumerate(params["decoder"])]
        for i, pk in enumerate(enc_pk[cdt_name]):
            T = S ** (D - 1 - i)
            win32 = rn(1, T, pk[1]["K"] * pk[1]["Cin"])
            acts = (("fp32", torch.float32),) if cdt == torch.float32 else (
                ("bf16", torch.bfloat16), ("fp32", torch.float32))
            for act_name, adt in acts:
                win = win32.to(adt)
                _check_enc(rep, sf, win, pk, f"level {i} T={T} pack={cdt_name} act={act_name}")
                if act_name == cdt_name == "bf16":
                    enc_calls.append((win, pk))
        for j, pk in enumerate(dec_pk[cdt_name]):
            T = S ** j
            for has_prev in (False, True):
                x, skip, prev = _dec_case(pk, 1, T, rn, has_prev)
                _check_dec(rep, sf, x, skip, prev, pk, j != D - 1,
                           f"level {j} T={T} pack={cdt_name} prev={has_prev}")
                if has_prev and cdt_name == "bf16":
                    dec_calls.append((x, skip, prev, pk, j != D - 1))

    # batch 2 and 8 at the four deepest levels (the levels that stream megabytes)
    deep_enc, deep_dec = [], []
    for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for B in (2, 8):
            for i in range(D - 4, D):
                T, pk = S ** (D - 1 - i), enc_pk[cdt_name][i]
                win = _enc_case(pk, B, T, rn)
                _check_enc(rep, sf, win, pk, f"level {i} B={B} T={T} pack={cdt_name}")
                if B == 8 and cdt_name == "bf16":
                    deep_enc.append((win, pk))
            for j in range(4):
                T, pk = S ** j, dec_pk[cdt_name][j]
                for has_prev in (False, True):
                    x, skip, prev = _dec_case(pk, B, T, rn, has_prev)
                    _check_dec(rep, sf, x, skip, prev, pk, True,
                               f"level {j} B={B} T={T} pack={cdt_name} prev={has_prev}")
                    if B == 8 and has_prev and cdt_name == "bf16":
                        deep_dec.append((x, skip, prev, pk, True))

    # ragged widths: every level of the pruned checkpoint (channel counts that
    # are no multiple of 8), batch 2
    cfg_r, params_r = load_checkpoint(CKPT, dev)
    Dr, Sr = cfg_r.encoder_n_layers, cfg_r.stride
    widths = []
    for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for i, ep in enumerate(params_r["encoder"]):
            pk = sf.pack_encoder_level(ep, cfg_r, i, cdt)
            T = Sr ** (Dr - 1 - i)
            win = _enc_case(pk, 2, T, rn)
            _check_enc(rep, sf, win, pk, f"pruned level {i} B=2 T={T} "
                       f"({pk[1]['Cin']}->{pk[1]['C']}->{pk[1]['C2'] // 2}) pack={cdt_name}")
            widths.append(pk[1]["C"])
        for j, dp in enumerate(params_r["decoder"]):
            pk = sf.pack_decoder_level(dp, cfg_r, Dr - 1 - j, cdt)
            T = Sr ** j
            x, skip, prev = _dec_case(pk, 2, T, rn, True)
            _check_dec(rep, sf, x, skip, prev, pk, j != Dr - 1,
                       f"pruned level {j} B=2 T={T} ({pk[1]['Cx']}->{pk[1]['C']}->"
                       f"{pk[1]['Cout']}) pack={cdt_name}")
    if all(w % 8 == 0 for w in widths):
        raise AssertionError(f"{CKPT}: no ragged width among {widths}")

    # the same inputs give the same bits: one K3 and one K4 call repeated
    win, pk = enc_calls[D - 1]
    first = sf.fused_encoder_level(win, *pk).clone()
    for _ in range(3):
        if not torch.equal(sf.fused_encoder_level(win, *pk), first):
            raise AssertionError("fused_encoder_level: a repeated call differs")
    x, skip, prev, pk, relu = deep_dec[1]
    first = [t.clone() for t in sf.fused_decoder_level(x, skip, prev, *pk, relu=relu)]
    for _ in range(3):
        again = sf.fused_decoder_level(x, skip, prev, *pk, relu=relu)
        if not all(torch.equal(a, b) for a, b in zip(again, first)):
            raise AssertionError("fused_decoder_level: a repeated call differs")
    print("  K3 (level 7, B=1) and K4 (level 1, B=8): 3 repeated calls bitwise equal")

    # the other GLU gate activations (E8 uses Sigmoid): encoder level 4 and
    # its decoder level, fp32 packs
    for act in ("ReLU", "SiLU", "GELU"):
        cfg_a = dataclasses.replace(cfg, glu_activation=act)
        pk = sf.pack_encoder_level(params["encoder"][4], cfg_a, 4, torch.float32)
        win = _enc_case(pk, 1, S ** (D - 5), rn)
        _check_enc(rep, sf, win, pk, f"level 4 pack=fp32 act={act}")
        pk = sf.pack_decoder_level(params["decoder"][D - 5], cfg_a, 4, torch.float32)
        x, skip, prev = _dec_case(pk, 1, S ** (D - 5), rn, True)
        _check_dec(rep, sf, x, skip, prev, pk, True, f"level {D - 5} pack=fp32 act={act}")

    # bounds of the 8 levels together: windows/x/skip/prev and packs in, outputs
    # out; 2 operations per multiply-add of the level's products
    def enc_work(win, pk):
        M, w = win.shape[0] * win.shape[1], sf.unpack_level(*pk)
        return (_level_bytes(sf, pk, win) + M * (pk[1]["C2"] // 2) * 2,
                2 * M * (w["cw"].numel() + w["mwa"].numel() + w["mwb"].numel()))

    def dec_work(x, skip, prev, pk):
        M, w = x.shape[0] * x.shape[1], sf.unpack_level(*pk)
        return (_level_bytes(sf, pk, x, skip, prev)
                + (M + x.shape[0]) * S * pk[1]["Cout"] * 2,
                2 * M * sum(w[k].numel() for k in ("mwa", "mwb", "cwlo", "cwhi")))

    enc_w = [enc_work(win, pk) for win, pk in enc_calls]
    dec_w = [dec_work(x, s, p, pk) for x, s, p, pk, _ in dec_calls]
    rep.bound["fused_encoder_level"] = _bound(
        sum(b for b, _ in enc_w), sum(f for _, f in enc_w), torch.bfloat16)
    rep.bound["fused_decoder_level"] = _bound(
        sum(b for b, _ in dec_w), sum(f for _, f in dec_w), torch.bfloat16)

    # device time per level from a trace: rounds of one frame's 16 level calls
    def enc_fn(win, pk):
        return lambda: sf.fused_encoder_level(win, *pk)

    def dec_fn(x, s, p, pk, r):
        return lambda: sf.fused_decoder_level(x, s, p, *pk, relu=r)

    frame = [enc_fn(*c) for c in enc_calls] + [dec_fn(*c) for c in dec_calls]
    total = {}
    for B, calls, work, levels in (
            (1, frame, enc_w + dec_w, list(range(D)) + list(range(D))),
            (8, [enc_fn(*c) for c in deep_enc] + [dec_fn(*c) for c in deep_dec],
             [enc_work(*c) for c in deep_enc] + [dec_work(*c[:4]) for c in deep_dec],
             list(range(D - 4, D)) + list(range(4)))):
        n_enc = len(calls) // 2
        for c, ((kernels, busy, span), (nb, _), lvl) in enumerate(
                zip(_trace_calls(calls, 2), work, levels)):
            name = "K3" if c < n_enc else "K4"
            total[name, B] = total.get((name, B), 0.0) + busy
            print(f"  {name} level {lvl} B={B} bf16, device us from a trace on {smi}: "
                  f"launch 1 {kernels[0]:.2f}, launch 2 {kernels[1]:.2f}, busy {busy:.2f}, first "
                  f"start to last end {span:.2f}; must move {nb / 1e6:.3f} MB: "
                  f"{nb / busy / 1e3:.1f} GB/s")
    kernels, busy, span = _trace_calls([lambda: sf.empty_launches(16, dev)], 16)[0]
    print(f"  16 empty launches on one stream, device us on {smi}: busy {busy:.2f} "
          f"({_median(kernels):.2f} per launch: the floor that 8 levels x 2 launches set), first "
          f"start to last end {span:.2f} (the pace at which the host sends them)")

    # host cost of a wrapper call, and the loop of wrapper calls timed with
    # events: both read the host's launch rate, not the kernels
    def host_us(calls, rounds=20):  # few enough launches that the queue never fills
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            for fn in calls:
                fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / (rounds * len(calls)) * 1e6

    checks = [lambda pk=c[-1]: sf.check_pack(*pk) for c in enc_calls] + [
        lambda pk=c[3]: sf.check_pack(*pk) for c in dec_calls]
    print(f"  host us per wrapper call (enqueue only, 8 levels x 20 rounds): "
          f"K3 {host_us(frame[:D]):.2f}, K4 {host_us(frame[D:]):.2f}; the check of the pack's "
          f"tensors, made once at pack time and no longer in every call, takes "
          f"K3 {host_us(checks[:D]):.2f}, K4 {host_us(checks[D:]):.2f} a level")
    plains = (
        lambda: [sf.fused_encoder_level_plain(win, *pk) for win, pk in enc_calls],
        lambda: [sf.fused_decoder_level_plain(x, s, p, *pk, relu=r)
                 for x, s, p, pk, r in dec_calls])
    for name, short, thunks, plain in (("fused_encoder_level", "K3", frame[:D], plains[0]),
                                       ("fused_decoder_level", "K4", frame[D:], plains[1])):
        loop_ms = _time_ms(lambda: [fn() for fn in thunks])
        plain_ms = _time_ms(plain)
        rep.ms[name] = (total[short, 1] / 1e3, plain_ms)
        print(f"  {name} all 8 E8 levels at block 1, bf16, on {smi}: device "
              f"{total[short, 1] / 1e3:.4f} ms (trace; B=8 levels 4-7: "
              f"{total[short, 8] / 1e3:.4f} ms), plain {plain_ms:.4f} ms; a loop of wrapper "
              f"calls timed with events (the host's launch rate): {loop_ms:.4f} ms")


# --------------------------------------------------------------------------
# Phase 4: the E8 slice
# --------------------------------------------------------------------------

def _finite(name, t):
    if not torch.isfinite(t.float()).all():
        raise AssertionError(f"{name}: non-finite output")


def run_slice(dev, cfg, params32, counters):
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.params import prepare_weight_view
    from cleanumamba_tpu_torch.streaming import Streamer, stream_prime, stream_step_block

    params16 = prepare_weight_view(params32, "bf16")[0]
    ts, fl = cfg.total_stride, cfg.frame_length
    n_blocks, per_block = 64, 16
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        (rng.normal(size=(1, fl + n_blocks * per_block * ts)) * 0.1).astype(np.float32)).to(dev)

    for c in counters:
        c.launches = 0

    # offline forward, 1 s at batch 1
    x = audio[:, :SR]
    y = forward(params16, x, cfg)
    torch.cuda.synchronize()
    _finite("offline forward", y)
    if tuple(y.shape) != tuple(x.shape):
        raise AssertionError(f"offline forward: shape {tuple(y.shape)} != {tuple(x.shape)}")
    print(f"  offline forward 1 s batch 1: shape {tuple(y.shape)}, finite")

    # block streaming, bf16 activations, 16-frame blocks
    dt = torch.bfloat16
    state, out = stream_prime(params16, cfg, audio[:, :fl], dt)
    blocks = [audio[:, fl + b * per_block * ts: fl + (b + 1) * per_block * ts]
              for b in range(n_blocks)]
    state, out = stream_step_block(params16, cfg, state, blocks[0], dt)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for blk in blocks[1:]:
        state, out = stream_step_block(params16, cfg, state, blk, dt)
        outs.append(out)
    torch.cuda.synchronize()
    t_block = time.perf_counter() - t0
    _finite("stream_step_block", torch.cat(outs, dim=1))
    rtf16 = (n_blocks - 1) * per_block * ts / SR / t_block
    print(f"  stream_step_block: {n_blocks} blocks of {per_block} frames, bf16, finite")

    # Streamer at block 1 (fused levels), then one multi-frame feed
    s = Streamer(params32, cfg, dev, dtype=dt, weights="bf16")
    if s.fused_mode != "fused":
        raise AssertionError(f"Streamer on CUDA: fused_mode={s.fused_mode!r}")
    a = audio.cpu().numpy()
    got = [s.feed(a[:, :fl])]
    n_single = 48
    pos = fl
    got.append(s.feed(a[:, pos: pos + ts]))  # warm-up frame
    pos += ts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_single):
        got.append(s.feed(a[:, pos: pos + ts]))
        pos += ts
    t_single = time.perf_counter() - t0
    got.append(s.feed(a[:, pos: pos + per_block * ts]))
    got = np.concatenate(got, axis=1)
    if not np.isfinite(got).all() or got.shape[1] != (n_single + 2 + per_block) * ts:
        raise AssertionError(f"Streamer: bad output {got.shape}")
    rtf1 = n_single * ts / SR / t_single
    print(f"  Streamer: {n_single} single-frame feeds + one {per_block}-frame feed, finite")

    launches = {c.__name__: c.launches for c in counters}
    print(f"  kernel launches on the slice: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the serving path")
    return launches, rtf16, rtf1


def check_block_equals_steps(dev, cfg, params32):
    """fp32: 2 blocks of 16 frames through stream_step_block == 32 single
    stream_steps through the fused levels (K3/K4)."""
    from cleanumamba_tpu_torch.ops.cuda.stream_fused import pack_stream_params
    from cleanumamba_tpu_torch.streaming import stream_prime, stream_step, stream_step_block

    ts, fl = cfg.total_stride, cfg.frame_length
    rng = np.random.default_rng(3)
    audio = torch.from_numpy(
        (rng.normal(size=(1, fl + 32 * ts)) * 0.1).astype(np.float32)).to(dev)
    packs = pack_stream_params(params32, cfg, torch.float32)
    state0, _ = stream_prime(params32, cfg, audio[:, :fl])
    st, blocks = state0, []
    for b in range(2):
        st, out = stream_step_block(params32, cfg, st, audio[:, fl + b * 16 * ts: fl + (b + 1) * 16 * ts])
        blocks.append(out)
    st, singles = state0, []
    for f in range(32):
        st, out = stream_step(params32, cfg, st, audio[:, fl + f * ts: fl + (f + 1) * ts],
                              packs=packs)
        singles.append(out)
    err, rel = _rel_err(torch.cat(blocks, 1), torch.cat(singles, 1))
    print(f"  fp32 2x16-frame blocks vs 32 fused single steps: max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {FP32_TOL:g})")
    if not rel <= FP32_TOL:
        raise AssertionError("block streaming != single steps")


def trace_block1(dev, cfg, params32, smi):
    """A profiler window of the E8 block-1 step through the K3/K4 packs (bf16
    weights and activations, batch 1): device-busy time, kernels and K3/K4
    device time per frame."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.ops.cuda.stream_fused import pack_stream_params
    from cleanumamba_tpu_torch.params import prepare_weight_view
    from cleanumamba_tpu_torch.streaming import stream_prime, stream_step

    view = prepare_weight_view(params32, "bf16")[0]
    packs = pack_stream_params(view, cfg, torch.bfloat16)
    ts, fl = cfg.total_stride, cfg.frame_length
    n_warm, n_prof = 10, 40
    audio = _noise(dev, 1, fl + (n_warm + n_prof) * ts, seed=4, scale=0.1)
    state, _ = stream_prime(view, cfg, audio[:, :fl], torch.bfloat16)

    def step(t):
        return stream_step(view, cfg, state, audio[:, fl + t * ts: fl + (t + 1) * ts],
                           torch.bfloat16, packs=packs)

    for t in range(n_warm):
        state, _ = step(t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n_warm, n_warm + n_prof):
            state, _ = step(t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n_kernels = _device_busy(prof)
    fused = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in FUSED_KERNELS)) / 1e3
    os.makedirs("profiles", exist_ok=True)
    with open("profiles/block1_step_profile.txt", "w") as f:
        f.write(f"{smi}\n{prof.key_averages().table(sort_by='cuda_time_total', row_limit=30)}\n")
    print(f"  E8 block-1 stream_step through K3/K4 traced, bf16 B=1, {n_prof} frames on {smi}: "
          f"wall {wall / n_prof:.4f} ms/frame, device busy {busy / n_prof:.4f} ms/frame (idle "
          f"share {1 - busy / wall:.3f}), {n_kernels / n_prof:.1f} kernels/frame, K3 + K4 "
          f"{fused / n_prof:.4f} ms of device time per frame (the sum of their kernels)")


def trace_offline(dev, cfg, params32, smi):
    """The offline forward on 10 s at batch 2 (K1 at L = 625 in every
    bottleneck layer), fp32 and bf16 weights: wall per forward, and from a
    profiler window device-busy time, kernels and K1's device time."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.params import prepare_weight_view

    x = _noise(dev, 2, 10 * SR, seed=5, scale=0.1)
    n_prof = 5
    for name, params in (("fp32", params32), ("bf16", prepare_weight_view(params32, "bf16")[0])):
        with torch.no_grad():
            for _ in range(3):
                y = forward(params, x, cfg)
            _finite(f"offline forward 10 s x 2 {name}", y)
            wall = _host_ms(lambda: forward(params, x, cfg), 10)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    forward(params, x, cfg)
                torch.cuda.synchronize()
                traced = (time.perf_counter() - t0) * 1e3
        busy, n_kernels = _device_busy(prof)
        k1 = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and "scan_fwd_kernel" in e.name]
        print(f"  offline forward 10 s x 2, {name} weights, on {smi}: wall {wall[len(wall) // 2]:.2f} "
              f"ms median of 10 ({wall[0]:.2f}-{wall[-1]:.2f}); traced {n_prof}: device busy "
              f"{busy / n_prof:.3f} ms per forward (idle share {1 - busy / traced:.3f}), "
              f"{n_kernels / n_prof:.0f} kernels, K1 {len(k1) / n_prof:.0f} launches of "
              f"{_median(k1):.2f} us, {sum(k1) / n_prof / 1e3:.4f} ms per forward")


def check_real_weights(dev):
    """The released pruned checkpoint, fp32: streamed == offline on the input
    extended with zeros (the tolerance of tests/test_streaming.py)."""
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.params import load_checkpoint
    from cleanumamba_tpu_torch.streaming import Streamer

    cfg, params = load_checkpoint(CKPT, dev)
    cfg = dataclasses.replace(cfg, normalize_input=False)
    L = 12000
    x = (np.random.default_rng(0).normal(size=(1, L)) * 0.1).astype(np.float32)
    x_ext = torch.from_numpy(np.pad(x, ((0, 0), (0, 1000)))).to(dev)
    offline = forward(params, x_ext, cfg)[:, :L].cpu().numpy()
    s = Streamer(params, cfg, dev, fused=True)  # the per-level kernels (K3/K4); K5: phase 11
    outs, pos = [], 0
    for n in (1000, 256, 256, 3000, 256, 4096, 256, 256, L):  # single and block feeds
        outs.append(s.feed(x[:, pos: pos + n]))
        pos += n
        if pos >= L:
            break
    outs.append(s.flush())
    streamed = np.concatenate(outs, axis=1)
    if not (np.isfinite(offline).all() and np.isfinite(streamed).all()):
        raise AssertionError("real weights: non-finite output")
    np.testing.assert_allclose(streamed, offline, atol=2e-4, rtol=1e-3)
    print(f"  {CKPT}: offline and streamed finite, streamed == offline "
          f"(max_abs_err={np.abs(streamed - offline).max():.3e}, atol 2e-4 rtol 1e-3)")


# --------------------------------------------------------------------------
# Phase 6: K2 and K1's chunk states against their plain versions
# --------------------------------------------------------------------------

GRAD_NAMES = ("gu", "gdt", "gA", "gB", "gC", "gD", "gh0")


def check_scan_bwd(dev, rep: Report):
    """K2 (and the chunk states K1 hands it) against the plain versions: all
    seven gradients at every lane split, d_state 1..128, batch 1, 2 and 8,
    L from 1 to 2,500, ragged widths, h0 and gh_last zero and non-zero, a
    repeated call bit for bit."""
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

    g = torch.Generator().manual_seed(6)
    cases = [(*TRAIN_SHAPE, False), (1, 37, 48, 8, True), (*SERVE_SHAPE, True),
             (8, 17, 2048, 64, True), (1, 2500, 2048, 64, True), (2, 15, 512, 128, True),
             (1, 1, 2048, 16, True), (8, 16, 256, 8, True), (1, 5, 33, 1, True),
             (2, 40, 130, 100, True), (8, 33, 2048, 16, True), (2, 625, 512, 128, True)]
    cases += [(2, 40, di, 64, True) for di in _pruned_d_inner(dev)]
    lanes_seen = set()
    for Bsz, L, Di, Ds, state in cases:
        chunk = kscan.scan_chunk(Bsz, Di, Ds)
        lanes_seen.add(kscan.scan_plan(Bsz, Di, Ds, bwd=True).lanes)
        for dt_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            a = _scan_inputs(g, dev, Bsz, L, Di, Ds, dtype, state)
            args = [a[k] for k in SCAN_ARGS]
            _, _, hs = kscan.selective_scan(*args, return_starts=True)
            got = kscan.selective_scan_bwd(*args[:6], hs, a["gy"], a["gh_last"])
            f32 = [x.float() for x in args]
            _, _, hs_ref = kscan.plain_scan.selective_scan(*f32, chunk=chunk, return_starts=True)
            ref = kscan.plain_scan.selective_scan_bwd(
                *f32[:6], hs_ref, a["gy"].float(), a["gh_last"], chunk=chunk)
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            label = (f"B={Bsz} L={L} d_inner={Di} d_state={Ds} h0,gh_last={state} {dt_name} "
                     f"chunk={chunk}")
            for name, x, r in zip(GRAD_NAMES, got, ref):
                rep.check("selective_scan_bwd", f"{label} {name}", x, r, tol)
            _same_bits("selective_scan_bwd " + label, got,
                       kscan.selective_scan_bwd(*args[:6], hs, a["gy"], a["gh_last"]))
    if lanes_seen != set(kscan.LANE_CHOICES):
        raise AssertionError(f"the cases reach lane splits {lanes_seen} of {kscan.LANE_CHOICES}")
    print(f"  selective_scan_bwd: {len(cases)} shapes x 2 dtypes, all seven gradients of a "
          f"repeated call bitwise equal; lane splits {sorted(lanes_seen)}")


# --------------------------------------------------------------------------
# Phase 7: the E8 training slice
# --------------------------------------------------------------------------

def _device_busy(prof) -> tuple:
    """(union of CUDA kernel intervals in ms, number of kernels) in a trace."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return busy / 1e3, len(spans)


def run_training(dev, cfg, smi, counters):
    from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.train.optim import make_optimizer
    from cleanumamba_tpu_torch.train.trainer import make_train_step

    opt_cfg = OptimizationConfig()  # adam, lr 1e-4, bf16
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    optimizer = make_optimizer(opt_cfg, schedule=lambda s: opt_cfg.learning_rate)
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, LossConfig(), optimizer, bf16=opt_cfg.bf16)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, L = 2, 10 * SR

    def batch():
        clean, noisy = synth_batch(gen, B, L)
        return clean.reshape(1, B, L), noisy.reshape(1, B, L)

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n_fresh, times = 4, []
    for i in range(n_fresh):
        b = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, aux = step(params, opt_state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not bool(aux["grads_finite"]):
            raise AssertionError(f"training step {i}: non-finite gradients")
        print(f"  fresh batch step {i}: loss={float(aux['loss']):.4f} "
              f"gnorm={float(aux['grad_norm']):.3f} {times[-1]:.1f} ms", flush=True)
    fixed, losses = batch(), []
    for i in range(12):
        params, opt_state, aux = step(params, opt_state, fixed)
        if not bool(aux["grads_finite"]):
            raise AssertionError(f"repeated-batch step {i}: non-finite gradients")
        losses.append(float(aux["loss"]))
    print(f"  12 steps on one batch: loss {' '.join(f'{x:.4f}' for x in losses)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: {losses}")
    launches = {c.__name__: c.launches for c in counters}
    print(f"  kernel launches on the training slice: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the training path")
    peak = torch.cuda.max_memory_allocated()

    # a short trace: device-busy share and kernels per step
    from torch.profiler import ProfilerActivity, profile

    n_prof = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            params, opt_state, aux = step(params, opt_state, fixed)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n_kernels = _device_busy(prof)
    scan_ms = {}
    for e in prof.events():  # K1's and K2's share of the step's device time
        if e.device_type == torch.autograd.DeviceType.CUDA and "scan_" in e.name:
            name = e.name.split("<")[0].split("::")[-1].split(" ")[-1]
            n, ms = scan_ms.get(name, (0, 0.0))
            scan_ms[name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs("profiles", exist_ok=True)
    with open("profiles/train_step_profile.txt", "w") as f:
        f.write(f"{smi}\n{table}\n")
    steady = sorted(times[1:])
    median = steady[len(steady) // 2]
    # the profiler slows the host, so the idle share is given against both walls
    print(f"  E8 bf16 train step, batch 2 x 10 s, on {smi}: "
          f"{median:.1f} ms median of steps 1-{n_fresh - 1} "
          f"({' '.join(f'{t:.1f}' for t in times)} ms); peak memory {peak / 2**30:.2f} GiB; "
          f"traced {n_prof} steps: wall {wall / n_prof:.1f} ms/step, device busy "
          f"{busy / n_prof:.1f} ms/step (idle share {1 - busy / wall:.3f} traced, "
          f"{1 - busy / n_prof / median:.3f} against the untraced median), "
          f"{n_kernels / n_prof:.0f} kernels/step; of the device time per step: "
          + ", ".join(f"{k} x{n / n_prof:.0f} {ms / n_prof:.4f} ms"
                      for k, (n, ms) in sorted(scan_ms.items())))
    return launches


# --------------------------------------------------------------------------
# Phase 8: whole-model gradient, card against CPU
# --------------------------------------------------------------------------

def check_model_grad(dev):
    from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.params import from_numpy, to_numpy, tree_leaves
    from cleanumamba_tpu_torch.train.trainer import make_grad_fn

    cfg = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=3, tsfm_n_layers=2,
                            tsfm_d_model=32, tsfm_n_head=4, tsfm_d_inner=64)
    weights = to_numpy(init_params(cfg, torch.Generator().manual_seed(8)))
    rng = np.random.default_rng(8)
    clean = (rng.normal(size=(1, 2, 4096)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    grad_fn = make_grad_fn(cfg, LossConfig(), bf16=False)
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = grad_fn(from_numpy(weights, d), torch.from_numpy(clean).to(d),
                              torch.from_numpy(noisy).to(d))
    (g_gpu, a_gpu), (g_cpu, a_cpu) = out["cuda"], out["cpu"]
    worst = 0.0
    leaves_gpu, leaves_cpu = tree_leaves(g_gpu), tree_leaves(g_cpu)
    for i, (x, r) in enumerate(zip(leaves_gpu, leaves_cpu)):
        _, rel = _rel_err(x.cpu(), r)
        worst = max(worst, rel)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"gradient leaf {i} {tuple(r.shape)}: relative error "
                                 f"{rel:.3e} > {GRAD_TOL:g}")
    _, loss_rel = _rel_err(a_gpu["loss"].cpu(), a_cpu["loss"])
    if not loss_rel <= FP32_TOL:
        raise AssertionError(f"loss: relative error {loss_rel:.3e} > {FP32_TOL:g}")
    print(f"  small fp32 model, L=4096: {len(leaves_cpu)} gradient leaves on the card "
          f"(K1/K2) vs the CPU (plain): worst relative error {worst:.3e} (tol {GRAD_TOL:g}), "
          f"loss {loss_rel:.3e} (tol {FP32_TOL:g})")


# --------------------------------------------------------------------------
# Phase 9: the training CLI
# --------------------------------------------------------------------------

def check_cli(dev):
    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.train.checkpoint import find_max_epoch, load_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp.json")
        with open(exp, "w") as f:
            json.dump({"network": "CleanUMamba", "exp_path": "e8",
                       "network_config": CleanUMambaConfig().to_reference_json()}, f)
        with open(os.path.join(root, "configs", "train_synth.json")) as f:
            conf = json.load(f)
        conf["train_config"]["log"]["directory"] = os.path.join(tmp, "logs")
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        base = [sys.executable, "-m", "cleanumamba_tpu_torch.cli.train", "-c", path, "-e", exp,
                "--synthetic", "--log-every", "1"]
        for max_iters, expect in ((3, "iter 2: loss="), (5, "resumed from iter 2")):
            t0 = time.perf_counter()
            proc = subprocess.run(base + ["--max-iters", str(max_iters)], cwd=root,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0 or expect not in proc.stdout:
                raise AssertionError(f"training CLI (--max-iters {max_iters}) failed:\n"
                                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("iter", "resumed"))]
            print(f"  cli --max-iters {max_iters} ({time.perf_counter() - t0:.1f} s): "
                  + " | ".join(lines))
        ck_dir = os.path.join(tmp, "logs", "e8", "checkpoint")
        last = find_max_epoch(ck_dir)
        if last != 4:
            raise AssertionError(f"expected checkpoint 4.pkl, newest is {last}")
        ck = load_checkpoint(os.path.join(ck_dir, f"{last}.pkl"), dev)
        x = torch.from_numpy(
            (np.random.default_rng(9).normal(size=(1, SR)) * 0.1).astype(np.float32)).to(dev)
        with torch.no_grad():
            y = forward(ck["params"], x, ck["config"])
        _finite("forward from the CLI's checkpoint", y)
        print(f"  checkpoint {last}.pkl (count {ck['opt_state']['count']}): forward on 1 s finite")


# --------------------------------------------------------------------------
# Phases 10-12: the small-model block-1 path through the whole-frame kernel (K5)
# --------------------------------------------------------------------------

FAMILIES = ("mamba", "mamba2", "lstm", "mamba_s4", "mha")
CKPTS = (CKPT, "artifacts/capstone_724k_scratch.pkl")


def _fullmini(family, **kw):
    """The released small geometry (0.43-0.45 M parameters)."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig

    return CleanUMambaConfig(channels_H=32, max_H=64, encoder_n_layers=8, tsfm_n_layers=3,
                             tsfm_n_head=8, tsfm_d_model=64, tsfm_d_inner=128,
                             bottleneck=family, **kw)


def _contiguous(state):
    from cleanumamba_tpu_torch.params import tree_map

    return tree_map(lambda t: t.contiguous(), state)


def _noise(dev, B, n, seed, scale=0.3):
    x = np.random.default_rng(seed).normal(size=(B, n)) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _mega_vs_plain(rep, label, params, cfg, cdt, B, dev, n_frames=8, wrap_ring=False):
    """n_frames consecutive frames: K5 and its plain version on the same
    inputs each frame (the plain version's state is the one carried):
    ``mega_stream_step`` on the frame, outputs and every new state leaf
    relative to that leaf's max|ref|, a repeated launch bitwise equal; and
    ``mega_stream_frame`` with the normalisation inside the launch: its new
    tail and frame count equal to the plain version's, its running std within
    the fp32 tolerance, everything else bitwise equal to ``mega_stream_step``
    on the frame divided by that std, its output (with an fp32 pack every
    leaf) within the tolerance of the plain version on that frame, a
    repeated launch bitwise equal.

    The output's error is taken relative to the larger of max|out| and the
    max of the last decoder level's new tail: the output is the overlap-add
    of two partial sums (lo taps + carried hi taps) of which that tail is
    one, and in a trained denoiser they cancel to ~1/200 (max|out| 4e-4
    beside a tail of 8e-2 on the pruned checkpoint), so the rounding of the
    partial sums sets the error (the plain version on the GPU and on the CPU
    then differ by 1.2-1.8e-4 of max|out| too, every state leaf by < 3e-6).
    The input is synthetic noisy speech (``synth_batch``)."""
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.ops.cuda.stream_mega import (
        mega_stream_frame,
        mega_stream_frame_ref,
        mega_stream_step,
        mega_stream_step_ref,
        pack_mega,
    )
    from cleanumamba_tpu_torch.params import prepare_weight_view, tree_leaves
    from cleanumamba_tpu_torch.streaming import stream_prime

    view = params if cdt == torch.float32 else prepare_weight_view(params, "bf16")[0]
    mega = pack_mega(view, cfg, cdt)
    if mega is None:
        raise AssertionError(f"{label}: the model does not pack")
    fl, ts = cfg.frame_length, cfg.total_stride
    _, audio = synth_batch(torch.Generator(device=dev).manual_seed(10), B, fl + n_frames * ts)
    state, _ = stream_prime(params, cfg, audio[:, :fl])
    state = _contiguous(state)
    if wrap_ring:  # a ring that has gone round: every slot written, pos past max_len
        bc = state["bottleneck"]
        g = torch.Generator().manual_seed(11)
        state["bottleneck"] = {
            "k": torch.randn(bc["k"].shape, generator=g).to(dev),
            "v": torch.randn(bc["v"].shape, generator=g).to(dev),
            "pos": torch.full_like(bc["pos"], bc["k"].shape[2] + 5)}
    tol = FP32_TOL if cdt == torch.float32 else BF16_TOL
    worst = 0.0

    def compare(what, t, got, ref, again, leaves=True):
        nonlocal worst
        y_k, upd_k = got
        y_r, upd_r = ref
        out_scale = max(y_r.abs().max().item(), upd_r["dec"][-1].abs().max().item())
        pairs = list(zip([y_k] + tree_leaves(upd_k), [y_r] + tree_leaves(upd_r),
                         [again[0]] + tree_leaves(again[1])))
        for i, (a, r, a2) in enumerate(pairs if leaves else pairs[:1]):
            if tuple(a.shape) != tuple(r.shape) or a.dtype != r.dtype:
                raise AssertionError(f"{label} {what}: leaf {tuple(a.shape)} {a.dtype} vs "
                                     f"{tuple(r.shape)} {r.dtype}")
            if not torch.equal(a, a2):
                raise AssertionError(f"{label} {what} frame {t}: leaf {i} differs between two "
                                     "launches on the same inputs")
            if r.numel() == 0:
                continue
            err, rel = _rel_err(a, r)
            if i == 0:
                rel = err / max(out_scale, 1e-30)
            worst = max(worst, rel)
            if a.is_floating_point():
                rep.err["mega_stream_step"] = max(rep.err.get("mega_stream_step", 0.0), err)
            if not rel <= tol:
                raise AssertionError(f"{label} {what} frame {t}: leaf {tuple(r.shape)} relative "
                                     f"error {rel:.3e} > {tol:g}")
        _finite(label, y_k)

    for t in range(n_frames):
        new = audio[:, fl + t * ts: fl + (t + 1) * ts]
        frame = torch.cat([state["input_tail"], new], 1).contiguous()
        upd_k, y_k = mega_stream_step(frame, state, *mega)
        again = mega_stream_step(frame, state, *mega)
        upd_r, y_r = mega_stream_step_ref(frame, state, *mega)
        torch.cuda.synchronize()
        compare("mega_stream_step", t, (y_k, upd_k), (y_r, upd_r), (again[1], again[0]))
        # the normalising contract: the new tail and count equal the plain
        # version's, the running std within the fp32 tolerance; the new state
        # and the output bit for bit those of the step contract on the frame
        # divided by that std, the output multiplied by it (the same kernel)
        full_k, yf_k = mega_stream_frame(state, new, *mega, cfg.normalize_input)
        full_r, _ = mega_stream_frame_ref(state, new, *mega, cfg.normalize_input)
        std = full_k["input_std"]
        err, rel = _rel_err(std, full_r["input_std"])
        if not (torch.equal(full_k["input_tail"], full_r["input_tail"])
                and torch.equal(full_k["frames"], full_r["frames"]) and rel <= FP32_TOL):
            raise AssertionError(f"{label} frame {t}: new tail, count or std (rel {rel:.3e}) "
                                 "differs from the plain version")
        x = frame / std if cfg.normalize_input else frame
        upd_s, y_s = mega_stream_step(x, state, *mega)
        upd_p, y_p = mega_stream_step_ref(x, state, *mega)
        if cfg.normalize_input:
            y_s, y_p = y_s * std, y_p * std
        for a, b in zip([yf_k] + tree_leaves({k: full_k[k] for k in upd_s}),
                        [y_s] + tree_leaves(upd_s)):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} frame {t}: the normalising contract differs from "
                                     "the step contract on the same normalised frame")
        # and against the plain version given the kernel's std: the output,
        # and with an fp32 pack every state leaf (with bf16 the last level's
        # tail on a trained model's normalised frame is a few values that
        # nearly cancel, and one bf16 rounding of a product's output moves it
        # by up to 3.1e-2 of its largest value; the step contract above holds
        # every leaf on the frame as it comes)
        again_f = mega_stream_frame(state, new, *mega, cfg.normalize_input)
        compare("mega_stream_frame", t, (yf_k, {k: full_k[k] for k in upd_p}), (y_p, upd_p),
                (again_f[1], {k: again_f[0][k] for k in upd_p}), leaves=cdt == torch.float32)
        state = _contiguous({**state, **upd_r, "input_tail": frame[:, ts:]})
    print(f"  mega_stream_step {label}: {n_frames} frames, worst leaf rel={worst:.3e} "
          f"(tol {tol:g}), repeated launches and the two contracts bitwise equal, pack "
          f"{sum(_nbytes(a) for a in mega[0].values()) / 1e6:.2f} MB")


def check_mega(dev, rep: Report):
    from cleanumamba_tpu_torch.models.cleanumamba import count_params, init_params
    from cleanumamba_tpu_torch.params import load_checkpoint

    models = {}
    for family in FAMILIES:
        cfg = _fullmini(family)
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        models[family] = (cfg, params)
        for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for B in (1, 2, 8):
                _mega_vs_plain(rep, f"FullMini {family} ({count_params(params):,} params) "
                               f"pack={cdt_name} B={B}", params, cfg, cdt, B, dev,
                               n_frames=8 if B < 8 else 3)
    cfg, params = models["mha"]
    _mega_vs_plain(rep, "FullMini mha ring wrapped pack=fp32 B=2", params, cfg, torch.float32,
                   2, dev, n_frames=3, wrap_ring=True)
    for path in CKPTS:
        cfg, params = load_checkpoint(path, dev)
        for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            _mega_vs_plain(rep, f"{path} pack={cdt_name} B=2", params, cfg, cdt, 2, dev)
    return models


def _stream(streamer, audio, hop):
    """Feed ``audio`` (numpy, (B, L)) hop by hop, flush; (output, frames stepped singly)."""
    outs = [streamer.feed(audio[:, i: i + hop]) for i in range(0, audio.shape[1], hop)]
    single = sum(1 for o in outs if o.shape[1] == hop) - 1  # the first is the prime
    outs.append(streamer.flush())
    return np.concatenate(outs, axis=1), single


def run_mega_path(dev, models, params_e8, cfg_e8, counters):
    """Phase 11.  Returns K5's launches on the path (all five families)."""
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.ops.cuda.stream_mega import mega_stream_step
    from cleanumamba_tpu_torch.params import load_checkpoint
    from cleanumamba_tpu_torch.streaming import Streamer

    audio = _noise(dev, 1, 2 * SR, seed=12, scale=0.1).cpu().numpy()
    total = 0
    for family, (cfg, params) in models.items():
        s = Streamer(params, cfg, fused="auto")  # the default device: the card
        if s.fused_mode != "mega" or s.device.type != "cuda":
            raise AssertionError(f"{family}: fused_mode={s.fused_mode!r} on {s.device}")
        mega_stream_step.launches = 0
        got, n_single = _stream(s, audio, cfg.total_stride)
        launched = mega_stream_step.launches
        ref, _ = _stream(Streamer(params, cfg, fused=False), audio, cfg.total_stride)
        if launched != n_single or launched <= 0:
            raise AssertionError(f"{family}: K5 launched {launched} times for {n_single} frames")
        if got.shape != audio.shape or not np.isfinite(got).all():
            raise AssertionError(f"{family}: bad output {got.shape}")
        err, rel = _rel_err(torch.from_numpy(got), torch.from_numpy(ref))
        if not rel <= FP32_TOL:
            raise AssertionError(f"{family}: mega vs plain stream_step rel {rel:.3e}")
        print(f"  Streamer(fused='auto') FullMini {family}: mode mega, {launched} K5 launches "
              f"for {n_single} frames stepped, 2 s finite, vs plain stream_step "
              f"max_abs_err={err:.3e} rel={rel:.3e} (tol {FP32_TOL:g})")
        total += launched

    cfg, params = load_checkpoint(CKPT, dev)
    cfg = dataclasses.replace(cfg, normalize_input=False)
    L = 12000
    x = _noise(dev, 1, L, seed=13, scale=0.1)
    offline = forward(params, torch.nn.functional.pad(x, (0, 1000)), cfg)[:, :L].cpu().numpy()
    s = Streamer(params, cfg, fused="auto")
    mega_stream_step.launches = 0
    streamed, n_single = _stream(s, x.cpu().numpy(), cfg.total_stride)
    if s.fused_mode != "mega" or mega_stream_step.launches != n_single:
        raise AssertionError(f"{CKPT}: mode {s.fused_mode}, {mega_stream_step.launches} launches")
    np.testing.assert_allclose(streamed, offline, atol=2e-4, rtol=1e-3)
    print(f"  {CKPT}: streamed through K5 ({n_single} frames) == offline forward "
          f"(max_abs_err={np.abs(streamed - offline).max():.3e}, atol 2e-4 rtol 1e-3)")
    total += mega_stream_step.launches

    for c in counters:
        c.launches = 0
    mega_stream_step.launches = 0
    s = Streamer(params_e8, cfg_e8, fused="auto")  # 41 M parameters: does not pack
    _stream(s, audio[:, : cfg_e8.frame_length + 4 * cfg_e8.total_stride], cfg_e8.total_stride)
    fused = {c.__name__: c.launches for c in counters}
    if s.fused_mode != "fused" or mega_stream_step.launches != 0 or min(fused.values()) <= 0:
        raise AssertionError(f"E8-full: mode {s.fused_mode!r}, launches {fused}, "
                             f"K5 {mega_stream_step.launches}")
    print(f"  E8-full Streamer(fused='auto'): mode fused, launches {fused}, K5 none")
    return total


def _host_ms(fn, iters):
    """Host-clock ms of each of ``iters`` calls, each ended by a synchronise."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def _mega_work(meta, arrays, B):
    """Operations of one frame from the pack's dims: 2 per multiply-add of
    every product (a level's weights are used by each of its T tokens, the
    bottleneck's once), one exp per SSM state element."""
    K, level = meta["K"], 0
    macs = 0
    for e in meta["enc"]:
        w = K * e["Cin"] * e["C"] + e["C"] * e["C2"]
        macs, level = macs + e["T"] * w, level + w
    for d in meta["dec"]:
        w = d["C"] * d["C2"] + (d["C2"] // 2) * K * d["Cout"]
        macs, level = macs + d["T"] * w, level + w
    macs += arrays["w"].numel() - level  # conv1, conv2 and the bottleneck's matrices
    macs += sum(4 * b["H"] * b["N"] * b["N"] for b in meta["bott"] if "N" in b)
    sfu = sum(b["d_inner"] * b["d_state"] for b in meta["bott"] if "d_state" in b)
    return 2 * B * macs, B * sfu


def _k5_names(fn):
    """The names of the K5 kernels that ``fn`` launches (by their signatures;
    a trace may miss the first launches after it starts, so 20 calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if "mega_kernel" in e.name}
    if not names:
        raise AssertionError("a trace of 20 calls holds no K5 launch")
    return names


def _k5_in_turns(fns, iters=30):
    """Device us per launch of each K5 variant in ``fns`` (label -> (call,
    the wrapper whose ``launches`` counts its launches)) from ONE trace of
    rounds in turns (a, b, b, a), each of ``iters`` launches; the variants
    are told apart by their kernels' names.  Each wrapper must count its
    2 * iters launches exactly; the trace may miss a few of them (CUPTI
    drops some kernel records), and the time is the mean of those it holds."""
    from torch.profiler import ProfilerActivity, profile

    names = {label: _k5_names(call) for label, (call, _) in fns.items()}
    if any(a & b for la, a in names.items() for lb, b in names.items() if la != lb):
        raise AssertionError(f"K5 variants share a kernel name: {names}")
    order = list(fns) + list(fns)[::-1]
    before = {label: wrapper.launches for label, (_, wrapper) in fns.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for label in order:
            for _ in range(iters):
                fns[label][0]()
        torch.cuda.synchronize()
    spans = {label: [] for label in fns}
    for e in prof.events():
        for label, ns in names.items():
            if e.name in ns:
                spans[label].append(e.time_range.end - e.time_range.start)
    for label, (_, wrapper) in fns.items():
        counted = wrapper.launches - before[label]
        if counted != 2 * iters or not spans[label]:
            raise AssertionError(f"{label}: {counted} launches counted of {2 * iters}, "
                                 f"{len(spans[label])} in the trace")
    return {label: sum(sp) / len(sp) for label, sp in spans.items()}


def time_mega(dev, models, rep: Report, smi, base=None):
    """Phase 12: ms per frame of the four block-1 steps, FullMini mamba and mha;
    K5's device time per family, pack, batch, depth and width; with ``base``
    (the parent's K5 module) both kernels in one trace."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.ops.cuda.stream_fused import pack_stream_params
    from cleanumamba_tpu_torch.ops.cuda.stream_mega import (
        mega_stream_step,
        mega_stream_step_ref,
        pack_mega,
    )
    from cleanumamba_tpu_torch.params import prepare_weight_view, tree_leaves
    from cleanumamba_tpu_torch.streaming import (
        Streamer,
        stream_prime,
        stream_step,
        stream_step_mega,
    )

    n = 200
    for family in ("mamba", "mha"):
        cfg, params = models[family]
        fl, ts = cfg.frame_length, cfg.total_stride
        audio = _noise(dev, 1, fl + ts, seed=14)
        new = audio[:, fl:]
        state, _ = stream_prime(params, cfg, audio[:, :fl])
        state = _contiguous(state)
        frame = torch.cat([state["input_tail"], new], 1).contiguous()
        for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            view = params if cdt == torch.float32 else prepare_weight_view(params, "bf16")[0]
            mega = pack_mega(view, cfg, cdt)
            packs = pack_stream_params(view, cfg, cdt)
            runs = {
                "K5 alone": lambda: mega_stream_step(frame, state, *mega),
                "K5 plain version": lambda: mega_stream_step_ref(frame, state, *mega),
                "stream_step_mega": lambda: stream_step_mega(cfg, state, new, mega),
                "stream_step K3/K4": lambda: stream_step(view, cfg, state, new, packs=packs),
                "stream_step plain": lambda: stream_step(view, cfg, state, new),
            }
            ms = {k: _time_ms(fn, iters=n, warmup=10) for k, fn in runs.items()}
            wall = {k: _host_ms(runs[k], n) for k in ("stream_step_mega", "stream_step K3/K4")}
            print(f"  FullMini {family} {cdt_name} B=1, ms per frame over {n} frames on {smi}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + "; synced wall median/p90: "
                  + ", ".join(f"{k} {v[n // 2]:.4f}/{v[n * 9 // 10]:.4f}"
                              for k, v in wall.items()))
            if family == "mamba" and cdt == torch.float32:
                plain_ms = ms["K5 plain version"]
                upd, y = mega_stream_step(frame, state, *mega)
                flops, sfu = _mega_work(mega[1], mega[0], 1)
                rep.bound["mega_stream_step"] = _bound(
                    _nbytes(frame, y, *mega[0].values(), *tree_leaves(upd),
                            *state["enc"], *state["dec"], *tree_leaves(state["bottleneck"])),
                    flops, cdt, sfu)

        # wall per Streamer.feed of one hop, host clock (each feed ends in a copy to the host)
        hops = _noise(dev, 1, fl + (n + 1) * ts, seed=15, scale=0.1).cpu().numpy()
        feeds = {}
        for mode in ("auto", True, False):
            s = Streamer(params, cfg, fused=mode)
            s.feed(hops[:, :fl])
            s.feed(hops[:, fl: fl + ts])  # warm-up frame
            times = []
            for i in range(1, n + 1):
                t0 = time.perf_counter()
                s.feed(hops[:, fl + i * ts: fl + (i + 1) * ts])
                times.append((time.perf_counter() - t0) * 1e3)
            times.sort()
            feeds[s.fused_mode] = (times[n // 2], times[n * 9 // 10])
        print(f"  FullMini {family} fp32 Streamer.feed per 256-sample hop, wall ms median/p90 "
              f"over {n} feeds on {smi}: "
              + ", ".join(f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in feeds.items()))

    # K5's device time per launch (from a trace) for every family, and how it
    # moves with depth, width and bottleneck layers: at depth D level i has
    # T = 2^(D-1-i) rows, so D - 1 halves the rows of every level
    def k5_device_us(label, cfg, params):
        mega = pack_mega(params, cfg, torch.float32)
        state, _ = stream_prime(params, cfg, torch.zeros(1, cfg.frame_length, device=dev))
        state, frame = _contiguous(state), _noise(dev, 1, cfg.frame_length, seed=17)
        for _ in range(5):
            mega_stream_step(frame, state, *mega)
        torch.cuda.synchronize()
        before = mega_stream_step.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(30):
                mega_stream_step(frame, state, *mega)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if "mega_kernel" in e.name]
        if mega_stream_step.launches - before != 30 or not spans:
            raise AssertionError(f"{label}: {mega_stream_step.launches - before} launches "
                                 f"counted of 30, {len(spans)} in the trace")
        return sum(spans) / len(spans)  # the launches the trace holds

    from cleanumamba_tpu_torch.models.cleanumamba import init_params

    readings = {family: k5_device_us(family, *models[family]) for family in FAMILIES}
    # K5's time in the summary line is its device time: a loop of wrapper calls
    # timed with events reads the host's launch rate when that is the slower
    rep.ms["mega_stream_step"] = (readings["mamba"] / 1e3, plain_ms)
    for label, kw in (("L=1", dict(tsfm_n_layers=1)), ("L=6", dict(tsfm_n_layers=6)),
                      ("D=7", dict(encoder_n_layers=7)), ("D=6", dict(encoder_n_layers=6)),
                      ("D=4", dict(encoder_n_layers=4)),
                      ("width 16..32", dict(channels_H=16, max_H=32)),
                      ("width 64..128", dict(channels_H=64, max_H=128))):
        cfg = dataclasses.replace(models["mamba"][0], **kw)
        readings[f"mamba {label}"] = k5_device_us(
            label, cfg, init_params(cfg, torch.Generator().manual_seed(0), dev))
    print(f"  K5 device us per launch, fp32 pack B=1 (FullMini: D=8, L=3, width 32..64) on "
          f"{smi}: " + ", ".join(f"{k} {v:.1f}" for k, v in readings.items()))

    # by batch and geometry; and, with the parent's kernel, both in one trace per case
    def k5_call(module, mega, cfg, params, B):
        state, _ = stream_prime(params, cfg, torch.zeros(B, cfg.frame_length, device=dev))
        state, frame = _contiguous(state), _noise(dev, B, cfg.frame_length, seed=18)
        return (lambda: module.mega_stream_step(frame, state, *mega)), module.mega_stream_step

    from cleanumamba_tpu_torch.ops.cuda import stream_mega as new_k5

    cases = [(f"{family} {cdt_name} B=1", models[family], cdt, 1) for family in FAMILIES
             for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16))]
    cases += [(f"mamba fp32 B={B}", models["mamba"], torch.float32, B) for B in (2, 8, 32)]
    for label, kw in (("D=4", dict(encoder_n_layers=4)),
                      ("width 16..32", dict(channels_H=16, max_H=32)),
                      ("width 64..128", dict(channels_H=64, max_H=128))):
        cfg = dataclasses.replace(models["mamba"][0], **kw)
        cases.append((f"mamba fp32 B=1 {label}", (cfg, init_params(
            cfg, torch.Generator().manual_seed(0), dev)), torch.float32, 1))
    turns = {}
    for label, (cfg, params), cdt, B in cases:
        view = params if cdt == torch.float32 else prepare_weight_view(params, "bf16")[0]
        mega = pack_mega(view, cfg, cdt)
        fns = {"new": k5_call(new_k5, mega, cfg, params, B)}
        if base is not None:
            fns["base"] = k5_call(base, mega, cfg, params, B)
        turns[label] = _k5_in_turns(fns)
    print(f"  K5 device us per launch{' (base and new in one trace, turns b n n b)' if base else ''}"
          f" on {smi}: " + "; ".join(
              f"{label} " + ", ".join(f"{k} {v:.2f}" for k, v in t.items())
              + (f" ({t['base'] / t['new']:.2f}x)" if "base" in t else "")
              for label, t in turns.items()))

    # a profiler window of the mega path (FullMini mamba, fp32, batch 1)
    cfg, params = models["mamba"]
    fl, ts = cfg.frame_length, cfg.total_stride
    mega = pack_mega(params, cfg, torch.float32)
    n_warm, n_prof = 10, 50
    audio = _noise(dev, 1, fl + (n_warm + n_prof) * ts, seed=16)
    state, _ = stream_prime(params, cfg, audio[:, :fl])
    for t in range(n_warm):
        state, _ = stream_step_mega(cfg, state, audio[:, fl + t * ts: fl + (t + 1) * ts], mega)
    torch.cuda.synchronize()
    before = mega_stream_step.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n_warm, n_warm + n_prof):
            state, out = stream_step_mega(cfg, state, audio[:, fl + t * ts: fl + (t + 1) * ts],
                                          mega)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the wrapper counts the launches; the trace (which may miss a few of
    # them) times them and must hold no other kernel
    launched = mega_stream_step.launches - before
    busy, n_kernels = _device_busy(prof)
    k5 = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "mega_kernel" in e.name]
    if launched != n_prof or not k5 or n_kernels != len(k5):
        raise AssertionError(f"{n_prof} frames: {launched} K5 launches counted, "
                             f"{n_kernels - len(k5)} other kernels in the trace; "
                             "stream_step_mega is one launch a frame")
    k5_ms = sum(k5) / len(k5) / 1e3
    os.makedirs("profiles", exist_ok=True)
    with open("profiles/mega_step_profile.txt", "w") as f:
        f.write(f"{smi}\n{prof.key_averages().table(sort_by='cuda_time_total', row_limit=30)}\n")
    print(f"  stream_step_mega traced, FullMini mamba fp32 B=1, {n_prof} frames on {smi}: wall "
          f"{wall / n_prof:.4f} ms/frame, {launched / n_prof:.2f} K5 launches a frame (counted by "
          f"the wrapper) and {n_kernels - len(k5)} other kernels among the {n_kernels} traced, "
          f"device busy {busy / len(k5):.4f} ms a traced frame (idle share "
          f"{1 - busy / len(k5) * n_prof / wall:.3f}), K5 {k5_ms:.4f} ms of device time per launch")


# --------------------------------------------------------------------------
# Phases 13-15: int8 weights in K3/K4, the int8 serving path, the multiplexer
# --------------------------------------------------------------------------

INT8_MIN_SIZE = 4096  # quant_min_size of Streamer and SessionMultiplexer


def _stored_level_bytes(sf, pk):
    """Bytes of a level pack's weights as they are stored (int8 values and
    their per-column scales, or bf16) and its biases, at their logical size."""
    arrays, meta = pk
    n = sum(arrays[k].numel() * 4 for k in sf._BIASES if k in arrays)
    kind, dims = sf._level_dims(meta)  # the output widths of the two products: dims[1:]
    for name, N in zip(("cw", "mw") if kind == "enc" else ("mw", "ctw"), dims[1:]):
        mats = sf._untile(arrays[name], N)
        n += sum(m.numel() * m.element_size() for m in mats)
        if name + "_scale" in arrays:
            n += len(mats) * N * 4
    return n


def _int8_levels(sf, cfg, q):
    """Every level of an int8 tree packed (bf16 compute): (encoder packs,
    decoder packs, levels whose two products mix a dense and an int8 weight)."""
    D = cfg.encoder_n_layers
    enc = [sf.pack_encoder_level(ep, cfg, i, torch.bfloat16) for i, ep in enumerate(q["encoder"])]
    dec = [sf.pack_decoder_level(dp, cfg, D - 1 - j, torch.bfloat16)
           for j, dp in enumerate(q["decoder"])]
    mixed = sum(len({w.dtype for w in sf._level_weights(a)}) == 2 for a, _ in enc + dec)
    return enc, dec, mixed


def check_fused_int8(dev, cfg, params32, rep: Report, smi):
    """Phase 13: K3/K4 with int8 weights (E8 quantized at min_size 4096, bf16
    compute) against their plain versions on the same pack: every level at
    block 1, batch 1, 2 and 8, the decoder with and without prev; every level
    of both pruned checkpoints, batch 2; a repeated call bit for bit.  Then
    the device time of one frame's 16 int8 level calls from a trace, beside
    the bf16 packs' 16 calls in the same trace, and the bounds."""
    from cleanumamba_tpu_torch.ops.cuda import stream_fused as sf
    from cleanumamba_tpu_torch.params import load_checkpoint, prepare_weight_view
    from cleanumamba_tpu_torch.quant import quantize_params

    D, S = cfg.encoder_n_layers, cfg.stride
    g = torch.Generator().manual_seed(13)
    rn = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev)  # noqa: E731
    names = ("fused_encoder_level_int8", "fused_decoder_level_int8")

    def check_level(kind, pk, B, T, has_prev, label, relu=True):
        """Kernel vs plain on one call; returns the call's inputs."""
        if kind == "enc":
            win = _enc_case(pk, B, T, rn)
            rep.check(names[0], label, sf.fused_encoder_level(win, *pk),
                      sf.fused_encoder_level_plain(win, *pk), BF16_TOL, quiet=True)
            return (win, pk)
        x, skip, prev = _dec_case(pk, B, T, rn, has_prev)
        got = sf.fused_decoder_level(x, skip, prev, *pk, relu=relu)
        want = sf.fused_decoder_level_plain(x, skip, prev, *pk, relu=relu)
        rep.check(names[1], label + " out", got[0], want[0], BF16_TOL, quiet=True)
        rep.check(names[1], label + " tail", got[1], want[1], BF16_TOL, quiet=True)
        return (x, skip, prev, pk, relu)

    enc, dec, mixed = _int8_levels(sf, cfg, quantize_params(params32, INT8_MIN_SIZE))
    if mixed < 2:
        raise AssertionError(f"E8 int8: {mixed} levels mix a dense and an int8 weight, expected 2")
    enc_calls, dec_calls, deep_dec = [], [], None
    for B in (1, 2, 8):
        for i, pk in enumerate(enc):
            call = check_level("enc", pk, B, S ** (D - 1 - i), False, f"level {i} B={B}")
            if B == 1:
                enc_calls.append(call)
        for j, pk in enumerate(dec):
            for has_prev in (False, True):
                call = check_level("dec", pk, B, S ** j, has_prev,
                                   f"level {j} B={B} prev={has_prev}", relu=j != D - 1)
                if B == 1 and has_prev:
                    dec_calls.append(call)
                if B == 8 and j == 1 and has_prev:
                    deep_dec = call
    print(f"  E8 int8 packs (min_size {INT8_MIN_SIZE}, {mixed} levels mixing dense and int8 "
          f"weights): 8 + 16 level calls at batch 1, 2 and 8 vs plain, max_abs_err K3 "
          f"{rep.err[names[0]]:.3e} K4 {rep.err[names[1]]:.3e} (tol {BF16_TOL:g} of max|ref|)")
    for ckpt in ("artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"):
        cfg_r, params_r = load_checkpoint(ckpt, dev)
        Dr, Sr = cfg_r.encoder_n_layers, cfg_r.stride
        enc_r, dec_r, mixed_r = _int8_levels(sf, cfg_r, quantize_params(params_r, INT8_MIN_SIZE))
        for i, pk in enumerate(enc_r):
            check_level("enc", pk, 2, Sr ** (Dr - 1 - i), False, f"{ckpt} level {i}")
        for j, pk in enumerate(dec_r):
            check_level("dec", pk, 2, Sr ** j, True, f"{ckpt} level {j}", relu=j != Dr - 1)
        if mixed_r < 1:
            raise AssertionError(f"{ckpt}: no level mixes dense and int8 weights")
        print(f"  {ckpt} int8 (ragged, {mixed_r} mixed levels): every level at B=2 vs plain, "
              f"passed (tol {BF16_TOL:g})")

    win, pk = enc_calls[D - 1]
    first = sf.fused_encoder_level(win, *pk).clone()
    x, skip, prev, dpk, relu = deep_dec
    first_dec = [t.clone() for t in sf.fused_decoder_level(x, skip, prev, *dpk, relu=relu)]
    for _ in range(3):
        again = sf.fused_decoder_level(x, skip, prev, *dpk, relu=relu)
        if not (torch.equal(sf.fused_encoder_level(win, *pk), first)
                and all(torch.equal(a, b) for a, b in zip(again, first_dec))):
            raise AssertionError("int8 K3/K4: a repeated call differs")
    print("  int8 K3 (level 7, B=1) and K4 (level 1, B=8): 3 repeated calls bitwise equal")

    # the bf16 packs of the same weights and inputs, for the same trace
    bf = prepare_weight_view(params32, "bf16")[0]
    bf_enc = [(w, sf.pack_encoder_level(bf["encoder"][i], cfg, i, torch.bfloat16))
              for i, (w, _) in enumerate(enc_calls)]
    bf_dec = [(x, s, p, sf.pack_decoder_level(bf["decoder"][j], cfg, D - 1 - j, torch.bfloat16), r)
              for j, (x, s, p, _, r) in enumerate(dec_calls)]

    def work(kind, call):
        pk = call[1] if kind == "enc" else call[3]
        w = sf.unpack_level(*pk)
        if kind == "enc":
            M = call[0].shape[0] * call[0].shape[1]
            return (_stored_level_bytes(sf, pk) + _nbytes(call[0]) + M * (pk[1]["C2"] // 2) * 2,
                    2 * M * (w["cw"].numel() + w["mwa"].numel() + w["mwb"].numel()))
        x = call[0]
        M = x.shape[0] * x.shape[1]
        return (_stored_level_bytes(sf, pk) + _nbytes(*call[:3])
                + (M + x.shape[0]) * S * pk[1]["Cout"] * 2,
                2 * M * sum(w[k].numel() for k in ("mwa", "mwb", "cwlo", "cwhi")))

    for name, kind, calls in ((names[0], "enc", enc_calls), (names[1], "dec", dec_calls)):
        wk = [work(kind, c) for c in calls]
        rep.bound[name] = _bound(sum(b for b, _ in wk), sum(f for _, f in wk), torch.bfloat16)
    mb = {k: sum(work(k, c)[0] for c in calls) / 1e6
          for k, calls in (("enc", enc_calls), ("dec", dec_calls))}
    mb_bf = {k: sum(work(k, c)[0] for c in calls) / 1e6
             for k, calls in (("enc", bf_enc), ("dec", bf_dec))}

    def enc_fn(win, pk):
        return lambda: sf.fused_encoder_level(win, *pk)

    def dec_fn(x, s, p, pk, r):
        return lambda: sf.fused_decoder_level(x, s, p, *pk, relu=r)

    frames = {"int8": [enc_fn(*c) for c in enc_calls] + [dec_fn(*c) for c in dec_calls],
              "bf16": [enc_fn(*c) for c in bf_enc] + [dec_fn(*c) for c in bf_dec]}
    traced = _trace_calls(frames["int8"] + frames["bf16"], 2)
    total = {}
    for c, (kernels, busy, span) in enumerate(traced):
        wt, rest = ("int8", c) if c < 2 * D else ("bf16", c - 2 * D)
        short = "K3" if rest < D else "K4"
        total[short, wt] = total.get((short, wt), 0.0) + busy
        if wt == "int8":
            print(f"  int8 {short} level {rest % D} B=1, device us on {smi}: launch 1 "
                  f"{kernels[0]:.2f}, launch 2 {kernels[1]:.2f}, busy {busy:.2f} (bf16 pack in the "
                  f"same trace: {traced[c + 2 * D][1]:.2f})")
    plains = (lambda: [sf.fused_encoder_level_plain(w, *pk) for w, pk in enc_calls],
              lambda: [sf.fused_decoder_level_plain(x, s, p, *pk, relu=r)
                       for x, s, p, pk, r in dec_calls])
    for name, short, kind, plain in ((names[0], "K3", "enc", plains[0]),
                                     (names[1], "K4", "dec", plains[1])):
        plain_ms = _time_ms(plain)
        rep.ms[name] = (total[short, "int8"] / 1e3, plain_ms)
        print(f"  {short} int8, all 8 E8 levels at block 1, on {smi}: device "
              f"{total[short, 'int8'] / 1e3:.4f} ms against the bf16 packs' "
              f"{total[short, 'bf16'] / 1e3:.4f} ms in the same trace; must move "
              f"{mb[kind]:.2f} MB (bf16 {mb_bf[kind]:.2f}); bound {rep.bound[name][0]:.4f} ms; "
              f"plain {plain_ms:.4f} ms")


def run_int8_streamer(dev, cfg, params32):
    """Phase 14: E8 ``Streamer(weights="int8", fused=True)`` over 2 s in
    256-sample hops and a flush: mode "fused", the int8 K3/K4 launched at every
    level of every frame stepped, the output equal to the same Streamer on the
    CPU (plain versions); "auto" with int8 resolves to "plain".  Returns the
    int8 K3/K4 launches of the run."""
    from cleanumamba_tpu_torch.ops.cuda import stream_fused as sf
    from cleanumamba_tpu_torch.params import to_device
    from cleanumamba_tpu_torch.streaming import Streamer

    D = cfg.encoder_n_layers
    audio = _noise(dev, 1, 2 * SR, seed=14, scale=0.1).cpu().numpy()
    s = Streamer(params32, cfg, weights="int8", fused=True)  # the default device: the card
    if s.fused_mode != "fused" or s.device.type != "cuda":
        raise AssertionError(f"int8 Streamer: fused_mode={s.fused_mode!r} on {s.device}")
    kernels = (sf.fused_encoder_level, sf.fused_decoder_level)
    for k in kernels:
        k.launches = k.int8_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, n_single = _stream(s, audio, cfg.total_stride)
    wall = time.perf_counter() - t0
    launches = {f"{k.__name__}_int8": k.int8_launches for k in kernels}
    dense = sum(k.launches for k in kernels)
    if any(n != D * n_single for n in launches.values()) or dense or n_single <= 0:
        raise AssertionError(f"int8 Streamer: launches {launches} (dense {dense}) for "
                             f"{n_single} frames of {D} levels")
    s_cpu = Streamer(to_device(params32, "cpu"), cfg, "cpu", weights="int8", fused=True)
    ref, _ = _stream(s_cpu, audio, cfg.total_stride)
    if got.shape != audio.shape or not np.isfinite(got).all():
        raise AssertionError(f"int8 Streamer: bad output {got.shape}")
    err, rel = _rel_err(torch.from_numpy(got), torch.from_numpy(ref))
    print(f"  E8 Streamer(weights='int8', fused=True): mode fused, {n_single} frames, launches "
          f"{launches}; 2 s + flush in {wall:.2f} s wall ({wall / n_single * 1e3:.2f} ms a hop); "
          f"vs the CPU's plain versions max_abs_err={err:.3e} rel={rel:.3e} (tol {BF16_TOL:g})")
    if not rel <= BF16_TOL:
        raise AssertionError(f"int8 Streamer on the card vs the CPU: rel {rel:.3e}")
    auto = Streamer(params32, cfg, weights="int8")
    if auto.fused_mode != "plain":
        raise AssertionError(f"int8 Streamer(fused='auto'): {auto.fused_mode!r}, expected 'plain'")
    print("  E8 Streamer(weights='int8') with fused='auto': mode plain (the JAX package's policy)")
    return launches


def _serve_solo(view, cfg, audio, dev):
    """One session streamed alone at batch 1 (prime and single steps)."""
    from cleanumamba_tpu_torch.streaming import stream_prime, stream_step

    fl, ts = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy(audio[None]).to(dev)
    state, out = stream_prime(view, cfg, x[:, :fl])
    outs, pos = [out[0]], fl
    while pos + ts <= audio.shape[0]:
        state, out = stream_step(view, cfg, state, x[:, pos:pos + ts])
        outs.append(out[0])
        pos += ts
    return torch.cat(outs).cpu().numpy()


def run_multiplexer(dev, cfg, params32, smi, scan):
    """Phase 15: ``SessionMultiplexer`` on E8 at full width.  Three staggered
    sessions (int8 weights, fp32 state) equal each streamed alone; slots 8 at
    block 16 (K1 launched) and slots 1 and 8 at block 1, each in bf16 and
    int8: traffic through the multiplexer (one tick a feed), its wall and
    device-busy per tick, and the batched step's throughput with every slot
    live (``cli/serve.py``'s bench, in process); then the serving CLIs as
    subprocesses.  Returns K1's launches on the multiplexer's block-16 runs."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.cli import serve as serve_cli
    from cleanumamba_tpu_torch.params import prepare_weight_view
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    fl, ts = cfg.frame_length, cfg.total_stride
    rng = np.random.default_rng(15)
    audios = [(rng.normal(size=fl + n * ts) * 0.1).astype(np.float32) for n in (10, 8, 6)]
    mux = SessionMultiplexer(params32, cfg, slots=4, weights="int8")
    if mux.device.type != "cuda":
        raise AssertionError(f"SessionMultiplexer on {mux.device}")
    sids = [mux.open() for _ in audios]
    outs = {s: [mux.feed(s, a[: fl + (2 - k) * ts])] for k, (s, a) in enumerate(zip(sids, audios))}
    pos = {s: fl + (2 - k) * ts for k, s in enumerate(sids)}
    while any(pos[s] < a.shape[0] for s, a in zip(sids, audios)):
        for k, (s, a) in enumerate(zip(sids, audios)):
            if pos[s] < a.shape[0]:
                nxt = min(pos[s] + (k + 1) * ts, a.shape[0])
                outs[s].append(mux.feed(s, a[pos[s]:nxt]))
                pos[s] = nxt
    stored, view = prepare_weight_view(params32, "int8")
    worst = 0.0
    for s, a in zip(sids, audios):
        got = np.concatenate(outs[s] + [mux._drain(s)])
        ref = _serve_solo(view(stored), cfg, a, dev)
        if got.shape != ref.shape:
            raise AssertionError(f"multiplexed session {s}: {got.shape} vs alone {ref.shape}")
        worst = max(worst, _rel_err(torch.from_numpy(got), torch.from_numpy(ref))[1])
    print(f"  3 staggered E8 sessions (int8, fp32 state, {mux.ticks} ticks) == each alone: "
          f"worst rel {worst:.3e} (tol {FP32_TOL:g}: batch width changes cuBLAS's sum order)")
    if not worst <= FP32_TOL:
        raise AssertionError("multiplexed sessions differ from each streamed alone")

    k1 = 0
    for slots, block, rounds in ((8, 16, 3), (1, 1, 24), (8, 1, 4)):
        for weights in ("bf16", "int8"):
            dtype = torch.bfloat16 if weights == "bf16" else torch.float32
            mux = SessionMultiplexer(params32, cfg, slots=slots, block=block, dtype=dtype,
                                     weights=weights)
            tick = mux.tick_samples
            sess = [mux.open() for _ in range(slots)]
            x = (rng.normal(size=(slots, fl + 3 * rounds * tick)) * 0.1).astype(np.float32)
            for s in sess:
                mux.feed(s, x[s, :fl])  # admitted: primed, no tick yet
            scan.launches = 0

            def feed_rounds(r0):
                for r in range(r0, r0 + rounds):
                    for s in sess:
                        mux.feed(s, x[s, fl + r * tick: fl + (r + 1) * tick])

            feed_rounds(0)  # warm-up
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), mux.ticks
            feed_rounds(rounds)
            torch.cuda.synchronize()
            wall, n_ticks = time.perf_counter() - t0, mux.ticks - n0
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                feed_rounds(2 * rounds)
                torch.cuda.synchronize()
            traced = time.perf_counter() - t0
            busy, n_kernels = _device_busy(prof)
            if block > 1:
                if scan.launches <= 0:
                    raise AssertionError(f"slots {slots} block {block}: K1 not launched")
                k1 += scan.launches
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve_cli.main(["--ckpt", "flagship", "--slots", str(slots), "--sessions", "1",
                                "--block", str(block), "--weights", weights, "--bench",
                                "--seconds", "4" if block > 1 else "1", "--reps", "3"])
            bench = json.loads(buf.getvalue().strip().splitlines()[-1])
            print(f"  multiplexer E8 slots {slots} block {block} {weights} on {smi}: traffic "
                  f"of one tick a feed: {n_ticks} ticks, wall {wall / n_ticks * 1e3:.2f} ms a "
                  f"tick ({n_ticks * tick / SR / wall:.1f} audio-s/s); traced "
                  f"{traced / n_ticks * 1e3:.2f} ms a tick, device busy {busy / n_ticks:.3f} ms "
                  f"a tick (idle share {1 - busy / (traced * 1e3):.3f}), "
                  f"{n_kernels / n_ticks:.0f} kernels a tick; every slot live (bench): tick "
                  f"{bench['tick_ms']} ms, {bench['value']} audio-s/s together")

    # the serving CLIs as their users start them
    with tempfile.TemporaryDirectory() as tmp:
        from cleanumamba_tpu_torch.convert import save_reference_checkpoint
        from cleanumamba_tpu_torch.data.wavio import write_wav
        from cleanumamba_tpu_torch.params import load_checkpoint

        cfg_r, params_r = load_checkpoint(CKPT, "cpu")
        ref_path = os.path.join(tmp, "reference.pkl")
        save_reference_checkpoint(ref_path, params_r, cfg_r)
        os.makedirs(os.path.join(tmp, "wavs"))
        for i in range(2):
            write_wav(os.path.join(tmp, "wavs", f"n{i}.wav"),
                      (rng.normal(size=SR + 4000 * i) * 0.1).astype(np.float32), SR)
        py = [sys.executable, "-m"]
        cmds = {
            "serve --bench": py + ["cleanumamba_tpu_torch.cli.serve", "--ckpt", "flagship",
                                   "--slots", "8", "--block", "16", "--bench", "--seconds", "8",
                                   "--reps", "3"],
            "serve demo": py + ["cleanumamba_tpu_torch.cli.serve", "--ckpt", "flagship",
                                "--slots", "4", "--sessions", "3", "--weights", "int8"],
            "denoise": py + ["cleanumamba_tpu_torch.cli.denoise", "--ckpt", ref_path, "--input",
                             os.path.join(tmp, "wavs"), "--output", os.path.join(tmp, "out")],
            "stream_demo": py + ["cleanumamba_tpu_torch.cli.stream_demo", "--ckpt", CKPT,
                                 "--synthetic", "--seconds", "2"],
        }
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            jobs = {k: pool.submit(subprocess.run, c, capture_output=True, text=True, timeout=600)
                    for k, c in cmds.items()}
            done = {k: j.result() for k, j in jobs.items()}
        for k, r in done.items():
            if r.returncode != 0:
                raise AssertionError(f"{k}: exit {r.returncode}\n{r.stderr[-3000:]}")
        bench = json.loads(done["serve --bench"].stdout.strip().splitlines()[-1])
        if bench["backend"] != "cuda" or bench["value"] <= 0:
            raise AssertionError(f"serve --bench: {bench}")
        if "3 sessions" not in done["serve demo"].stdout \
                or "offline throughput on cuda" not in done["denoise"].stdout \
                or sorted(os.listdir(os.path.join(tmp, "out"))) != ["enhanced_n0.wav",
                                                                   "enhanced_n1.wav"] \
                or "x realtime" not in done["stream_demo"].stdout:
            raise AssertionError("a serving CLI did not finish its work:\n"
                                 + "\n".join(r.stdout[-500:] for r in done.values()))
        print(f"  CLIs as subprocesses (run together): serve --bench {json.dumps(bench)}; "
              f"serve demo: {done['serve demo'].stdout.strip().splitlines()[-1]}; denoise (a "
              f"reference-format checkpoint): {done['denoise'].stdout.strip().splitlines()[-1]}; "
              f"stream_demo: {done['stream_demo'].stdout.strip().splitlines()[-1]}")
    return k1


def _base_k5(checkout):
    """The K5 wrapper module of another checkout, launching that checkout's kernel."""
    import importlib.util

    from cleanumamba_tpu_torch.ops.cuda import build

    spec = importlib.util.spec_from_file_location(
        "base_stream_mega", os.path.join(checkout, "cleanumamba_tpu_torch", "ops", "cuda",
                                         "stream_mega.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    csrc = os.path.join(checkout, "cleanumamba_tpu_torch", "csrc")
    module.load_library = lambda name: build.load_library(name, csrc)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fused-only", action="store_true",
                        help="build and check K3/K4 only (phase 3's fused part, the block-1 "
                             "checks of phase 4 and phase 5) and print no result lines")
    parser.add_argument("--scan-only", action="store_true",
                        help="build and check K1/K2 only (phase 3's scan part, phase 6 with "
                             "its times, phase 8) and print no result lines")
    parser.add_argument("--base-k5", metavar="DIR",
                        help="a checkout of an earlier version (e.g. the parent commit unpacked "
                             "with git archive): phase 12 times its K5 beside this one's in "
                             "one trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import count_params, init_params
    from cleanumamba_tpu_torch.ops.cuda import build
    from cleanumamba_tpu_torch.ops.cuda.selective_scan import (
        selective_scan,
        selective_scan_bwd,
    )
    from cleanumamba_tpu_torch.ops.cuda.stream_fused import (
        fused_decoder_level,
        fused_encoder_level,
    )
    from cleanumamba_tpu_torch.ops.cuda.stream_mega import mega_stream_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"phase 1 device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    sources = ("stream_fused",) if args.fused_only else ("selective_scan",) if args.scan_only \
        else ("selective_scan", "stream_fused", "stream_mega")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        jobs = [pool.submit(build.load_library, name) for name in sources]  # one nvcc each
        if args.base_k5:
            base_csrc = os.path.join(args.base_k5, "cleanumamba_tpu_torch", "csrc")
            jobs.append(pool.submit(build.load_library, "stream_mega", base_csrc))
        for job in jobs:
            job.result()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}", flush=True)

    rep = Report()
    if args.scan_only:
        print("phase 3 K1 vs its plain version:", flush=True)
        check_scan(dev, rep)
        print("phase 6 K2 vs its plain version, and the scan's times:", flush=True)
        check_scan_bwd(dev, rep)
        time_scan(dev, rep, smi)
        print("phase 8 whole-model gradient, card vs CPU:", flush=True)
        check_model_grad(dev)
        print("scan-only run: K1/K2 checks passed (no result lines)")
        return 0
    cfg = CleanUMambaConfig()  # E8
    params32 = init_params(cfg, torch.Generator().manual_seed(0), dev)
    print("phase 3 kernels vs plain versions:", flush=True)
    if args.fused_only:
        check_fused(dev, cfg, params32, rep, smi)
        check_block_equals_steps(dev, cfg, params32)
        trace_block1(dev, cfg, params32, smi)
        check_real_weights(dev)
        print("phase 13 K3/K4 with int8 weights vs their plain versions:", flush=True)
        check_fused_int8(dev, cfg, params32, rep, smi)
        print("fused-only run: K3/K4 checks passed (no result lines)")
        return 0
    check_scan(dev, rep)
    check_fused(dev, cfg, params32, rep, smi)

    print(f"phase 4 E8 slice ({count_params(params32):,} params):", flush=True)
    counters = (selective_scan, fused_encoder_level, fused_decoder_level)
    launches, rtf16, rtf1 = run_slice(dev, cfg, params32, counters)
    check_block_equals_steps(dev, cfg, params32)
    trace_block1(dev, cfg, params32, smi)
    trace_offline(dev, cfg, params32, smi)

    print("phase 5 real weights:", flush=True)
    check_real_weights(dev)

    print("phase 6 K2 vs its plain version, and the scan's times:", flush=True)
    check_scan_bwd(dev, rep)
    time_scan(dev, rep, smi)
    print("phase 7 E8 training slice:", flush=True)
    train_launches = run_training(dev, cfg, smi, (selective_scan, selective_scan_bwd))
    print("phase 8 whole-model gradient, card vs CPU:", flush=True)
    check_model_grad(dev)
    print("phase 9 training CLI:", flush=True)
    check_cli(dev)
    print("phase 10 K5 vs its plain version:", flush=True)
    models = check_mega(dev, rep)
    print("phase 11 the small-model block-1 path:", flush=True)
    launches["mega_stream_step"] = run_mega_path(
        dev, models, params32, cfg, (fused_encoder_level, fused_decoder_level))
    print("phase 12 times of the block-1 path:", flush=True)
    time_mega(dev, models, rep, smi, _base_k5(args.base_k5) if args.base_k5 else None)
    print("phase 13 K3/K4 with int8 weights vs their plain versions:", flush=True)
    check_fused_int8(dev, cfg, params32, rep, smi)
    print("phase 14 the int8 serving path (E8 Streamer, int8 K3/K4):", flush=True)
    launches.update(run_int8_streamer(dev, cfg, params32))
    print("phase 15 SessionMultiplexer on E8, and the serving CLIs:", flush=True)
    launches["selective_scan"] += run_multiplexer(dev, cfg, params32, smi, selective_scan)

    # launches: each path's own run (serving, phase 4; training, phase 7; the
    # int8 serving path, phase 14; the multiplexer's block-16 ticks, phase 15)
    for name, n in train_launches.items():
        launches[name] = launches.get(name, 0) + n
    sources = {
        "selective_scan": ("selective_scan_fwd", "cleanumamba_tpu_torch/csrc/selective_scan.cu",
                           "cleanumamba_tpu/ops/pallas/selective_scan.py:169"),
        "selective_scan_bwd": ("selective_scan_bwd",
                               "cleanumamba_tpu_torch/csrc/selective_scan.cu",
                               "cleanumamba_tpu/ops/pallas/selective_scan.py:341"),
        "fused_encoder_level": ("fused_encoder_level",
                                "cleanumamba_tpu_torch/csrc/stream_fused.cu",
                                "cleanumamba_tpu/ops/pallas/stream_fused.py:297"),
        "fused_decoder_level": ("fused_decoder_level",
                                "cleanumamba_tpu_torch/csrc/stream_fused.cu",
                                "cleanumamba_tpu/ops/pallas/stream_fused.py:365"),
        "mega_stream_step": ("mega_stream_step", "cleanumamba_tpu_torch/csrc/stream_mega.cu",
                             "cleanumamba_tpu/ops/pallas/stream_mega.py:727"),
        # the int8 weight type of K3/K4 (the TPU kernel's _deq, conv_q/mix_q)
        "fused_encoder_level_int8": ("fused_encoder_level_int8",
                                     "cleanumamba_tpu_torch/csrc/stream_fused.cu",
                                     "cleanumamba_tpu/ops/pallas/stream_fused.py:297"),
        "fused_decoder_level_int8": ("fused_decoder_level_int8",
                                     "cleanumamba_tpu_torch/csrc/stream_fused.cu",
                                     "cleanumamba_tpu/ops/pallas/stream_fused.py:365"),
    }
    kernels = []
    for fn_name, (kname, src, replaces) in sources.items():
        ms, plain_ms = rep.ms[kname]
        bound_ms, bound_by = rep.bound[kname]
        # library_ms: no single PyTorch call computes what any of these kernels
        # fuses (a scan with carried state, a level, a whole frame)
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[fn_name], "max_abs_err": rep.err[kname],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    print(f"E8 streaming RTF on {smi}: block 16 (bf16) {rtf16:.1f}x, "
          f"block 1 (Streamer, bf16 packs) {rtf1:.1f}x realtime")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
