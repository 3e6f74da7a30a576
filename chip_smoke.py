#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cleanumamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Phases, each printed as it passes; any failure raises (non-zero exit):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the CUDA kernels (``csrc/*.cu``, one ``nvcc`` each, in
   parallel) into ``_build/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, in fp32 (TF32 off) and bf16, plus the other
   GLU gate activations of K3/K4 in fp32, with its time beside the plain
   version's (CUDA events, after warm-up);
4. the E8 serving slice at full width (random weights from a seeded
   ``torch.Generator``, bf16 weight view): offline forward on 1 s, prime +
   64 blocks of 16 frames through ``stream_step_block``, then ``Streamer``
   at block 1; every kernel's launch count must be > 0 after this phase;
   then, in fp32, 2 blocks of 16 frames must equal 32 single steps;
5. real weights: ``artifacts/pruned_473k_finetuned.pkl`` offline and
   streamed, streaming == offline with ``normalize_input=False``;
6. K2 (backward scan) and K1's chunk states against their plain versions:
   all seven gradients at the E8 training shape (B=2, L=625, d_inner 2048,
   d_state 64) in fp32 and bf16, at a ragged shape with h0 and gh_last
   non-zero, and in a single chunk; K2's time beside the plain version's;
7. the E8 training slice at full width: bf16 ``make_train_step`` (Adam,
   lr 1e-4) on batch 2 x 10 s from ``synth_batch`` on the card, a few
   steps on fresh batches, then 12 on one batch, whose loss must fall;
   finite gradients every step; K1 and K2 launch counts > 0; ms per step,
   peak memory and a ``torch.profiler`` window (device-busy share, kernels
   per step);
8. the whole-model fp32 gradient of a small config on the card (kernels)
   against the same step on the CPU (plain versions), every leaf;
9. the training CLI as a subprocess: 3 iterations of E8 on synthetic data,
   then a resumed run, and a forward from the final checkpoint.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
kernels' summary as JSON.  There is no CPU path: without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
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


class Report:
    """Per-kernel max errors and times for the summary line."""

    def __init__(self):
        self.err = {}
        self.ms = {}

    def check(self, kernel, label, got, ref, tol):
        err, rel = _rel_err(got, ref)
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
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

def check_scan(dev, rep: Report):
    from cleanumamba_tpu_torch.ops.cuda.selective_scan import (
        selective_scan,
        selective_scan_plain,
    )

    g = torch.Generator().manual_seed(1)

    def inputs(Bsz, L, Di, Ds, h0):
        rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
        return dict(
            u=rn(Bsz, L, Di), dt=rn(Bsz, L, Di).abs() * 0.1,
            A=-torch.exp(rn(Di, Ds) * 0.5), B=rn(Bsz, L, Ds), C=rn(Bsz, L, Ds),
            D=rn(Di), h0=rn(Bsz, Di, Ds) * 0.1 if h0 else None)

    for Bsz, L, Di, Ds, h0 in ((1, 16, 2048, 64, True), (2, 63, 2048, 64, False),
                               (1, 37, 48, 8, True)):
        base = {k: (v.to(dev) if v is not None else None)
                for k, v in inputs(Bsz, L, Di, Ds, h0).items()}
        for dt_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            a = dict(base)
            for k in ("u", "B", "C"):
                a[k] = base[k].to(dtype)
            y, h = selective_scan(**a)
            ref = {k: (v.float() if v is not None else None) for k, v in a.items()}
            y_ref, h_ref = selective_scan_plain(**ref)
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            label = f"B={Bsz} L={L} d_inner={Di} d_state={Ds} h0={h0} {dt_name}"
            rep.check("selective_scan_fwd", label + " y", y, y_ref, tol)
            rep.check("selective_scan_fwd", label + " h_last", h, h_ref, tol)

    # time at the block-16 shape (B=1, L=16, E8 widths), bf16 as on the path
    a = {k: (v.to(dev) if v is not None else None)
         for k, v in inputs(1, 16, 2048, 64, True).items()}
    for k in ("u", "B", "C"):
        a[k] = a[k].to(torch.bfloat16)
    ms = _time_ms(lambda: selective_scan(**a))
    plain_ms = _time_ms(lambda: selective_scan_plain(**a))
    rep.ms["selective_scan_fwd"] = (ms, plain_ms)
    print(f"  selective_scan_fwd B=1 L=16 d_inner=2048 d_state=64 bf16: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


def _fp32_pack(pk):
    arrays, meta = pk
    return {k: v.float() for k, v in arrays.items()}, {**meta, "cdt": torch.float32}


def check_fused(dev, cfg, params, rep: Report):
    """K3/K4 at every E8 level at block 1 (T = 2^(7-i) tokens at encoder
    level i), fp32 and bf16 packs, with and without a decoder prev tail."""
    from cleanumamba_tpu_torch.ops.cuda import stream_fused as sf

    D, S = cfg.encoder_n_layers, cfg.stride
    g = torch.Generator().manual_seed(2)
    rn = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev)  # noqa: E731
    enc_calls, dec_calls = {}, {}
    for cdt_name, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for i, ep in enumerate(params["encoder"]):
            pk = sf.pack_encoder_level(ep, cfg, i, cdt)
            T = S ** (D - 1 - i)
            win32 = rn(1, T, pk[1]["K"] * pk[1]["Cin"])
            acts = (("fp32", torch.float32),) if cdt == torch.float32 else (
                ("bf16", torch.bfloat16), ("fp32", torch.float32))
            for act_name, adt in acts:
                win = win32.to(adt)
                got = sf.fused_encoder_level(win, *pk)
                if cdt == torch.float32:
                    ref = sf.fused_encoder_level_plain(win, *pk)
                else:
                    ref = sf.fused_encoder_level_plain(win.to(cdt).float(), *_fp32_pack(pk))
                tol = FP32_TOL if cdt == torch.float32 else BF16_TOL
                rep.check("fused_encoder_level", f"level {i} T={T} pack={cdt_name} "
                          f"act={act_name}", got, ref, tol)
                if act_name == cdt_name:
                    enc_calls.setdefault(cdt_name, []).append((win, pk))
        for j, dp in enumerate(params["decoder"]):
            pk = sf.pack_decoder_level(dp, cfg, D - 1 - j, cdt)
            T = S ** j
            C_in = pk[0]["mwa"].shape[0]
            SC = S * pk[1]["Cout"]
            relu = j != D - 1
            for has_prev in (False, True):
                x, skip = rn(1, T, C_in).to(cdt), rn(1, T, C_in).to(cdt)
                prev = rn(1, 1, SC).to(cdt) if has_prev else None
                out, tail = sf.fused_decoder_level(x, skip, prev, *pk, relu=relu)
                if cdt == torch.float32:
                    r_out, r_tail = sf.fused_decoder_level_plain(x, skip, prev, *pk, relu=relu)
                else:
                    r_out, r_tail = sf.fused_decoder_level_plain(
                        x.float(), skip.float(), None if prev is None else prev.float(),
                        *_fp32_pack(pk), relu=relu)
                tol = FP32_TOL if cdt == torch.float32 else BF16_TOL
                label = f"level {j} T={T} pack={cdt_name} prev={has_prev}"
                rep.check("fused_decoder_level", label + " out", out, r_out, tol)
                rep.check("fused_decoder_level", label + " tail", tail, r_tail, tol)
                if has_prev:
                    dec_calls.setdefault(cdt_name, []).append((x, skip, prev, pk, relu))

    # the other GLU gate activations (E8 uses Sigmoid): encoder level 4 and
    # its decoder level, fp32 packs
    for act in ("ReLU", "SiLU", "GELU"):
        cfg_a = dataclasses.replace(cfg, glu_activation=act)
        pk = sf.pack_encoder_level(params["encoder"][4], cfg_a, 4, torch.float32)
        win = rn(1, S ** (D - 5), pk[1]["K"] * pk[1]["Cin"])
        rep.check("fused_encoder_level", f"level 4 pack=fp32 act={act}",
                  sf.fused_encoder_level(win, *pk), sf.fused_encoder_level_plain(win, *pk),
                  FP32_TOL)
        pk = sf.pack_decoder_level(params["decoder"][D - 5], cfg_a, 4, torch.float32)
        T, C_in, SC = S ** (D - 5), pk[0]["mwa"].shape[0], S * pk[1]["Cout"]
        x, skip, prev = rn(1, T, C_in), rn(1, T, C_in), rn(1, 1, SC)
        got = sf.fused_decoder_level(x, skip, prev, *pk, relu=True)
        ref = sf.fused_decoder_level_plain(x, skip, prev, *pk, relu=True)
        for part, g_, r_ in zip(("out", "tail"), got, ref):
            rep.check("fused_decoder_level", f"level {D - 5} pack=fp32 act={act} {part}",
                      g_, r_, FP32_TOL)

    # times for one block-1 frame's worth of levels (all 8), bf16 as on the path
    def enc_all(fn):
        return lambda: [fn(win, *pk) for win, pk in enc_calls["bf16"]]

    def dec_all(fn):
        return lambda: [fn(x, s, p, *pk, relu=r) for x, s, p, pk, r in dec_calls["bf16"]]

    for name, kern, plain, wrap in (
            ("fused_encoder_level", sf.fused_encoder_level, sf.fused_encoder_level_plain, enc_all),
            ("fused_decoder_level", sf.fused_decoder_level, sf.fused_decoder_level_plain, dec_all)):
        ms, plain_ms = _time_ms(wrap(kern)), _time_ms(wrap(plain))
        rep.ms[name] = (ms, plain_ms)
        print(f"  {name} all 8 E8 levels at block 1, bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")


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

    params16 = prepare_weight_view(params32, "bf16")
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
    s = Streamer(params, cfg, dev)
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
    from cleanumamba_tpu_torch.ops import scan as plain_scan
    from cleanumamba_tpu_torch.ops.cuda.selective_scan import (
        SCAN_CHUNK,
        selective_scan,
        selective_scan_bwd,
        selective_scan_bwd_plain,
    )

    g = torch.Generator().manual_seed(6)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731

    def inputs(Bsz, L, Di, Ds, dtype, nonzero_state):
        a = dict(u=rn(Bsz, L, Di), dt=rn(Bsz, L, Di).abs() * 0.1,
                 A=-torch.exp(rn(Di, Ds) * 0.5), B=rn(Bsz, L, Ds), C=rn(Bsz, L, Ds),
                 D=rn(Di), h0=rn(Bsz, Di, Ds) * 0.1, gy=rn(Bsz, L, Di),
                 gh_last=rn(Bsz, Di, Ds) * (0.1 if nonzero_state else 0.0))
        if not nonzero_state:
            a["h0"] = torch.zeros_like(a["h0"])
        a = {k: v.to(dev) for k, v in a.items()}
        for k in ("u", "B", "C", "gy"):
            a[k] = a[k].to(dtype)
        return a

    def run(a, kernel):
        args = [a[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")]
        if kernel:
            _, _, hs = selective_scan(*args, return_starts=True)
            return hs, selective_scan_bwd(*args[:6], hs, a["gy"], a["gh_last"])
        f32 = [x.float() for x in args]
        _, _, hs = plain_scan.selective_scan(*f32, chunk=SCAN_CHUNK, return_starts=True)
        return hs, selective_scan_bwd_plain(*f32[:6], hs, a["gy"].float(), a["gh_last"])

    timed = {}
    for Bsz, L, Di, Ds, nonzero in ((2, 625, 2048, 64, False), (1, 37, 48, 8, True),
                                    (1, 16, 2048, 64, True)):
        for dt_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            a = inputs(Bsz, L, Di, Ds, dtype, nonzero)
            hs, got = run(a, kernel=True)
            hs_ref, ref = run(a, kernel=False)
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            label = f"B={Bsz} L={L} d_inner={Di} d_state={Ds} h0,gh_last={nonzero} {dt_name}"
            rep.check("selective_scan_fwd", label + " h_starts", hs, hs_ref, tol)
            for name, x, r in zip(GRAD_NAMES, got, ref):
                rep.check("selective_scan_bwd", f"{label} {name}", x, r, tol)
            if L == 625:
                timed[dt_name] = a

    # time at the E8 training shape, kernel and plain in turns
    times = {}
    for dt_name, a in timed.items():
        args = [a[k] for k in ("u", "dt", "A", "B", "C", "D", "h0")]
        _, _, hs = selective_scan(*args, return_starts=True)
        f32 = [x.float() for x in args]
        _, _, hs_p = plain_scan.selective_scan(*f32, chunk=SCAN_CHUNK, return_starts=True)
        kern = lambda: selective_scan_bwd(*args[:6], hs, a["gy"], a["gh_last"])  # noqa: E731
        plain = lambda: selective_scan_bwd_plain(  # noqa: E731
            *f32[:6], hs_p, a["gy"].float(), a["gh_last"])
        p1, k1 = _time_ms(plain, iters=5, warmup=1), _time_ms(kern, iters=20)
        k2, p2 = _time_ms(kern, iters=20), _time_ms(plain, iters=5, warmup=1)
        times[dt_name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  selective_scan_bwd B=2 L=625 d_inner=2048 d_state=64 {dt_name}: "
              f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    rep.ms["selective_scan_bwd"] = times["bf16"]  # the training path runs bf16


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
    from cleanumamba_tpu.config import LossConfig, OptimizationConfig
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
          f"{n_kernels / n_prof:.0f} kernels/step")
    return launches


# --------------------------------------------------------------------------
# Phase 8: whole-model gradient, card against CPU
# --------------------------------------------------------------------------

def check_model_grad(dev):
    from cleanumamba_tpu.config import CleanUMambaConfig, LossConfig
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
    from cleanumamba_tpu.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.params import from_numpy
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
        ck = load_checkpoint(os.path.join(ck_dir, f"{last}.pkl"))
        x = torch.from_numpy(
            (np.random.default_rng(9).normal(size=(1, SR)) * 0.1).astype(np.float32)).to(dev)
        with torch.no_grad():
            y = forward(from_numpy(ck["params"], dev), x, ck["config"])
        _finite("forward from the CLI's checkpoint", y)
        print(f"  checkpoint {last}.pkl (count {ck['opt_state']['count']}): forward on 1 s finite")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from cleanumamba_tpu.config import CleanUMambaConfig
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"phase 1 device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    sources = ("selective_scan", "stream_fused")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load_library, sources))  # one nvcc per source, in parallel
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}", flush=True)

    cfg = CleanUMambaConfig()  # E8
    params32 = init_params(cfg, torch.Generator().manual_seed(0), dev)
    rep = Report()
    print("phase 3 kernels vs plain versions:", flush=True)
    check_scan(dev, rep)
    check_fused(dev, cfg, params32, rep)

    print(f"phase 4 E8 slice ({count_params(params32):,} params):", flush=True)
    counters = (selective_scan, fused_encoder_level, fused_decoder_level)
    launches, rtf16, rtf1 = run_slice(dev, cfg, params32, counters)
    check_block_equals_steps(dev, cfg, params32)

    print("phase 5 real weights:", flush=True)
    check_real_weights(dev)

    print("phase 6 K2 and K1's chunk states vs plain versions:", flush=True)
    check_scan_bwd(dev, rep)
    print("phase 7 E8 training slice:", flush=True)
    train_launches = run_training(dev, cfg, smi, (selective_scan, selective_scan_bwd))
    del params32
    torch.cuda.empty_cache()
    print("phase 8 whole-model gradient, card vs CPU:", flush=True)
    check_model_grad(dev)
    print("phase 9 training CLI:", flush=True)
    check_cli(dev)

    # launches: each path's own run (serving, phase 4; training, phase 7)
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
    }
    kernels = []
    for fn_name, (kname, src, replaces) in sources.items():
        ms, plain_ms = rep.ms[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[fn_name], "max_abs_err": rep.err[kname],
                        "ms": ms, "plain_ms": plain_ms})
    print(f"E8 streaming RTF on {smi}: block 16 (bf16) {rtf16:.1f}x, "
          f"block 1 (Streamer, bf16 packs) {rtf1:.1f}x realtime")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
