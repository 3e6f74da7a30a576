#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cleanumamba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA device
    python3 chip_smoke.py --fused-only   # K3/K4 alone: their part of phases 3-5, and 13
    python3 chip_smoke.py --scan-only    # K1/K2 alone: their part of phases 3, 6 and 8
    python3 chip_smoke.py --base-k5 DIR  # phase 12 also times DIR's K5 (an earlier checkout)
    python3 chip_smoke.py --prune-only   # K1/K2 built, phase 18 alone (pruning and finetune)
    python3 chip_smoke.py --dist-only    # K1/K2 built, phases 19-20 (distillation, data parallel)
    python3 chip_smoke.py --export-only  # K1/K2 built, phase 21 alone (serving bundles)
    python3 chip_smoke.py --parallel-only  # K1/K2 built, phases 22-23 (tensor, sequence parallel)
    python3 chip_smoke.py --graphs-only  # every kernel built, phase 24 alone (CUDA graphs)
    python3 chip_smoke.py --kv-only      # K3/K4, K6 and K7 built, phase 25 alone (K6)
    python3 chip_smoke.py --widths-only  # K3/K4, K6 and K7 built, phases 15 (b)-(c), 26

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
   GLU gate activations in fp32; every E8 level at batch 16 with bf16
   weights in fp32 packs fed fp32 (the tensor cores), the windows a view and
   the skip a slice of a longer output as the multiplexer's tick passes
   them.  Their times are device times from a
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
    slot live (``cli/serve.py --bench`` in process); the block-1 tick with
    its levels packed (K3/K4) against the same tick per op, both graphed,
    at every width the ticks run, for bf16 and fp32 weights with fp32
    state and bf16, int8 and fp32 weights with bf16 state, at 16 and 8
    slots (the first: the benchmark's live multiplexer, the tensor cores):
    outputs, K3/K4 launches counted over each arm's ticks, and device busy
    and wall a tick per width; the graphed tick of the benchmark's
    live multiplexers (E8 and CleanUNet, 16 slots, bf16 weights) at widths
    1, 2, 4, 8 and 16: wall, device busy, K3/K4, K6 and K7 a tick from a
    trace, K7's launches counted from zero, beside the same tick made to
    read the stored bf16 weights and cast them per product: the outputs
    equal bit for bit, and at width 1 ``widened`` kernels fewer, all of them
    casts (``chiprun_out/tick_widths.json``; alone, with phase 26:
    ``--widths-only``); then ``cli/serve.py``
    (bench and demo), ``cli/denoise.py`` on a reference-format checkpoint
    and ``cli/stream_demo.py --synthetic`` as subprocesses;
16. the offline forward of mamba2 (the SSD scan) and mamba_s4 (the S4
    kernel and FFT convolution), plain torch, at E8 widths and the FullMini
    geometry (seed 0; mamba_s4 kernels attuned to 10 s): the card against
    the CPU at 2 x 2 s in fp32 (1e-4 of max|ref|), and streamed equal to
    offline on the card at ``normalize_input=False``; at E8 widths one bf16
    train step each, its loss on the card against the CPU (2e-4 relative);
    then the 2 x 10 s fp32 forward's wall, device busy, kernels, idle share
    and peak memory;
17. evaluation: ``eval.validate`` on E8 mamba (random weights, seed 0) over 4
    synthetic items padded to 4 s, K1 launched once per layer and utterance
    (counted), the forward's ms per utterance beside the host metric suite's
    s per utterance; ``cli/evaluate.py`` on the pruned checkpoint on the card
    and on the CPU (subprocesses), every metric agreeing; ``cli/train.py``
    on phase 8's small config validating every 2 iterations, a ``valid``
    row at 2 and at 4 in ``metrics.jsonl``, one run id across a resume;
18. structured channel pruning: (a) ``prune.driver.pruning_pipeline`` on E8
    at full width (random fp32 weights, seed 0; ``configs/prune_e8_synth.json``,
    batch 2 x 10 s synthetic crops, 32 iterations, prune events at 15 and
    31): the parameter count falls at each event, every group checks, K1
    and K2 launched (counted), ms per fp32 gradient before and after each
    event, the host's ms for the importances and ``apply_pruning``'s ms per
    event, peak and allocated memory, the reserved memory across an event
    (the gradient's graphs, captured at each width's second call, grow it
    by one pool at most); then K1 and K2 against their plain
    versions at every pruned layer's (2, 625, d_inner, d_state), fp32 and
    bf16, all seven gradients; (b) one prune event of phase 8's small config
    on the card and on the CPU: every group's importances within 1e-3 of its
    largest, the same selection wherever the two devices order the values
    it reads alike (the near-ties counted), the pruned forward within 1e-4;
    (c) ``cli/prune.py`` on ``artifacts/pruned_473k_finetuned.pkl`` with
    ``configs/prune_2m_synth.json`` (2 s crops) to 16 iterations and resumed
    to 32 under one run id, ``cli/finetune.py`` 4 iterations on its output
    (and with ``--device-data 2``), ``cli/evaluate.py`` on the finetuned
    checkpoint and ``cli/calibrate.py`` on the artifact, as subprocesses;
19. knowledge distillation (``train/distill.py``): the E8 teacher (seed 0,
    fp32, frozen) and a FullMini student, nine skip connections each, three
    bf16 KD steps on batch 2 x 10 s from ``synth_batch`` (loss and kd_loss
    finite, K1 and K2 launched, counted; wall, device busy, peak memory),
    then one fp32 KD gradient on the card against the CPU (batch 2 x 16384);
20. data parallelism (``parallel/``): two processes on ``cuda:0`` in a gloo
    group (NCCL refuses two ranks on one device), E8 at batch 1 x 10 s each,
    against one process over both items (fp32, TF32 off): the averaged
    gradient and the params after one step, the ranks' params bitwise
    equal, the gradient all-reduce's share of a bf16 step; then
    ``cli/train.py`` under ``torchrun --nproc-per-node 1`` (NCCL) with a
    resume (at the end, beside phase 21's CLI checks);
21. serving bundles (``export.py``): E8 exported on the card (offline at
    ``valid_length(160000)``; prime + step at batch 2, block 1 and block 16)
    with K1 as the custom op ``cleanumamba::selective_scan``, reloaded in a
    process that imports no model code: outputs bitwise equal to the eager
    calls, K1 launched 3 times a block-16 step; ``from_bundle`` against the
    live multiplexer; export, load and step times and the op's host cost
    per call; then ``cli/export.py --selftest`` on the pruned checkpoint on
    the card and the CPU, beside phase 20's torchrun check;
22. tensor parallelism (``parallel/tensor.py``), two gloo ranks on
    ``cuda:0``: K1 and K2 against their plain versions at a rank's shard
    (2, 125, 1024, 64), fp32 and bf16, and their device times there; E8
    mamba TP=2 at batch 2 x 2 s (fp32, TF32 off) against one process: the
    forward, the gradient back in the canonical layout, the replicated leaves
    bitwise equal on both ranks after three steps, K1/K2 counted; mamba2,
    mamba_s4 and mha at phase 8's small config, the TP forward against one
    process; three bf16 E8 TP steps (wall, device busy, the gloo
    all-reduces' share); DP x TP = 2 x 2 over four ranks, the small config's
    gradient against one process; then ``cli/train.py --model-parallel 2``
    under ``torchrun --nproc-per-node 2 --device cpu`` with a resume (NCCL
    refuses two ranks on one card; at the end, beside phases 20-21's CLIs);
23. sequence parallelism (``parallel/sequence.py``), two gloo ranks on
    ``cuda:0``: K1 against its plain version at a segment's shapes; E8 mamba
    (normalised and not), mamba2 and mamba_s4 at E8 widths and the pruned
    checkpoint, 10 s of audio over the two ranks, against zero-primed
    streaming and ``sp_stream_denoise(mesh=None)`` on the card (atol 3e-4,
    rtol 2e-3); K1 counted; the wall of a call beside streaming's;
24. the one-dispatch steps (``graphs.py``): every captured path replayed as
    a CUDA graph against the same path run eagerly on the card, on the same
    inputs: ``Streamer`` E8 bf16 at block 16 and block 1 (K3/K4 packs), E8
    int8 block 1, FullMini mamba and mha through K5; ``SessionMultiplexer``
    E8 bf16 at slots {1, 8} x block {1, 16} with a session paused for two
    ticks, and ``from_bundle`` of an E8 block-16 bundle; the E8 bf16 train
    step at 2 x 10 s (3 steps: params, optimizer state, aux) and
    ``make_device_data_steps`` with K = 4 (and the generator's state after).
    Outputs and states bit for bit; a difference is printed by leaf and held
    to the path's tolerance (fp32 1e-4, bf16 2e-2 of max|ref|).  The launch
    counts of the graph's steps equal the eager steps'.  For each: wall ms a
    step, median and p90, graph and eager in turns; from a trace of each,
    device busy and kernels a step, graph launches a call (must be 1) and
    the idle share; the graph pool's memory.  A shape's first call runs
    eagerly and its second is captured.  Then (b) the offline paths
    (``run_graphs_offline``): the forward (``graphs.ForwardGraphs``) of E8
    bf16 and fp32 at 10 s x 2, the ``__graft_entry__`` shape (1, 16000),
    mamba2 and mamba_s4 at E8 widths (the caller's params unwritten, params
    changed in place and replaced both seen), ``validate`` graphed and
    eager; the KD step (``graph_kd_step``), the E8 pruning gradient before
    and after a prune event (reserved memory grown by one pool at most) and
    a finetune step of the pruned checkpoint, compared under torch's
    deterministic algorithms; ``cli/serve.py``'s bench rep at 8 x 16 bf16
    (audio-s/s); phase 23's one-shot 10 s feeds, which capture nothing;
25. K6 (``ops/cuda/kv_attention.py``, one token of attention over per-row
    KV rings) against its plain version at 16 rows and a ring of 625, rows
    at positions from empty to wrapped many times: every head width it is
    built for (CleanUNet's 8 heads of 64, 8 of 8, 2 of 16), fp32 and bf16,
    over one row, all 16 and a subset, each gathered as a tick gathers its
    rows: outputs, the rings bit for bit, a repeated call bit for bit.
    Then, at CleanUNet's shape in fp32 with full windows, one row and all
    16: device times from a trace of K6 a launch, its plain version, the
    simplest in-place step in plain torch (a ``scatter_`` on each row's slot,
    then one masked ``scaled_dot_product_attention`` over the rings) and
    that masked attention alone (``library_ms``), beside the bound of the
    bytes and operations ``portbench/counts/k6.py`` counts.  Then the
    CleanUNet multiplexer's graphed tick (16 slots, bf16 weights, fp32
    state, six sessions with full windows, one live row a tick) with K6 and
    with that plain step in its place: wall and device busy a tick, the top
    kernels, the outputs of the two within 1e-4, and K6's launches counted
    from zero over the ticks (one a layer and tick).
26. K7 against its plain versions at the pools of the benchmark's live
    multiplexers (E8: 25 leaves, CleanUNet: 22 with its rings; 16 slots,
    random values): gathers and scatters of every width from 1 to 16 with
    padding rows, bit for bit and again on a repeated call; device times
    from a trace at width 1 of K7's gather and scatter, of the plain
    versions (one ``index_select`` or ``index_copy_`` a leaf) and the bound
    of the bytes the row reads and writes.

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
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CKPT = "artifacts/pruned_473k_finetuned.pkl"
ROOT = os.path.dirname(os.path.abspath(__file__))
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
# outside the tensor cores, 989 TFLOP/s dense bf16 and 494.7 dense TF32 in
# them (K3/K4's fp32 products of bf16 weights take two TF32 products each:
# "tf32x2", half that rate); the special-function units (exp) have 16 lanes
# per SM against 128 fp32 lanes: 1/8 of the FMA rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32x2": 494.7e12 / 2}
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
        self.library = {}  # the nearest library call's ms, where there is one

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
# The KD gradient's limit (phase 19) is max(GRAD_TOL, twice the CPU's own
# spread, one thread against all) and never more than these caps: of a
# leaf's max above the 1e-3 floor, and of the floor below it.  The spread
# measured 2.0e-4 and 2.8e-3 at batch 2 x 16384 on the H100 machine's host;
# the caps stand 2.5x and 1.8x above twice that, and a bf16 gradient, which
# the phase also takes, must lie above the first.
KD_TOL_CAP = 1e-3
KD_TOL_CAP_BELOW = 1e-2


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


def check_scan(dev, rep: Report, cases=None):
    """K1 against its plain version: every lane split the plan can pick,
    d_state 1..256, batch 1, 2 and 8, L from 1 to 2,500 (a 40 s clip), ragged
    widths (the pruned checkpoint's mixers), with and without h0 and D, a
    repeated call bit for bit.  ``cases`` ((B, L, d_inner, d_state, h0 and
    D) tuples) replaces that list."""
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

    g = torch.Generator().manual_seed(1)
    every_split = cases is None
    if every_split:
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
    if every_split and lanes_seen != set(kscan.LANE_CHOICES):
        raise AssertionError(f"the cases reach lane splits {lanes_seen} of {kscan.LANE_CHOICES}")
    print(f"  selective_scan_fwd: {len(cases)} shapes x 2 dtypes, repeated calls bitwise equal, "
          f"with and without chunk states; lane splits {sorted(lanes_seen)}")


def _event_us(fn, iters):
    """Device us per call of ``fn`` from CUDA events around ``iters`` calls,
    the device held busy (~5 ms of spinning) while the host queues them, so
    that they run back to back and no launch gap of the host is counted."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def _trace_scan(fn, iters=20, warmup=3, attempts=3):
    """Device time of K1's and K2's kernels in one call of ``fn``, from a
    ``torch.profiler`` trace of ``iters`` calls: {kernel name: (launches per
    call, median us per launch)}.  A trace that comes back holding fewer
    than half of the launches is taken again, up to ``attempts`` traces in
    all; each starts with a kernel of torch's own and a synchronisation
    before the calls.  On the H100 a trace of K1 alone came back empty in
    about one run in three, in one run three times in a row; when every
    trace is short, the call is timed with CUDA events instead and comes
    back as {"all launches (CUDA events)": (1, us per call)}."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and any(
                    k in e.name for k in SCAN_KERNELS):
                name = e.name.split("<")[0].split("::")[-1].split(" ")[-1]
                spans.setdefault(name, []).append(e.time_range.end - e.time_range.start)
        if spans and min(len(v) for v in spans.values()) >= iters // 2:
            return {k: (round(len(v) / iters), _median(v)) for k, v in spans.items()}
        print(f"  (a trace held {({k: len(v) for k, v in spans.items()})} scan kernels for "
              f"{iters} calls)", flush=True)
    us = _event_us(fn, iters)
    print(f"  ({attempts} traces short: {us:.2f} us per call from CUDA events)", flush=True)
    return {"all launches (CUDA events)": (1, us)}


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


def _trace_calls(calls, per_call, iters=20, warmup=3, attempts=3):
    """Device time of each of ``calls`` (thunks that launch ``per_call`` K3/K4
    kernels each) from a ``torch.profiler`` trace of ``iters`` rounds through
    all of them in order, so that a level finds its weights where a frame
    would (a round reads more than the L2 cache holds).  Returns, per call,
    (median us of each kernel, median us the device is busy with them: the
    union of their intervals, which counts an overlap once and no gap that the
    host left between two launches; median us from the first kernel's start
    to the last one's end, gaps included).  A short trace is taken again, as
    in ``_trace_scan``, up to ``attempts`` traces in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        for fn in calls:
            fn()
    torch.cuda.synchronize()
    per_round = per_call * len(calls)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(iters):
                for fn in calls:
                    fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.name for k in FUSED_KERNELS))
        rounds = len(ev) // per_round
        if rounds >= iters // 2:  # a trace may miss the first launches after it starts
            break
        print(f"  (a trace held {len(ev)} kernels for {iters} rounds of {per_round})", flush=True)
    else:
        raise AssertionError(f"{attempts} traces held too few kernels for {iters} rounds of "
                             f"{per_round}")
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


def _check_enc(rep, sf, win, pk, label, kernel="fused_encoder_level"):
    cdt = pk[1]["cdt"]
    got = sf.fused_encoder_level(win, *pk)
    if cdt == torch.float32:
        ref = sf.fused_encoder_level_plain(win, *pk)
    else:
        ref = sf.fused_encoder_level_plain(win.to(cdt).float(), *_fp32_pack(pk))
    rep.check(kernel, label, got, ref, FP32_TOL if cdt == torch.float32 else BF16_TOL)


def _check_dec(rep, sf, x, skip, prev, pk, relu, label, kernel="fused_decoder_level"):
    cdt = pk[1]["cdt"]
    out, tail = sf.fused_decoder_level(x, skip, prev, *pk, relu=relu)
    if cdt == torch.float32:
        r_out, r_tail = sf.fused_decoder_level_plain(x, skip, prev, *pk, relu=relu)
    else:
        r_out, r_tail = sf.fused_decoder_level_plain(
            x.float(), skip.float(), None if prev is None else prev.float(),
            *_fp32_pack(pk), relu=relu)
    tol = FP32_TOL if cdt == torch.float32 else BF16_TOL
    rep.check(kernel, label + " out", out, r_out, tol)
    rep.check(kernel, label + " tail", tail, r_tail, tol)


def _level_bytes(sf, pk, *tensors):
    """Bytes a level call must move: its weights and biases once (at their
    logical size, without the pack's padding) and the tensors given."""
    return _nbytes(*sf.unpack_level(*pk).values(), *tensors)


MMA_B = 16  # the benchmark's live multiplexer's slots: the batch of its tick's level calls


def _mma_level_calls(sf, cfg, params, B, rn, dev):
    """The E8 tick's 16 level calls at batch ``B``, the weights stored bf16 in
    fp32 packs (the tensor cores' products), on inputs laid out as
    ``stream_step`` lays them: encoder level i's windows a view of the suffix
    of level i - 1's output (of the frame at level 0), decoder level j's skip
    the first T tokens of encoder level D - 1 - j's output.  Returns (encoder
    calls (win, pk), decoder calls (x, skip, prev, pk, relu))."""
    from cleanumamba_tpu_torch.params import prepare_weight_view
    from cleanumamba_tpu_torch.streaming import _level_strides, stream_prime

    K, S, D = cfg.kernel_size, cfg.stride, cfg.encoder_n_layers
    stored = prepare_weight_view(params, "bf16")[0]
    state, _ = stream_prime(params, cfg, torch.zeros(1, cfg.frame_length, device=dev))
    strides = _level_strides(cfg)
    # the step's level outputs: the cache before the new tokens
    lengths = [cfg.frame_length] + [c.shape[1] + t for c, t in zip(state["enc"], strides)]
    enc, dec = [], []
    for i, ep in enumerate(stored["encoder"]):
        pk = sf.pack_encoder_level(ep, cfg, i, torch.float32)
        level_in = rn(B, lengths[i], pk[1]["Cin"])
        enc.append((sf.encoder_windows(level_in[:, -(K + S * (strides[i] - 1)):], K, S), pk))
    for j, dp in enumerate(stored["decoder"]):
        pk = sf.pack_decoder_level(dp, cfg, D - 1 - j, torch.float32)
        x, _, prev = _dec_case(pk, B, S ** j, rn, True)
        skip = rn(B, lengths[D - j], pk[1]["Cx"])[:, :S ** j]
        dec.append((x, skip, prev, pk, j != D - 1))
    return enc, dec


def check_fused(dev, cfg, params, rep: Report, smi):
    """K3/K4 at every E8 level at block 1 (T = 2^(7-i) tokens at encoder
    level i), fp32 and bf16 packs, with and without a decoder prev tail; at
    batch 2 and 8 on the four deepest levels; on the ragged levels of the
    pruned checkpoint; every level at batch ``MMA_B`` with bf16 weights in
    fp32 packs on the multiplexer's strided inputs (the tensor cores); a
    repeated call bit for bit; then their times."""
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

    # bf16 weights in an fp32 pack fed fp32 (the tensor cores), as the
    # 16-slot multiplexer's tick calls them: every E8 level at B = 16, the
    # windows a view of the level input's suffix (encoder_windows), the skip
    # the first T tokens of the encoder level's longer output (rev_skips[j][:, :T])
    mma_enc, mma_dec = _mma_level_calls(sf, cfg, params, MMA_B, rn, dev)
    for i, (win, pk) in enumerate(mma_enc):
        if win.is_contiguous() and win.shape[1] > 1:
            raise AssertionError(f"level {i}: encoder_windows copied its input")
        _check_enc(rep, sf, win, pk, f"level {i} B={MMA_B} T={win.shape[1]} bf16 weights "
                   "pack=fp32 (windows a view)", "fused_encoder_level_mma")
    for j, (x, skip, prev, pk, relu) in enumerate(mma_dec):
        if skip.is_contiguous() and skip.shape[1] > 1:
            raise AssertionError(f"level {j}: the skip is no slice of a longer output")
        _check_dec(rep, sf, x, skip, prev, pk, relu, f"level {j} B={MMA_B} T={x.shape[1]} "
                   "bf16 weights pack=fp32 (skip a slice)", "fused_decoder_level_mma")
    (win, pk), (x, skip, prev, pk4, relu) = mma_enc[0], mma_dec[-1]
    for what, call in (("K3 level 0", lambda: [sf.fused_encoder_level(win, *pk)]),
                       (f"K4 level {D - 1}",
                        lambda: sf.fused_decoder_level(x, skip, prev, *pk4, relu=relu))):
        first = [t.clone() for t in call()]
        if not all(torch.equal(a, b) for _ in range(3) for a, b in zip(call(), first)):
            raise AssertionError(f"{what} B={MMA_B} on the tensor cores: a repeated call differs")
    print(f"  K3 (level 0) and K4 (level {D - 1}) at B={MMA_B} on the tensor cores: 3 repeated "
          "calls bitwise equal")

    # bounds of the 8 levels together: windows/x/skip/prev and packs in, outputs
    # out (in the pack's compute dtype); 2 operations per multiply-add of the
    # level's products
    def out_size(pk):
        return torch.empty(0, dtype=pk[1]["cdt"]).element_size()

    def enc_work(win, pk):
        M, w = win.shape[0] * win.shape[1], sf.unpack_level(*pk)
        return (_level_bytes(sf, pk, win) + M * (pk[1]["C2"] // 2) * out_size(pk),
                2 * M * (w["cw"].numel() + w["mwa"].numel() + w["mwb"].numel()))

    def dec_work(x, skip, prev, pk):
        M, w = x.shape[0] * x.shape[1], sf.unpack_level(*pk)
        return (_level_bytes(sf, pk, x, skip, prev)
                + (M + x.shape[0]) * S * pk[1]["Cout"] * out_size(pk),
                2 * M * sum(w[k].numel() for k in ("mwa", "mwb", "cwlo", "cwhi")))

    enc_w = [enc_work(win, pk) for win, pk in enc_calls]
    dec_w = [dec_work(x, s, p, pk) for x, s, p, pk, _ in dec_calls]
    rep.bound["fused_encoder_level"] = _bound(
        sum(b for b, _ in enc_w), sum(f for _, f in enc_w), torch.bfloat16)
    rep.bound["fused_decoder_level"] = _bound(
        sum(b for b, _ in dec_w), sum(f for _, f in dec_w), torch.bfloat16)
    mma_w = ([enc_work(*c) for c in mma_enc], [dec_work(*c[:4]) for c in mma_dec])
    for name, work in zip(("fused_encoder_level_mma", "fused_decoder_level_mma"), mma_w):
        rep.bound[name] = _bound(sum(b for b, _ in work), sum(f for _, f in work), "tf32x2")

    # device time per level from a trace: rounds of one frame's 16 level calls
    def enc_fn(win, pk):
        return lambda: sf.fused_encoder_level(win, *pk)

    def dec_fn(x, s, p, pk, r):
        return lambda: sf.fused_decoder_level(x, s, p, *pk, relu=r)

    frame = [enc_fn(*c) for c in enc_calls] + [dec_fn(*c) for c in dec_calls]
    total = {}
    mma_case = f"B={MMA_B} fp32 pack of bf16 weights"
    for case, calls, work, levels in (
            ("B=1 bf16", frame, enc_w + dec_w, list(range(D)) + list(range(D))),
            ("B=8 bf16", [enc_fn(*c) for c in deep_enc] + [dec_fn(*c) for c in deep_dec],
             [enc_work(*c) for c in deep_enc] + [dec_work(*c[:4]) for c in deep_dec],
             list(range(D - 4, D)) + list(range(4))),
            (mma_case, [enc_fn(*c) for c in mma_enc] + [dec_fn(*c) for c in mma_dec],
             mma_w[0] + mma_w[1], list(range(D)) + list(range(D)))):
        n_enc = len(calls) // 2
        for c, ((kernels, busy, span), (nb, _), lvl) in enumerate(
                zip(_trace_calls(calls, 2), work, levels)):
            name = "K3" if c < n_enc else "K4"
            total[name, case] = total.get((name, case), 0.0) + busy
            print(f"  {name} level {lvl} {case}, device us from a trace on {smi}: "
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
        rep.ms[name] = (total[short, "B=1 bf16"] / 1e3, plain_ms)
        print(f"  {name} all 8 E8 levels at block 1, bf16, on {smi}: device "
              f"{total[short, 'B=1 bf16'] / 1e3:.4f} ms (trace; B=8 levels 4-7: "
              f"{total[short, 'B=8 bf16'] / 1e3:.4f} ms), plain {plain_ms:.4f} ms; a loop of "
              f"wrapper calls timed with events (the host's launch rate): {loop_ms:.4f} ms")
    for name, short, plain in (
            ("fused_encoder_level_mma", "K3",
             lambda: [sf.fused_encoder_level_plain(win, *pk) for win, pk in mma_enc]),
            ("fused_decoder_level_mma", "K4",
             lambda: [sf.fused_decoder_level_plain(x, s, p, *pk, relu=r)
                      for x, s, p, pk, r in mma_dec])):
        plain_ms = _time_ms(plain)
        rep.ms[name] = (total[short, mma_case] / 1e3, plain_ms)
        print(f"  {name} all 8 E8 levels, {mma_case} (the tensor cores), on {smi}: device "
              f"{total[short, mma_case] / 1e3:.4f} ms (trace), plain {plain_ms:.4f} ms; bound "
              f"{rep.bound[name][0]:.4f} ms ({rep.bound[name][1]})")


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


def check_scan_bwd(dev, rep: Report, cases=None):
    """K2 (and the chunk states K1 hands it) against the plain versions: all
    seven gradients at every lane split, d_state 1..128, batch 1, 2 and 8,
    L from 1 to 2,500, ragged widths, h0 and gh_last zero and non-zero, a
    repeated call bit for bit.  ``cases`` replaces that list."""
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan

    g = torch.Generator().manual_seed(6)
    every_split = cases is None
    if every_split:
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
    if every_split and lanes_seen != set(kscan.LANE_CHOICES):
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


# (weights, state dtype, slots) of the packed ticks against the per-op ticks:
# the benchmark's live multiplexer first (bf16 weights, fp32 state, 16 slots)
TICK_CASES = [(w, d, n) for w, d in (("bf16", torch.float32), ("fp32", torch.float32),
                                     ("bf16", torch.bfloat16), ("int8", torch.bfloat16),
                                     ("fp32", torch.bfloat16))
              for n in (MMA_B, 8)]


def _ticks_of_width(mux, hops, w, n, k, outs=None, label=""):
    """``n`` ticks of ``w`` live rows of ``mux`` (every slot admitted), the
    live set turning from tick ``k`` on: each tick buffers one hop of
    ``hops`` (one tick's samples each) for each of its sessions and pumps
    once.  Every slot's output is drained, appended to ``outs[s]`` where
    given, and must be finite.  Returns the next ``k``."""
    for _ in range(n):
        for j in range(w):
            s = (k * w + j) % mux.slots
            mux._buf[s] = hops[(k + j) % len(hops)]
            mux._fed[s] += mux.tick_samples
        k += 1
        mux._pump()
        for s in range(mux.slots):
            y = mux._drain(s)
            if not np.isfinite(y).all():
                raise AssertionError(f"{label}: a tick of width {w} gave non-finite output")
            if outs is not None:
                outs[s].append(y)
    return k


def _admit_every_slot(mux, rng):
    for s in range(mux.slots):
        mux.open()
        mux.feed(s, (rng.normal(size=mux.cfg.frame_length) * 0.1).astype(np.float32))


def check_tick_packs(dev, cfg, params32, smi, timed=40, traced=40):
    """Phase 15 (b): the multiplexer's block-1 tick with its levels packed
    (K3/K4) against the same tick per op, each graphed, at every width its
    ticks run (the powers of two below ``slots``, and ``slots``), for every
    ``TICK_CASES`` entry.  Two live multiplexers on one traffic: the
    constructor's own, which packs at every width, and one whose
    ``pack_stream_params`` packs nothing.  Checks the outputs (fp32 state
    1e-4, bf16 4e-2 of max|ref|) and K3/K4's launches (counted from zero
    over each arm's ticks: a packed tick launches each level once, per op
    none), and prints device busy and wall ms a tick per width.  Returns the
    K3/K4 launches of the first case (the tensor cores' products) for the
    kernel table."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch import serve
    from cleanumamba_tpu_torch.ops.cuda import stream_fused as sf

    kernels = (sf.fused_encoder_level, sf.fused_decoder_level)
    D = cfg.encoder_n_layers
    first, faults = None, []
    for weights, dtype, slots in TICK_CASES:
        case = f"{weights} weights, {str(dtype)[6:]} state, {slots} slots"
        widths = sorted({serve.tick_width(n, slots) for n in range(1, slots + 1)})
        got = {}
        for arm in ("packed", "per-op"):
            pack = sf.pack_stream_params
            if arm == "per-op":
                sf.pack_stream_params = lambda *a, **k: (None, None)
            try:
                mux = serve.SessionMultiplexer(params32, cfg, slots=slots, dtype=dtype,
                                               weights=weights)
            finally:
                sf.pack_stream_params = pack
            if mux.packed_levels != (2 * D if arm == "packed" else 0):
                raise AssertionError(f"{case} {arm}: {mux.packed_levels} levels packed")
            rng = np.random.default_rng(151)
            _admit_every_slot(mux, rng)
            hops = (rng.normal(size=(64, mux.tick_samples)) * 0.1).astype(np.float32)
            outs, per, k, n0 = [[] for _ in range(slots)], {}, 0, mux.ticks
            for kern in kernels:
                kern.launches = kern.int8_launches = 0
            for w in widths:
                k = _ticks_of_width(mux, hops, w, 3, k, outs, case)  # eager, captured, replayed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                k = _ticks_of_width(mux, hops, w, timed, k, outs, case)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / timed
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    k = _ticks_of_width(mux, hops, w, traced, k, outs, case)
                    torch.cuda.synchronize()
                per[w] = (wall, _device_busy(prof)[0] / traced)
            ticks = mux.ticks - n0
            counts = [kern.launches + kern.int8_launches for kern in kernels]
            want = [ticks * D if arm == "packed" else 0] * 2
            if counts != want:
                faults.append(f"{case} {arm}: K3/K4 launches {counts}, expected {want} over "
                              f"{ticks} ticks")
            got[arm] = ([np.concatenate(o) for o in outs], per)
            if first is None:
                first = {"fused_encoder_level_mma": counts[0],
                         "fused_decoder_level_mma": counts[1]}
            del mux
            torch.cuda.empty_cache()
        # each bf16 arm lies within BF16_TOL of the fp32 tick, so the two within twice it
        tol = FP32_TOL if dtype == torch.float32 else 2 * BF16_TOL
        rel = max(_rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
                  for a, b in zip(got["packed"][0], got["per-op"][0]))
        print(f"  ticks of {case} on {smi}: packed vs per-op outputs rel {rel:.3e} "
              f"(tol {tol:g})", flush=True)
        if not rel <= tol:
            faults.append(f"{case}: packed vs per-op outputs rel {rel:.3e}")
        for w in widths:
            (wall_p, busy_p), (wall_o, busy_o) = got["packed"][1][w], got["per-op"][1][w]
            print(f"    width {w:2d}: packed (K3/K4) device busy {busy_p:.4f} ms a tick, wall "
                  f"{wall_p:.4f}; per op busy {busy_o:.4f}, wall {wall_o:.4f}; packed / per op "
                  f"{busy_p / busy_o:.3f}", flush=True)
    if faults:
        raise AssertionError("packed ticks: " + "; ".join(faults))
    return first


TICK_WIDTHS = (1, 2, 4, 8, 16)  # the widths of the 16-slot multiplexer's ticks
K34_KERNELS = ("conv_relu_kernel", "glu_kernel", "convt_kernel")  # K3/K4 in a trace
ROW_COPY_KERNEL = "row_copy_kernel"  # K7's name in a trace


CAST_KERNEL = "direct_copy"  # a dtype cast's kernel in a trace (at::native::...direct_copy_)


def check_tick_widths(dev, smi, timed=200, traced=100, fill=640):
    """Phase 15 (c): the graphed tick of the benchmark's live multiplexers (16
    slots, bf16 weights, fp32 state) at each of ``TICK_WIDTHS``, on E8 and
    CleanUNet (its windows filled first, ``fill`` ticks of every slot), in
    two arms on one traffic: "widened", the program's multiplexer, whose bf16
    weights outside the level packs are held in fp32 (``widened`` leaves,
    17 and 32), and "cast", the same multiplexer made to read the stored
    bf16 weights and cast each per product in every tick (the tick before
    that widening).  Ticks of w live rows, the live set turning; after three
    to warm up (eager, captured, replayed), ``timed`` ticks for the wall and
    ``traced`` under the profiler for device busy a tick, K3/K4's, K6's and
    K7's (the rows' gather and write-back) device time a tick, the casts'
    (``direct_copy``), the kernels a tick and the top kernels.  Checks that
    each tick steps w rows (``rows_stepped``), one graph a width, finite
    outputs, the two arms' outputs equal bit for bit, K7's launches, counted
    from zero (two a tick at every width: the gather and the write-back),
    and at width 1 that the widened tick launches ``widened`` kernels fewer
    than the cast one, all of them casts, and spends under a tenth of the
    cast tick's time in casts.  Writes ``chiprun_out/tick_widths.json``;
    returns K7's launches over the ticks."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.ops.cuda.row_copy import gather_rows, scatter_rows
    from cleanumamba_tpu_torch.params import prepare_weight_view
    from cleanumamba_tpu_torch.serve import SessionMultiplexer
    from cleanumamba_tpu_torch.streaming import without_packed_levels

    def k7_launches():
        return gather_rows.launches + scatter_rows.launches

    rows, slots, faults = [], 16, []
    gather_rows.launches = scatter_rows.launches = 0
    for label, cfg in (("E8", CleanUMambaConfig()), ("CleanUNet", CleanUMambaConfig(**CLEANUNET))):
        torch.cuda.reset_peak_memory_stats(dev)
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        arms = {}
        for arm in ("widened", "cast"):
            mux = SessionMultiplexer(params, cfg, slots=slots, weights="bf16", device=dev)
            if arm == "cast":
                stored = prepare_weight_view(params, "bf16")[0]
                mux.params = stored
                mux._step_params = without_packed_levels(stored, mux._packs[1])
            else:
                torch.cuda.synchronize()
                print(f"  {label}: {mux.widened} weight leaves widened at construction; "
                      f"memory {torch.cuda.memory_allocated(dev) / 1e9:.4f} GB with them",
                      flush=True)
            rng = np.random.default_rng(152)
            _admit_every_slot(mux, rng)
            hops = (rng.normal(size=(64, mux.tick_samples)) * 0.1).astype(np.float32)
            k = 0
            if mux.kv_window:
                k = _ticks_of_width(mux, hops, slots, fill, k, label=label)
            arms[arm] = [mux, hops, k]
        widened = arms["widened"][0].widened
        del params
        per_arm = {}
        for w in TICK_WIDTHS:
            for arm, entry in arms.items():
                mux, hops, k = entry
                name = f"{label} ({arm})"
                graphs0, launched0, ticks0 = len(mux._graphs), k7_launches(), mux.ticks
                k = _ticks_of_width(mux, hops, w, 3, k, label=name)
                if len(mux._graphs) != graphs0 + (w != slots or not mux.kv_window):
                    raise AssertionError(f"{name}: width {w} captured "
                                         f"{len(mux._graphs) - graphs0} graphs")
                torch.cuda.synchronize()
                t0, n0, r0 = time.perf_counter(), mux.ticks, mux.rows_stepped
                outs = [[] for _ in range(slots)]
                k = _ticks_of_width(mux, hops, w, timed, k, outs, label=name)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / timed
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    k = _ticks_of_width(mux, hops, w, traced, k, label=name)
                    torch.cuda.synchronize()
                entry[2] = k
                if mux.rows_stepped - r0 != w * (mux.ticks - n0):
                    raise AssertionError(f"{name}: {mux.rows_stepped - r0} rows stepped in "
                                         f"{mux.ticks - n0} ticks of width {w}")
                launched = k7_launches() - launched0
                if launched != 2 * (mux.ticks - ticks0):
                    raise AssertionError(f"{name}: K7 launched {launched} times in "
                                         f"{mux.ticks - ticks0} ticks of width {w}")
                busy, n_kernels = _device_busy(prof)
                per, casts = {}, 0
                for e in prof.key_averages():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        per[e.key] = per.get(e.key, 0.0) + e.device_time_total / traced / 1e3
                        casts += e.count * (CAST_KERNEL in e.key)
                k34 = sum(v for n, v in per.items() if any(x in n for x in K34_KERNELS))
                k6 = sum(v for n, v in per.items() if KV_KERNEL in n)
                k7 = sum(v for n, v in per.items() if ROW_COPY_KERNEL in n)
                cast_ms = sum(v for n, v in per.items() if CAST_KERNEL in n)
                top = sorted(((v, n) for n, v in per.items()), reverse=True)[:8]
                row = {"model": label, "arm": arm, "width": w, "wall_ms": wall,
                       "busy_ms": busy / traced, "k34_ms": k34, "k6_ms": k6, "k7_ms": k7,
                       "cast_ms": cast_ms, "casts": casts / traced,
                       "kernels": n_kernels / traced, "top": [[n[:90], v] for v, n in top]}
                rows.append(row)
                per_arm[arm, w] = (row, np.concatenate([np.concatenate(o) for o in outs]))
                print(f"  {label} tick at width {w} ({arm}) on {smi}: wall {wall:.4f} ms, device "
                      f"busy {busy / traced:.4f} ms a tick (K3/K4 {k34:.4f}, K6 {k6:.4f}, K7 "
                      f"{k7:.4f}, casts {cast_ms:.4f} in {casts / traced:.1f}; "
                      f"{n_kernels / traced:.1f} kernels a tick)", flush=True)
                for v, n in top:
                    print(f"      {v * 1e3:9.2f} us a tick  {n[:100]}", flush=True)
            (wide, y_w), (cast, y_c) = per_arm["widened", w], per_arm["cast", w]
            print(f"  {label} width {w}: widened / cast device busy {wide['busy_ms']:.4f} / "
                  f"{cast['busy_ms']:.4f} ms a tick ({wide['busy_ms'] - cast['busy_ms']:+.4f}); "
                  f"{cast['kernels'] - wide['kernels']:.1f} kernels and "
                  f"{cast['casts'] - wide['casts']:.1f} casts fewer a tick", flush=True)
            if not np.array_equal(y_w, y_c):
                faults.append(f"{label} width {w}: widened and cast outputs differ "
                              f"(max {np.abs(y_w - y_c).max():.3e})")
            # a trace may miss a launch at its start: a tick's counts to within half a kernel
            if w == 1 and not (abs(cast["kernels"] - wide["kernels"] - widened) < 0.5
                               and abs(cast["casts"] - wide["casts"] - widened) < 0.5
                               and wide["cast_ms"] < 0.1 * cast["cast_ms"]):
                faults.append(f"{label} width 1: {cast['kernels'] - wide['kernels']:.2f} kernels "
                              f"and {cast['casts'] - wide['casts']:.2f} casts fewer a tick, "
                              f"{widened} leaves widened; casts {wide['cast_ms']:.4f} against "
                              f"{cast['cast_ms']:.4f} ms a tick")
        print(f"  {label}: memory peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB (both "
              f"arms), {len(arms['widened'][0]._graphs)} graphs", flush=True)
        del arms, per_arm, entry, mux, stored
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tick_widths.json"), "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)
    print(f"  K7 launches over the graphed ticks of both models: {k7_launches()}", flush=True)
    if faults:
        raise AssertionError("tick widths: " + "; ".join(faults))
    return k7_launches()


def run_multiplexer(dev, cfg, params32, smi, scan):
    """Phase 15: ``SessionMultiplexer`` on E8 at full width.  Three staggered
    sessions (int8 weights, fp32 state) equal each streamed alone; slots 8 at
    block 16 (K1 launched) and slots 1 and 8 at block 1, each in bf16 and
    int8: traffic through the multiplexer (one tick a feed), its wall and
    device-busy per tick, and the batched step's throughput with every slot
    live (``cli/serve.py``'s bench, in process); then the serving CLIs as
    subprocesses.  Between them, ``check_tick_packs`` and
    ``check_tick_widths``.  Returns K1's launches on the multiplexer's
    block-16 runs, the tensor cores' K3/K4 launches (``check_tick_packs``)
    and K7's over the graphed ticks (``check_tick_widths``)."""
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

    mma = check_tick_packs(dev, cfg, params32, smi)
    k7 = check_tick_widths(dev, smi)

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
    return k1, mma, k7


# --------------------------------------------------------------------------
# Phases 16-17: the offline mamba2 / mamba_s4 forward, and evaluation
# --------------------------------------------------------------------------

def check_offline_families(dev, smi):
    """Phase 16: the offline forward of mamba2 and mamba_s4 (the SSD scan;
    the S4 kernel and FFT convolution: plain torch, no kernel of ours) at E8
    widths and at the FullMini geometry.  fp32, TF32 off: the card against
    the CPU at 2 x 2 s, and the streamed output against the offline one on
    the card (normalize_input=False); at E8 widths one bf16 train step, card
    against CPU; then the 2 x 10 s forward's times and peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.models.cleanumamba import (
        count_params,
        forward,
        init_params,
        prepare_for_length,
    )
    from cleanumamba_tpu_torch.params import to_device
    from cleanumamba_tpu_torch.streaming import Streamer
    from cleanumamba_tpu_torch.train.optim import make_optimizer
    from cleanumamba_tpu_torch.train.trainer import make_train_step

    x_cpu = _noise("cpu", 2, 2 * SR, seed=16, scale=0.1)
    e8_params = {}
    for geometry, make in (("E8", lambda f: CleanUMambaConfig(bottleneck=f)),
                           ("FullMini", _fullmini)):
        for family in ("mamba2", "mamba_s4"):
            cfg = make(family)
            # seeded on the host; mamba_s4 kernels attuned to 10 s (covers 2 s)
            p_cpu = prepare_for_length(init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                                       cfg, 10 * SR)
            p_dev = to_device(p_cpu, dev)
            if geometry == "E8":
                e8_params[family] = (cfg, p_cpu, p_dev)
            with torch.no_grad():
                ref = forward(p_cpu, x_cpu, cfg)
                got = forward(p_dev, x_cpu.to(dev), cfg)
            _finite(f"{geometry} {family} offline forward", got)
            err, rel = _rel_err(got.cpu(), ref)
            if not rel <= FP32_TOL:
                raise AssertionError(f"{geometry} {family} offline forward, card vs CPU: "
                                     f"relative error {rel:.3e} > {FP32_TOL:g}")
            cfg_n = dataclasses.replace(cfg, normalize_input=False)
            xs = _noise(dev, 1, SR, seed=17, scale=0.1)
            with torch.no_grad():
                offline = forward(p_dev, xs, cfg_n).cpu().numpy()
            streamer = Streamer(p_dev, cfg_n, dev)
            streamed, _ = _stream(streamer, xs.cpu().numpy(), 256)
            m = SR - cfg.frame_length
            np.testing.assert_allclose(streamed[:, :m], offline[:, :m], atol=2e-4, rtol=1e-3,
                                       err_msg=f"{geometry} {family}: streamed != offline")
            print(f"  {geometry} {family} ({count_params(p_cpu):,} params): offline 2 x 2 s fp32, "
                  f"card vs CPU max_abs_err={err:.3e} rel={rel:.3e} (tol {FP32_TOL:g}); streamed "
                  f"(Streamer mode {streamer.fused_mode!r}) == offline on the card over 1 s "
                  f"(atol 2e-4, rtol 1e-3)", flush=True)

    # one bf16 train step of each at E8 widths, the card against the CPU
    opt_cfg = OptimizationConfig()
    optimizer = make_optimizer(opt_cfg, schedule=lambda s: opt_cfg.learning_rate)
    rng = np.random.default_rng(18)
    clean = (rng.normal(size=(1, 1, SR // 2)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    for family, (cfg, p_cpu, p_dev) in e8_params.items():
        step = make_train_step(cfg, LossConfig(), optimizer, bf16=True)
        losses = []
        for d, p in ((dev, p_dev), (torch.device("cpu"), p_cpu)):
            batch = (torch.from_numpy(clean).to(d), torch.from_numpy(noisy).to(d))
            _, _, aux = step(p, optimizer.init(p), batch)
            if not bool(aux["grads_finite"]) or not np.isfinite(float(aux["loss"])):
                raise AssertionError(f"E8 {family} bf16 train step on {d}: not finite")
            losses.append(float(aux["loss"]))
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        if not rel <= 2e-4:
            raise AssertionError(f"E8 {family} bf16 train step: loss {losses[0]:.6f} on the "
                                 f"card, {losses[1]:.6f} on the CPU (rel {rel:.3e} > 2e-4)")
        print(f"  E8 {family} bf16 train step, 1 x 0.5 s: loss {losses[0]:.6f} on the card, "
              f"{losses[1]:.6f} on the CPU (rel {rel:.2e}, tol 2e-4); gradients finite",
              flush=True)

    # the 2 x 10 s offline forward on the card, fp32 (cell 3's shape)
    x = _noise(dev, 2, 10 * SR, seed=5, scale=0.1)
    n_prof = 5
    for family, (cfg, _, p_dev) in e8_params.items():
        with torch.no_grad():
            for _ in range(3):
                y = forward(p_dev, x, cfg)
            _finite(f"E8 {family} offline 10 s x 2", y)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            forward(p_dev, x, cfg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            wall = _host_ms(lambda: forward(p_dev, x, cfg), 10)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_prof):
                    forward(p_dev, x, cfg)
                torch.cuda.synchronize()
                traced = (time.perf_counter() - t0) * 1e3
        busy, n_kernels = _device_busy(prof)
        print(f"  E8 {family} offline forward 10 s x 2, fp32 (TF32 off), on {smi}: wall "
              f"{wall[len(wall) // 2]:.2f} ms median of 10 ({wall[0]:.2f}-{wall[-1]:.2f}); traced "
              f"{n_prof}: device busy {busy / n_prof:.3f} ms per forward (idle share "
              f"{1 - busy / traced:.3f}; {1 - busy / n_prof / wall[len(wall) // 2]:.3f} against the "
              f"untraced median), {n_kernels / n_prof:.0f} kernels per forward; peak memory "
              f"{peak / 2**30:.2f} GiB", flush=True)


def run_eval_path(dev, cfg, params32, counter, smi):
    """Phase 17: ``eval.validate`` on E8 mamba at full width (K1 once per
    layer and utterance), then ``cli/evaluate.py`` on the card and on the
    CPU, and ``cli/train.py`` validating mid-run, as subprocesses run
    together.  Returns K1's launches on the validate path."""
    from cleanumamba_tpu_torch.data import SyntheticDenoiseDataset
    from cleanumamba_tpu_torch.eval.validate import validate
    from cleanumamba_tpu_torch.params import load_checkpoint

    n_items, pad = 4, 4 * SR
    ds = SyntheticDenoiseDataset(n_items=n_items, seed=4242)
    validate(params32, cfg, ds, max_items=1, pad_to=pad)  # warm-up, outside the count
    counter.launches = 0
    t0 = time.perf_counter()
    metrics = validate(params32, cfg, ds, max_items=n_items, pad_to=pad)
    total = time.perf_counter() - t0
    k1 = counter.launches
    if k1 != cfg.tsfm_n_layers * n_items:
        raise AssertionError(f"validate launched K1 {k1} times, expected "
                             f"{cfg.tsfm_n_layers} x {n_items}")
    if not {"segsnr", "si_sdr", "llr", "wss", "pesq_wb", "pesq_nb"} <= set(metrics):
        raise AssertionError(f"validate: metrics missing or not finite: {metrics}")
    fwd_ms, metric_s = _eval_split(dev, params32, cfg, ds, n_items, pad)
    print(f"  validate, E8 mamba (random weights), {n_items} synthetic items padded to 4 s, on "
          f"{smi}: {total:.2f} s in all; K1 launched {k1} times ({cfg.tsfm_n_layers} per "
          f"utterance); forward {_median(fwd_ms):.2f} ms per utterance (synced; "
          f"{' '.join(f'{t:.2f}' for t in fwd_ms)}), host metric suite "
          f"{_median(metric_s):.3f} s per utterance ({' '.join(f'{t:.3f}' for t in metric_s)}); "
          f"the synced forwards are {sum(fwd_ms) / 1e3 / total:.4f} of validate's wall; means "
          + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()), flush=True)
    cfg_p, params_p = load_checkpoint(CKPT, dev)
    fwd_p, metric_p = _eval_split(dev, params_p, cfg_p, ds, n_items, pad)
    print(f"  the same split on {CKPT} (a trained model's output): forward "
          f"{_median(fwd_p):.2f} ms, host metric suite {_median(metric_p):.3f} s per utterance "
          f"({' '.join(f'{t:.3f}' for t in metric_p)})", flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        evaluate = [sys.executable, "-m", "cleanumamba_tpu_torch.cli.evaluate", "--ckpt", CKPT,
                    "--synthetic", "--max-items", "4", "--pad-to-sec", "4", "--json"]
        train_cmds = _train_cli_commands(tmp, root)

        def run_train():
            return [subprocess.run(c, cwd=root, capture_output=True, text=True, timeout=600)
                    for c in train_cmds]

        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            jobs = {d: pool.submit(subprocess.run, evaluate + ["--device", d], cwd=root,
                                   capture_output=True, text=True, timeout=600)
                    for d in ("cuda:0", "cpu")}
            train_job = pool.submit(run_train)
            done = {d: j.result() for d, j in jobs.items()}
            train_done = train_job.result()
        for name, r in list(done.items()) + [(f"train {i}", r) for i, r in enumerate(train_done)]:
            if r.returncode != 0:
                raise AssertionError(f"{name}: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                                     f"{r.stderr[-3000:]}")
        got, want = (json.loads(done[d].stdout.strip().splitlines()[-1]) for d in ("cuda:0", "cpu"))
        if sorted(got) != sorted(want):
            raise AssertionError(f"evaluate: metrics differ in kind: {got} vs {want}")
        for k in got:  # the CPU test's tolerances (tests/test_torch_validate.py)
            tol = 1e-2 if k in ("pesq_wb", "pesq_nb", "csig", "cbak", "covl") else 1e-3
            if not abs(got[k] - want[k]) <= tol + 1e-4:  # + the JSON line's rounding
                raise AssertionError(f"evaluate {k}: {got[k]} on the card, {want[k]} on the CPU")
        print(f"  cli/evaluate.py on {CKPT} (4 items, 4 s): card {json.dumps(got)}; CPU agrees "
              f"(1e-3, PESQ and composites 1e-2)", flush=True)
        _check_train_cli_validation(tmp, train_done)
    return k1


def _eval_split(dev, params, cfg, ds, n_items, pad):
    """Per utterance of ``ds`` cropped to ``pad``: the forward's synced ms on
    the card and the host metric suite's s, as ``validate`` runs them."""
    from cleanumamba_tpu_torch.eval.metrics import eval_waveform
    from cleanumamba_tpu_torch.models.cleanumamba import forward

    fwd_ms, metric_s = [], []
    for i in range(n_items):
        clean, noisy = ds[i][0][:pad], ds[i][1][:pad]
        xin = torch.from_numpy(noisy[None].astype(np.float32)).to(dev)
        with torch.no_grad():
            forward(params, xin, cfg)  # warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            den = forward(params, xin, cfg)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t1) * 1e3)
        den = den.cpu().numpy()[0]
        t1 = time.perf_counter()
        eval_waveform(np.clip(clean * 32768.0, -32768, 32767), np.clip(den * 32768.0, -32768, 32767))
        metric_s.append(time.perf_counter() - t1)
    return fwd_ms, metric_s


def _train_cli_commands(tmp, root):
    """cli/train.py on the small config of phase 8, 1 s crops, validating
    every 2 iterations on 2 items: 3 iterations, then a resume to 5."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig

    cfg = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=3, tsfm_n_layers=2,
                            tsfm_d_model=32, tsfm_n_head=4, tsfm_d_inner=64)
    exp = os.path.join(tmp, "exp.json")
    with open(exp, "w") as f:
        json.dump({"network": "CleanUMamba", "exp_path": "small",
                   "network_config": cfg.to_reference_json()}, f)
    with open(os.path.join(root, "configs", "train_synth.json")) as f:
        conf = json.load(f)
    conf["train_config"]["log"] = {"directory": os.path.join(tmp, "logs"), "ckpt_iter": "max",
                                   "iters_per_ckpt": 1000, "iters_per_valid": 2,
                                   "valid_max_items": 2}
    conf["trainset_config"] = {"crop_length_sec": 1.0}  # read at the top level
    path = os.path.join(tmp, "config.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    base = [sys.executable, "-m", "cleanumamba_tpu_torch.cli.train", "-c", path, "-e", exp,
            "--synthetic", "--log-every", "1"]
    return [base + ["--max-iters", "3"], base + ["--max-iters", "5"]]


def _check_train_cli_validation(tmp, runs):
    from cleanumamba_tpu_torch.utils import read_history

    for r, expect in zip(runs, ("iter 2: valid ", "iter 4: valid ")):
        if expect not in r.stdout:
            raise AssertionError(f"training CLI: no {expect!r}:\n{r.stdout[-3000:]}")
    if "resumed from iter 2" not in runs[1].stdout:
        raise AssertionError(f"training CLI did not resume:\n{runs[1].stdout[-2000:]}")
    rows = read_history(os.path.join(tmp, "logs", "small", "metrics.jsonl"))
    valid = [r for r in rows if r["_kind"] == "valid"]
    run_ids = {r["_run_id"] for r in rows}
    if [r["_step"] for r in valid] != [2, 4] or len(run_ids) != 1:
        raise AssertionError(f"metrics.jsonl: valid rows {[r['_step'] for r in valid]}, run ids "
                             f"{run_ids}")
    line = [ln for ln in runs[1].stdout.splitlines() if ln.startswith("iter 4: valid")][0]
    print(f"  cli/train.py validating mid-run (small config, 1 s crops): valid rows at "
          f"iterations 2 and 4 under one run id across the resume; {line}", flush=True)


# --------------------------------------------------------------------------
# Phase 18: structured channel pruning and finetune
# --------------------------------------------------------------------------

PRUNE_E8 = "configs/prune_e8_synth.json"
PRUNE_2M = "configs/prune_2m_synth.json"
# a group's importances, card against CPU, relative to its largest value: a
# taylor importance squares the gradient, which phase 8 holds to GRAD_TOL
IMP_TOL = 1e-3


def _pruning_config(path, **kw):
    from cleanumamba_tpu_torch.prune.driver import PruningConfig

    with open(path) as f:
        return PruningConfig(**{**json.load(f)["pruning_config"], **kw})


@contextlib.contextmanager
def _wrapped(module, name, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrapper(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _importance_spy(store):
    """A wrapper of ``get_prune_channels`` that records each group's
    importance vector and the selection made from it."""
    from cleanumamba_tpu_torch.prune.importance import calc_importance, group_importances

    def wrap(real):
        def run(groups, params, grads, metric, **kw):
            vecs = {g.name: np.asarray(calc_importance(group_importances(params, g, grads),
                                                       metric), np.float64) for g in groups}
            out = real(groups, params, grads, metric, **kw)
            store.append((vecs, out[0]))
            return out
        return run
    return wrap


def run_pruning(dev, cfg, params32, counters, smi, rep: Report):
    """Phase 18 (a): ``pruning_pipeline`` on E8 at full width (random fp32
    weights, seed 0) with ``configs/prune_e8_synth.json``'s phases, batch 2
    x 10 s synthetic crops, 32 iterations: prune events at 15 and 31, every
    iteration an fp32 gradient through K1 and K2.  Then K1 and K2 against
    their plain versions at every pruned layer's shape.  Returns the
    launches of the pipeline's run."""
    from cleanumamba_tpu_torch.config import LossConfig
    from cleanumamba_tpu_torch.data import SyntheticDenoiseDataset, make_loader
    from cleanumamba_tpu_torch.models.bottleneck_mamba import mixer_dims
    from cleanumamba_tpu_torch.models.cleanumamba import count_params
    from cleanumamba_tpu_torch.prune import driver
    from cleanumamba_tpu_torch.prune.groups import build_groups
    from cleanumamba_tpu_torch.train.trainer import make_grad_fn

    pcfg = _pruning_config(PRUNE_E8)
    ds = SyntheticDenoiseDataset(crop_length_sec=10.0)
    loader = make_loader(ds, 2)
    stamps, mem, reserved, owners, pools = [], [], [], [], {}

    def timed_data():  # the loop takes one batch an iteration: stamp each start
        while True:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            mem.append(torch.cuda.memory_allocated())
            reserved.append(torch.cuda.memory_reserved())
            if len(stamps) - 1 in (15, 31):  # the last gradient of a width is done
                pools[len(stamps) - 1] = _pool_mb(owners[0].pool)
            yield next(loader)

    def keep_owner(real):  # the pipeline's gradient graphs (graphs.ForwardGraphs)
        def make(fn, device):
            owners.append(real(fn, device))
            return owners[-1]
        return make

    events = []

    def time_selection(real):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            events.append({"select_ms": (time.perf_counter() - t0) * 1e3, "selection": out[0]})
            return out
        return run

    def time_apply(real):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            events[-1].update(apply_ms=(time.perf_counter() - t0) * 1e3,
                              peak=torch.cuda.max_memory_allocated(),
                              shapes=[mixer_dims(lp["mixer"])[1:3]
                                      for lp in out[0]["bottleneck"]["layers"]])
            return out
        return run

    n0 = count_params(params32)
    n_iters = 32
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _wrapped(driver, "get_prune_channels", time_selection), \
            _wrapped(driver, "apply_pruning", time_apply), \
            _wrapped(driver, "ForwardGraphs", keep_owner):
        params, _, history, stopped = driver.pruning_pipeline(
            params32, cfg, LossConfig(), timed_data(), pcfg, batch_size=2, max_iters=n_iters)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    mem.append(torch.cuda.memory_allocated())  # after the loop: its params and Adam state

    if stopped is not None or [h["n_iter"] for h in history] != [15, 31]:
        raise AssertionError(f"expected prune events at 15 and 31, got "
                             f"{[h['n_iter'] for h in history]} (stopped: {stopped})")
    counts = [n0] + [h["params"] for h in history]
    if not all(a > b for a, b in zip(counts, counts[1:])):
        raise AssertionError(f"the parameter count did not fall at each event: {counts}")
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"non-finite loss at a prune event: {history}")
    for g in build_groups(params, cfg):
        g.check(params)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the pruning path")
    it_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]  # iteration i: it_ms[i]
    loop = {"before event 1": [it_ms[i] for i in range(1, 15)],
            "after it": [it_ms[i] for i in range(16, 31)]}
    # the gradient alone at each width (no prune phase trains, so the
    # params after event 1 are the first selection applied to the start):
    # synced wall a gradient, then a traced one's device busy and kernels
    from torch.profiler import ProfilerActivity, profile

    grad_fn = make_grad_fn(cfg, LossConfig(), bf16=False)
    clean, noisy = (torch.from_numpy(x).to(dev)[None] for x in next(loader))
    widths = {"at the start": params32,
              "after event 1": driver.apply_pruning(params32, events[0]["selection"], cfg)[0],
              "after event 2": params}
    grads = {}
    for name, p in widths.items():
        wall = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grad_fn(p, clean, noisy)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grad_fn(p, clean, noisy)
            torch.cuda.synchronize()
        busy, n_kernels = _device_busy(prof)
        grads[name] = (_median(wall[1:]), busy, n_kernels)
    del widths
    synth_ms = []  # what the loader's thread spends on one batch of 2 x 10 s
    for i in range(4):
        t1 = time.perf_counter()
        [ds[2 * i + k] for k in range(2)]
        synth_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"  E8 pruning_pipeline ({PRUNE_E8}, batch 2 x 10 s, fp32 gradient), {n_iters} "
          f"iterations on {smi}: {total:.1f} s in all; the loop's ms an iteration (median; "
          f"batch, gradient, accumulation) " + ", ".join(
              f"{k} {_median(v):.1f} ({min(v):.1f}-{max(v):.1f})" for k, v in loop.items())
          + "; a gradient alone (synced wall median of 5 / device busy / kernels) " + ", ".join(
              f"{k} {w:.1f} / {b:.1f} ms / {n}" for k, (w, b, n) in grads.items())
          + f"; the host synthesizes a batch in {_median(synth_ms):.1f} ms ("
          + " ".join(f"{t:.1f}" for t in synth_ms) + ")"
          + f"; K1 {launches['selective_scan']}, K2 {launches['selective_scan_bwd']} launches "
          f"({launches['selective_scan'] / n_iters:.1f} and "
          f"{launches['selective_scan_bwd'] / n_iters:.1f} per iteration); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for i, (h, e) in enumerate(zip(history, events)):
        print(f"  event {i + 1} at iteration {h['n_iter']}: params {counts[i]:,} -> "
              f"{h['params']:,}, channels {h['channels']}, loss {h['loss']:.4f}; importances "
              f"and selection on the host {e['select_ms']:.1f} ms, apply_pruning "
              f"{e['apply_ms']:.1f} ms; peak memory so far {e['peak'] / 2**30:.2f} GiB, "
              f"allocated after it {mem[h['n_iter'] + 1] / 2**30:.3f} GiB; (d_inner, d_state) "
              f"by layer {e['shapes']}; pruned {h['pruned']}", flush=True)
    # allocated at an iteration's start: iteration 1 and 16 each hold the
    # params, the Adam state and an accumulator of their width; nothing of
    # the old width may stay behind an event
    print(f"  allocated at iterations 0 / 1 / 16 / 31 and after the loop: "
          + " / ".join(f"{mem[i] / 2**30:.3f}" for i in (0, 1, 16, 31, 32)) + " GiB", flush=True)
    if not mem[16] <= mem[1]:
        raise AssertionError(f"device memory grew across an event: {mem[1]} -> {mem[16]}")
    # reserved: each width's gradient graph is captured at its second call
    # (iterations 1 and 17); the event drops the old one and its pool
    print(f"  reserved at iterations 1 / 2 / 15 / 16 / 17 / 18 / 31: "
          + " / ".join(f"{reserved[i] / 2**30:.3f}" for i in (1, 2, 15, 16, 17, 18, 31))
          + f" GiB; the gradient's graph pool at iterations 15 / 31: {pools[15]:.0f} / "
          f"{pools[31]:.0f} MiB; {len(owners)} owner, {len(owners[0])} graph after the loop",
          flush=True)
    if not max(reserved[18:32]) <= reserved[15] + pools[31] * 2**20:
        raise AssertionError(f"reserved memory grew across an event by more than one graph "
                             f"pool: {reserved[15]} -> {max(reserved[18:32])}")

    shapes = sorted({s for e in events for s in e["shapes"]})
    cases = [(2, 625, di, ds, True) for di, ds in shapes]
    check_scan(dev, rep, cases)
    check_scan_bwd(dev, rep, cases)
    return launches


def check_prune_card_vs_cpu(dev):
    """Phase 18 (b): one prune event of phase 8's small config on the card
    and on the CPU, from the same weights and batch (seed 8, fixed before
    the first run): importances, selections and the pruned forward."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
    from cleanumamba_tpu_torch.models.cleanumamba import forward, init_params
    from cleanumamba_tpu_torch.params import from_numpy, to_numpy
    from cleanumamba_tpu_torch.prune import driver
    from cleanumamba_tpu_torch.prune.pruner import apply_pruning

    cfg = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=3, tsfm_n_layers=2,
                            tsfm_d_model=32, tsfm_n_head=4, tsfm_d_inner=64)
    weights = to_numpy(init_params(cfg, torch.Generator().manual_seed(8), "cpu"))
    rng = np.random.default_rng(8)
    clean = (rng.normal(size=(2, 4096)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    # one prune at iteration 0: a batch of gradient, 20 % of the channels
    pcfg = driver.PruningConfig(training_samples=2, pruning_grad_samples=2, pruning_repeats=1,
                                steps_per_valid=1, perc_prune_channels_per_iter=0.2,
                                max_prune_importance_per_iter=None, min_channels_per_group=4,
                                min_total_channels=10)
    runs = []
    for d in (dev, torch.device("cpu")):
        rec = []
        with _wrapped(driver, "get_prune_channels", _importance_spy(rec)):
            params, _, _, _ = driver.pruning_pipeline(
                from_numpy(weights, d), cfg, LossConfig(), iter([(clean, noisy)]), pcfg,
                batch_size=2, max_iters=1)
        runs.append((params, *rec[0]))
    (p_gpu, v_gpu, s_gpu), (p_cpu, v_cpu, s_cpu) = runs
    worst, dev_abs = 0.0, {}
    for name, ref in v_cpu.items():
        err = np.abs(v_gpu[name] - ref).max()
        dev_abs[name] = err
        worst = max(worst, err / max(np.abs(ref).max(), 1e-30))
        if not err <= IMP_TOL * np.abs(ref).max():
            raise AssertionError(f"importances of {name}: card vs CPU {err:.3e} > {IMP_TOL:g} "
                                 f"of {np.abs(ref).max():.3e}")
    # near-ties: pairs among the values the selection reads (each group's
    # n_prune + 1 smallest) that the two devices order differently
    total = sum(len(v) for v in v_cpu.values())
    n_read = max(4, int(total * pcfg.perc_prune_channels_per_iter)) + 1
    idx = {k: np.union1d(np.argsort(v_cpu[k])[:n_read], np.argsort(v_gpu[k])[:n_read])
           for k in v_cpu}
    owner = np.concatenate([[k] * len(i) for k, i in idx.items()])
    a = np.concatenate([v_gpu[k][i] for k, i in idx.items()])
    b = np.concatenate([v_cpu[k][i] for k, i in idx.items()])
    flips = np.argwhere(np.sign(a[:, None] - a[None, :]) != np.sign(b[:, None] - b[None, :]))
    for i, j in flips:  # a flip is a near-tie: the pair's gap is within the deviation
        if not abs(b[i] - b[j]) <= dev_abs[owner[i]] + dev_abs[owner[j]]:
            raise AssertionError(f"{owner[i]} / {owner[j]}: the order flipped across a gap of "
                                 f"{abs(b[i] - b[j]):.3e}, beyond the deviation")
    ties = {owner[i] for i, _ in flips} | {owner[j] for _, j in flips}
    for name in v_cpu:
        if name not in ties and sorted(s_gpu.get(name, [])) != sorted(s_cpu.get(name, [])):
            raise AssertionError(f"selection of {name}: card {s_gpu.get(name)} vs CPU "
                                 f"{s_cpu.get(name)}")
    same = s_gpu == s_cpu
    if not same:  # a near-tie moved a channel: prune the card's weights as the CPU did
        p_gpu, _, _ = apply_pruning(from_numpy(weights, dev), s_cpu, cfg)
    x = torch.from_numpy(noisy)
    with torch.no_grad():
        y_gpu = forward(p_gpu, x.to(dev), cfg).cpu()
        y_cpu = forward(p_cpu, x, cfg)
    _, rel = _rel_err(y_gpu, y_cpu)
    if not rel <= FP32_TOL:
        raise AssertionError(f"pruned forward, card vs CPU: {rel:.3e} > {FP32_TOL:g}")
    print(f"  small config, one prune event on the card and on the CPU: importances agree to "
          f"{worst:.3e} of each group's largest (tol {IMP_TOL:g}); {sum(map(len, s_cpu.values()))}"
          f" channels in {len(s_cpu)} groups selected, {'the same on both' if same else 'not the same'}; "
          f"{len(ties)} groups left out as near-ties ({len(flips) // 2} flipped pairs); pruned "
          f"forward {rel:.3e} of max|ref| (tol {FP32_TOL:g})", flush=True)


def _run(cmd, root, timeout=600):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[2:])}: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-3000:]}")
    return r.stdout, time.perf_counter() - t0


def run_prune_clis(dev):
    """Phase 18 (c): the prune, finetune, evaluate and calibrate CLIs as
    subprocesses on ``artifacts/pruned_473k_finetuned.pkl``: prune to 16
    iterations and resume to 32 under one run id, finetune the result 4
    iterations (and again 4 with ``--device-data 2``), evaluate the
    finetuned checkpoint, and the calibration experiment on the artifact."""
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.params import load_checkpoint, tensor_leaves
    from cleanumamba_tpu_torch.prune.groups import build_groups
    from cleanumamba_tpu_torch.utils import read_history

    root = os.path.dirname(os.path.abspath(__file__))
    py = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        ck_dir = os.path.join(out, "Prune-2M-synth", "checkpoint")
        prune = py + ["cleanumamba_tpu_torch.cli.prune", "-t", CKPT, "-e", PRUNE_2M,
                      "--synthetic", "--crop-sec", "2", "--out", out]
        final = os.path.join(ck_dir, "31.pkl")
        ft = [os.path.join(tmp, d, "checkpoint") for d in ("ft", "ft_device_data")]
        finetune = py + ["cleanumamba_tpu_torch.cli.finetune", "--ckpt", final, "--synthetic",
                         "--crop-sec", "2", "--iters", "4"]
        cal_out = os.path.join(tmp, "cal")

        def chain():
            logs = [_run(prune + ["--max-iters", "16"], root),
                    _run(prune + ["--max-iters", "32"], root),
                    _run(finetune + ["--log-every", "1", "--out", ft[0]], root),
                    _run(finetune + ["--device-data", "2", "--log-every", "2", "--out", ft[1]],
                         root),
                    _run(py + ["cleanumamba_tpu_torch.cli.evaluate", "--ckpt",
                               os.path.join(ft[0], "3.pkl"), "--synthetic", "--max-items", "2",
                               "--pad-to-sec", "2", "--json"], root)]
            return logs

        calibrate = py + ["cleanumamba_tpu_torch.cli.calibrate", "--ckpt", CKPT, "--n-batches",
                          "2", "--sample-size", "2", "--out", cal_out]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            job = pool.submit(chain)
            cal_log = pool.submit(_run, calibrate, root).result()
            logs = job.result()
        names = ("prune to 16", "prune resumed to 32", "finetune 4", "finetune 4 --device-data 2",
                 "evaluate")
        for name, (_, secs) in zip(names + ("calibrate",), logs + [cal_log]):
            print(f"  cli: {name}: {secs:.1f} s", flush=True)
        if "teacher:" not in logs[0][0] or "resumed pruning from iter 15" not in logs[1][0]:
            raise AssertionError(f"prune CLI did not start and resume as expected:\n"
                                 f"{logs[0][0][-1500:]}\n{logs[1][0][-1500:]}")
        if sorted(os.listdir(ck_dir)) != ["15.pkl", "31.pkl"]:
            raise AssertionError(f"prune CLI checkpoints: {sorted(os.listdir(ck_dir))}")
        rows = read_history(os.path.join(out, "Prune-2M-synth", "metrics.jsonl"))
        prunes = [r for r in rows if r["_kind"] == "prune"]
        if [r["_step"] for r in prunes] != [15, 31] or len({r["_run_id"] for r in rows}) != 1 \
                or [r["_kind"] for r in rows].count("summary") != 2:
            raise AssertionError("prune CLI metrics.jsonl: " + str(
                [(r["_kind"], r.get("_step"), r["_run_id"]) for r in rows]))
        cfg0, p0 = load_checkpoint(CKPT, dev)
        cfg, pruned = load_checkpoint(final, dev)
        for g in build_groups(pruned, cfg):
            g.check(pruned)
        shapes = [tuple(x.shape) for x in tensor_leaves(pruned)]
        for d in ft:
            if sorted(os.listdir(d)) != ["3.pkl"]:
                raise AssertionError(f"finetune CLI wrote {os.listdir(d)} into {d}")
            cfg_f, p_f = load_checkpoint(os.path.join(d, "3.pkl"), dev)
            if [tuple(x.shape) for x in tensor_leaves(p_f)] != shapes:
                raise AssertionError("finetune changed a ragged shape")
            x = torch.from_numpy((np.random.default_rng(9).normal(size=(1, SR)) * 0.1)
                                 .astype(np.float32)).to(dev)
            with torch.no_grad():
                _finite(f"forward of {d}/3.pkl", forward(p_f, x, cfg_f))
            rows = read_history(os.path.join(os.path.dirname(d), "metrics.jsonl"))
            if not [r for r in rows if r["_kind"] == "train"]:
                raise AssertionError(f"finetune CLI logged no train row in {os.path.dirname(d)}")
        metrics = json.loads(logs[4][0].strip().splitlines()[-1])
        if not {"segsnr", "si_sdr", "pesq_wb"} <= set(metrics):
            raise AssertionError(f"evaluate CLI: {metrics}")
        n_groups = len(build_groups(p0, cfg0))
        cal = [r for r in read_history(os.path.join(cal_out, "metrics.jsonl"))
               if r["_kind"] == "calibration_experiment"]
        if len(cal) != 2 * n_groups or not all(np.isfinite(r["loss_change"]) for r in cal):
            raise AssertionError(f"calibrate CLI: {len(cal)} rows for {n_groups} groups")
        print(f"  cli: {CKPT} ({sum(x.numel() for x in tensor_leaves(p0)):,} params) pruned to "
              f"{sum(x.numel() for x in tensor_leaves(pruned)):,} at iterations 15 and 31 under "
              f"one run id; finetuned 4 iterations twice (loader, --device-data 2), every ragged "
              f"shape kept, forward finite; evaluate {json.dumps(metrics)}; calibrate "
              f"{len(cal)} probes over {n_groups} groups", flush=True)


# --------------------------------------------------------------------------
# Phase 19: knowledge distillation, E8 teacher and FullMini student
# --------------------------------------------------------------------------

KD_STEPS = 3


def _leafwise(got, ref) -> dict:
    """The worst leaf of ``got`` against ``ref``, apart for the leaves above
    and below the floor: ``{"above": (max|err| / max|ref| of its leaf,
    where), "below": (max|err| / floor, where), "n_below": count}``.  The
    floor is 1e-3 of the largest leaf's max|ref|: a leaf whose exact value
    is near zero (the KD adapter's ``embed_b`` gradient: the batch norm
    after it removes any shift) holds only rounding noise, measured against
    the model's scale."""
    refs = [r.float().cpu() for r in ref]
    floor = 1e-3 * max(r.abs().max().item() for r in refs)
    out = {"above": (0.0, None), "below": (0.0, None), "n_below": 0}
    for i, (x, r) in enumerate(zip(got, refs)):
        scale = r.abs().max().item()
        side = "above" if scale >= floor else "below"
        out["n_below"] += side == "below"
        err = (x.float().cpu() - r).abs().max().item() / max(scale, floor)
        if err > out[side][0]:
            out[side] = (err, f"leaf {i} {tuple(r.shape)}")
    return out


def _check_leafwise(name, got, ref, tol=GRAD_TOL, tol_below=None) -> dict:
    """``_leafwise``, raising where a leaf is off by more than ``tol`` of its
    max (``tol_below`` of the floor for the leaves below it; default tol)."""
    res = _leafwise(got, ref)
    for side, t in (("above", tol), ("below", tol if tol_below is None else tol_below)):
        err, at = res[side]
        if not err <= t:
            raise AssertionError(f"{name}: {at} off by {err:.3e} (tol {t:.3e}, {side} the floor)")
    return res


def _scan_shape(cfg, B, L):
    """K1/K2's (B, L, d_inner, d_state) in ``cfg``'s mamba bottleneck at
    batch ``B`` of ``L`` samples."""
    return B, L // cfg.total_stride, cfg.tsfm_d_inner, cfg.d_state


def run_kd(dev, teacher_cfg, teacher, smi, counters, rep):
    """Phase 19: ``train/distill.make_kd_train_step`` with the E8 teacher
    (seed 0, fp32, frozen) and a FullMini student (nine skip connections on
    both sides), bf16, batch 2 x 10 s from ``synth_batch`` on the card; K1
    and K2 against their plain versions at the student's and the teacher's
    shapes of that batch; then one fp32 KD gradient on the card against the
    CPU.  Returns K1's and K2's launches on the KD steps."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.models.cleanumamba import count_params, init_params
    from cleanumamba_tpu_torch.train.distill import (
        make_kd_adapters,
        make_kd_train_step,
        skip_widths,
    )
    from cleanumamba_tpu_torch.train.optim import make_optimizer

    s_cfg = _fullmini("mamba")
    if not len(skip_widths(s_cfg)) == len(skip_widths(teacher_cfg)) == 9:
        raise AssertionError("teacher and student must have nine skip connections")
    student = init_params(s_cfg, torch.Generator().manual_seed(19), dev)
    adapters = make_kd_adapters(torch.Generator().manual_seed(20), s_cfg, teacher_cfg,
                                device=dev)
    opt_cfg = OptimizationConfig()  # adam, lr 1e-4, bf16
    optimizer = make_optimizer(opt_cfg, schedule=lambda s: opt_cfg.learning_rate)
    opt_state = optimizer.init((student, adapters))
    step = make_kd_train_step(s_cfg, teacher_cfg, LossConfig(kd_p=1.0), optimizer,
                              bf16=opt_cfg.bf16)
    gen = torch.Generator(device=dev).manual_seed(19)
    B, L = 2, 10 * SR

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(KD_STEPS):
        batch = synth_batch(gen, B, L)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        student, adapters, opt_state, aux = step(student, adapters, opt_state, teacher, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        loss, kd = float(aux["loss"]), float(aux["kd_loss"])
        if not (np.isfinite(loss) and np.isfinite(kd)):
            raise AssertionError(f"KD step {i}: loss {loss}, kd_loss {kd}")
        print(f"  KD step {i}: loss={loss:.4f} kd_loss={kd:.4f} {times[-1]:.1f} ms", flush=True)
    launches = {c.__name__: c.launches for c in counters}
    print(f"  kernel launches on the KD steps: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the KD path")
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        student, adapters, opt_state, aux = step(student, adapters, opt_state, teacher, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n_kernels = _device_busy(prof)
    print(f"  E8 teacher ({count_params(teacher):,}) -> FullMini student "
          f"({count_params(student):,}), bf16, batch 2 x 10 s, on {smi}: "
          f"{_median(times[1:]):.1f} ms/step untraced ({' '.join(f'{t:.1f}' for t in times)}); "
          f"traced step wall {wall:.1f} ms, device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall:.3f}), {n_kernels} kernels; peak memory {peak / 2**30:.2f} GiB")
    cases = [(*_scan_shape(c, B, L), True) for c in (s_cfg, teacher_cfg)]
    check_scan(dev, rep, cases)
    check_scan_bwd(dev, rep, cases[:1])  # the teacher runs no backward
    print(f"  K1 at {[c[:4] for c in cases]} and K2 at {cases[0][:4]} vs their plain versions: "
          "passed", flush=True)
    check_kd_grad(dev, s_cfg, teacher_cfg, teacher)
    return launches


def check_kd_grad(dev, s_cfg, t_cfg, teacher):
    """One fp32 KD gradient (student params and adapters) of the E8 teacher
    and FullMini student on the card (K1/K2) against the CPU (plain), on
    batch 2 x 16384 samples, every leaf held to max(GRAD_TOL, twice the
    CPU's own spread) up to KD_TOL_CAP (KD_TOL_CAP_BELOW of the floor for
    the leaves below it): the same gradient on the CPU with one thread moves
    ~2e-4 of a leaf's max (the batch norms of the KD loss cancel large
    terms in every per-channel shift), so GRAD_TOL alone would refuse the
    CPU against itself.  A spread past a cap raises.  The bf16 gradient on
    the card must be off by more than KD_TOL_CAP, so that the limit tells
    bf16 arithmetic from fp32."""
    from cleanumamba_tpu_torch.config import LossConfig
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.params import from_numpy, tensor_leaves, to_numpy
    from cleanumamba_tpu_torch.train.distill import make_kd_adapters, make_kd_grad_fn

    student = to_numpy(init_params(s_cfg, torch.Generator().manual_seed(21)))
    adapters = to_numpy(make_kd_adapters(torch.Generator().manual_seed(22), s_cfg, t_cfg,
                                         device="cpu"))
    teacher_np = to_numpy(teacher)
    clean, noisy = (t.cpu() for t in synth_batch(torch.Generator().manual_seed(23), 2, 16384))
    grad_fn = make_kd_grad_fn(s_cfg, t_cfg, LossConfig(kd_p=1.0), bf16=False)
    out = {}
    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    grad_bf16 = make_kd_grad_fn(s_cfg, t_cfg, LossConfig(kd_p=1.0), bf16=True)
    for key, d, n, fn in (("cuda", dev, threads, grad_fn),
                          ("cuda_bf16", dev, threads, grad_bf16),
                          ("cpu", torch.device("cpu"), threads, grad_fn),
                          ("cpu1", torch.device("cpu"), 1, grad_fn)):
        torch.set_num_threads(n)
        grads, aux = fn(from_numpy(student, d), from_numpy(adapters, d),
                        from_numpy(teacher_np, d), (clean.to(d), noisy.to(d)))
        out[key] = tensor_leaves(grads), aux
    torch.set_num_threads(threads)
    (g_gpu, a_gpu), (g_cpu, a_cpu), (g_cpu1, _) = out["cuda"], out["cpu"], out["cpu1"]
    spread = _leafwise(g_cpu1, g_cpu)
    tol, tol_below = (max(GRAD_TOL, 2 * spread[side][0]) for side in ("above", "below"))
    for side, t, cap in (("above", tol, KD_TOL_CAP), ("below", tol_below, KD_TOL_CAP_BELOW)):
        if not t <= cap:
            raise AssertionError(f"KD gradient: twice the CPU's own spread {side} the floor, "
                                 f"{t:.3e} ({spread[side][1]}), passes the cap {cap:g}")
    bf16_err = _leafwise(out["cuda_bf16"][0], g_cpu)["above"]
    if not bf16_err[0] > KD_TOL_CAP:
        raise AssertionError(f"KD gradient: the bf16 gradient is within the cap {KD_TOL_CAP:g} "
                             f"({bf16_err[0]:.3e}), so the cap cannot tell bf16 from fp32")
    res = _check_leafwise("KD gradient, card vs CPU", g_gpu, g_cpu, tol, tol_below)
    for k in ("loss", "kd_loss"):
        _, rel = _rel_err(a_gpu[k].cpu(), a_cpu[k])
        if not rel <= FP32_TOL:
            raise AssertionError(f"KD {k}: card vs CPU relative error {rel:.3e} > {FP32_TOL:g}")
    print(f"  fp32 KD gradient, batch 2 x 16384, card vs CPU ({threads} threads), {len(g_cpu)} "
          f"leaves: worst {res['above'][0]:.3e} of its leaf's max ({res['above'][1]}; tol "
          f"{tol:.3e} = max({GRAD_TOL:g}, 2 x the CPU's own spread {spread['above'][0]:.3e}, "
          f"{spread['above'][1]}, 1 thread against {threads})); the {res['n_below']} leaves "
          f"below the floor: {res['below'][0]:.3e} of the floor (tol {tol_below:.3e}, CPU spread "
          f"{spread['below'][0]:.3e}; caps {KD_TOL_CAP:g} and {KD_TOL_CAP_BELOW:g}); the bf16 "
          f"gradient on the card: {bf16_err[0]:.3e} ({bf16_err[1]}); kd_loss "
          f"{float(a_gpu['kd_loss']):.5f} vs "
          f"{float(a_cpu['kd_loss']):.5f} ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------
# Phase 20: data parallelism, two gloo ranks on the one card
# --------------------------------------------------------------------------

DP_LR = 1e-4
DP_TIMED_STEPS = 3


def _dp_optimizer():
    """Adam with eps 1.0 for the comparison: its first update, lr * g /
    (|g| + eps), is smooth in g; at eps 1e-8 it is lr * sign(g), and a
    gradient near zero flips sign with the summation order."""
    from cleanumamba_tpu_torch.config import OptimizationConfig
    from cleanumamba_tpu_torch.train.optim import make_optimizer

    return make_optimizer(OptimizationConfig(learning_rate=DP_LR, eps=1.0),
                          schedule=lambda s: DP_LR)


def dp_worker(job_dir) -> int:
    """One rank of phase 20 (``--dp-worker DIR``, started by the phase with
    the process group's environment): E8 on ``cuda:0`` with gloo, its half
    of the global batch.  Writes ``rank{r}.pt``: the averaged fp32 gradient,
    the params after one sharded fp32 step, K1's and K2's launches, and the
    times of bf16 steps and of the gradient all-reduce alone."""
    import torch.distributed as dist

    from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan, selective_scan_bwd
    from cleanumamba_tpu_torch.parallel import batch_sharding, make_mesh, pmean
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.train.trainer import (
        make_grad_fn,
        make_train_step,
        shard_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh("cuda:0", backend="gloo")
    dev = mesh.device
    cfg = CleanUMambaConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    job = torch.load(os.path.join(job_dir, "job.pt"))
    clean, noisy = job["clean"].to(dev), job["noisy"].to(dev)  # (1, 2, L): the global batch
    optimizer = _dp_optimizer()
    counters = (selective_scan, selective_scan_bwd)
    for c in counters:
        c.launches = 0
    grads, _ = make_grad_fn(cfg, LossConfig(), bf16=False)(
        params, batch_sharding(mesh, clean, 1), batch_sharding(mesh, noisy, 1))
    mean = pmean(mesh, tensor_leaves(grads))
    step = shard_train_step(make_train_step(cfg, LossConfig(), optimizer, bf16=False, mesh=mesh),
                            mesh)
    new, _, aux = step(params, optimizer.init(params), (clean, noisy))
    launches = {c.__name__: c.launches for c in counters}

    # times: bf16 steps (the CLI's default) and the all-reduce of a gradient alone
    bf16 = shard_train_step(make_train_step(cfg, LossConfig(), optimizer, bf16=True, mesh=mesh),
                            mesh)
    state = optimizer.init(params)
    p = params
    step_ms, reduce_ms = [], []
    for _ in range(DP_TIMED_STEPS + 1):
        dist.barrier(mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, _ = bf16(p, state, (clean, noisy))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    leaves = tensor_leaves(grads)
    for _ in range(DP_TIMED_STEPS + 1):
        dist.barrier(mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pmean(mesh, leaves)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    torch.save({"grads": [g.cpu() for g in mean], "params": [t.cpu() for t in tensor_leaves(new)],
                "aux": {k: float(v) for k, v in aux.items()}, "launches": launches,
                "step_ms": step_ms[1:], "reduce_ms": reduce_ms[1:],
                "reduce_bytes": sum(t.numel() * t.element_size() for t in leaves)},
               os.path.join(job_dir, f"rank{mesh.rank}.pt"))
    dist.barrier(mesh.group)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_dp(dev, cfg, params32, smi, rep):
    """Phase 20: K1 and K2 against their plain versions at a rank's shape
    (E8, batch 1 x 10 s); two ranks on ``cuda:0`` with a gloo group (NCCL
    refuses two ranks on one device) at that batch each, against one process
    over the same two items (fp32, TF32 off): the averaged gradient and the
    params after one step within GRAD_TOL of each leaf, the ranks' params
    bitwise equal; the all-reduce's share of a bf16 step.  (Its torchrun
    CLI check is ``check_torchrun_cli``.)  Returns K1's and K2's launches on
    the ranks' steps."""
    from cleanumamba_tpu_torch.config import LossConfig
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.train.trainer import make_grad_fn, make_train_step

    L = 10 * SR
    cases = [(*_scan_shape(cfg, 1, L), True)]
    check_scan(dev, rep, cases)
    check_scan_bwd(dev, rep, cases)
    print(f"  K1 and K2 at a rank's {cases[0][:4]} vs their plain versions: passed", flush=True)
    clean, noisy = synth_batch(torch.Generator(device=dev).manual_seed(20), 2, L)
    clean, noisy = clean.reshape(1, 2, L), noisy.reshape(1, 2, L)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"clean": clean.cpu(), "noisy": noisy.cpu()}, os.path.join(tmp, "job.pt"))
        env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", tmp],
                                  cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"DP rank {r} exited {p.returncode}:\n{log[-4000:]}")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    r0, r1 = ranks
    if not all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"])):
        raise AssertionError("the two ranks' params differ after the step")
    if r0["aux"] != r1["aux"]:
        raise AssertionError(f"the ranks' aux differ: {r0['aux']} vs {r1['aux']}")
    for r in ranks:
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched on a DP rank's step")

    # one process over the same two items, as two micro-batches (a mean over
    # ranks is a mean over micro-batches: the STFT spectral convergence is a
    # ratio of norms over its batch)
    micro = clean.reshape(2, 1, L), noisy.reshape(2, 1, L)
    grads, _ = make_grad_fn(cfg, LossConfig(), bf16=False)(params32, *micro)
    g_res = _check_leafwise("DP gradient", r0["grads"], tensor_leaves(grads))
    optimizer = _dp_optimizer()
    new, _, aux = make_train_step(cfg, LossConfig(), optimizer, bf16=False)(
        params32, optimizer.init(params32), micro)
    p_res = _check_leafwise("DP params", r0["params"], tensor_leaves(new))
    _, loss_rel = _rel_err(torch.tensor(r0["aux"]["loss"]), aux["loss"].cpu())
    if not loss_rel <= FP32_TOL:
        raise AssertionError(f"DP loss: relative error {loss_rel:.3e} > {FP32_TOL:g}")
    step_ms, reduce_ms = _median(r0["step_ms"]), _median(r0["reduce_ms"])
    print(f"  2 gloo ranks on one card, E8 fp32 batch 1 x 10 s each ({wall:.1f} s with start-up) "
          f"vs one process over both items: averaged gradient worst {g_res['above'][0]:.3e}, "
          f"params after one step worst {p_res['above'][0]:.3e} of the leaf's max (tol "
          f"{GRAD_TOL:g}; below the floor {g_res['below'][0]:.3e}, {p_res['below'][0]:.3e}); "
          f"loss {loss_rel:.3e}; "
          f"ranks' params bitwise equal; launches per rank {r0['launches']}")
    print(f"  bf16 step per rank on {smi}, both ranks on one card: {step_ms:.1f} ms "
          f"({' '.join(f'{t:.1f}' for t in r0['step_ms'])}); gradient all-reduce through "
          f"gloo alone ({r0['reduce_bytes'] / 2**20:.1f} MiB fp32): {reduce_ms:.1f} ms "
          f"({' '.join(f'{t:.1f}' for t in r0['reduce_ms'])}), {reduce_ms / step_ms:.3f} of the step")
    return {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}


def check_torchrun_cli():
    """The training CLI of E8 under ``torchrun --nproc-per-node 1`` (NCCL,
    world 1): 2 iterations, then resumed to 3, and a forward from the last
    checkpoint."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.train.checkpoint import find_max_epoch, load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp.json")
        with open(exp, "w") as f:
            json.dump({"network": "CleanUMamba", "exp_path": "e8",
                       "network_config": CleanUMambaConfig().to_reference_json()}, f)
        with open(os.path.join(ROOT, "configs", "train_synth.json")) as f:
            conf = json.load(f)
        conf["train_config"]["log"]["directory"] = os.path.join(tmp, "logs")
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        for max_iters, expect in ((2, "ranks: 1"), (3, "resumed from iter 1")):
            out, secs = _run([sys.executable, "-m", "torch.distributed.run",
                              "--nproc-per-node", "1", "--master-addr", "127.0.0.1",
                              "--master-port", str(_free_port()),
                              "-m", "cleanumamba_tpu_torch.cli.train", "-c", path, "-e", exp,
                              "--synthetic", "--log-every", "1", "--max-iters", str(max_iters)],
                             ROOT)
            if expect not in out:
                raise AssertionError(f"torchrun CLI: {expect!r} not in\n{out[-2000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith(("iter", "resumed", "model"))]
            print(f"  torchrun --nproc-per-node 1 --max-iters {max_iters} ({secs:.1f} s): "
                  + " | ".join(lines))
        ck_dir = os.path.join(tmp, "logs", "e8", "checkpoint")
        last = find_max_epoch(ck_dir)
        if last != 2:
            raise AssertionError(f"expected checkpoint 2.pkl, newest is {last}")
        ck = load_checkpoint(os.path.join(ck_dir, f"{last}.pkl"), "cuda:0")
        with torch.no_grad():
            x = torch.from_numpy((np.random.default_rng(20).normal(size=(1, SR)) * 0.1)
                                 .astype(np.float32)).to("cuda:0")
            y = forward(ck["params"], x, ck["config"])
        _finite("forward from the torchrun CLI's checkpoint", y)


# --------------------------------------------------------------------------
# Phase 21: serving bundles (export.py) with K1 as a custom op
# --------------------------------------------------------------------------

EXPORT_OP = "cleanumamba.selective_scan.default"
EXPORT_STEPS = {1: 4, 16: 2}  # steps of each bundle the loader runs


def export_worker(job_dir) -> int:
    """The loader of phase 21 (``--export-worker DIR``): a fresh process that
    imports ``export.load_bundle`` and no model code, runs every bundle of
    DIR on the card on the inputs the phase saved, counts K1's launches on
    one block-16 step and times that step.  Writes ``loaded.pt``."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.export import load_bundle
    from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    bundles = {name: load_bundle(os.path.join(job_dir, name))[1]
               for name in ("offline", "stream1", "stream16")}
    load_s = time.perf_counter() - t0
    job = torch.load(os.path.join(job_dir, "inputs.pt"))
    p, out = job["params"], {"load_s": load_s}
    out["offline"] = bundles["offline"]["offline"](p, job["x"])
    for block, n in EXPORT_STEPS.items():
        fns, tick = bundles[f"stream{block}"], job["tick"] * block
        state, o = fns["prime"](p, job["audio"][:, :job["fl"]])
        outs = [o]
        for k in range(n):
            pos = job["fl"] + k * tick
            if block == 16 and k == n - 1:
                selective_scan.launches = 0
            state, o = fns["step"](p, state, job["audio"][:, pos:pos + tick])
            outs.append(o)
        out[f"stream{block}"] = torch.cat(outs, 1)
    out["k1_per_step"] = selective_scan.launches
    step, st = bundles["stream16"]["step"], state
    new = job["audio"][:, job["fl"]:job["fl"] + 16 * job["tick"]]
    out["step_ms"] = _median(_host_ms(lambda: step(p, st, new), 30))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step(p, st, new)
        torch.cuda.synchronize()
    out["step_busy_ms"] = _device_busy(prof)[0] / 10
    out["modules"] = sorted(m for m in sys.modules if m.startswith(
        ("cleanumamba_tpu_torch.models", "cleanumamba_tpu_torch.streaming", "jax",
         "cleanumamba_tpu.")))
    torch.save(out, os.path.join(job_dir, "loaded.pt"))
    return 0


def run_export(dev, cfg, params32, smi, keep=None):
    """Phase 21: E8 bundles exported on the card (``export.export_offline``
    at ``valid_length(160000)``, batch 1; ``export_stream`` at batch 2,
    block 16 and block 1), reloaded in a fresh process that imports no model
    code (``--export-worker``): outputs bitwise equal to the eager calls, K1
    launched three times a block-16 step through the custom op;
    ``SessionMultiplexer.from_bundle`` against the live multiplexer on a
    staggered session; export and load seconds, and the loaded step's wall
    and busy ms beside the eager step's and the op's host cost per call.
    (Its CLI check is ``check_export_cli``.)  Returns K1's launches in the
    loader's counted step.  ``keep``: a directory to copy the block-16 bundle
    into (phase 24 serves it)."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch import export as ex
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as k1
    from cleanumamba_tpu_torch.serve import SessionMultiplexer
    from cleanumamba_tpu_torch.streaming import stream_prime, stream_step, stream_step_block

    fl, tick = cfg.frame_length, cfg.total_stride
    L = cfg.valid_length(10 * SR)
    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.normal(size=(1, L)) * 0.1).astype(np.float32)).to(dev)
    audio = torch.from_numpy(
        (rng.normal(size=(2, fl + 4 * 16 * tick)) * 0.1).astype(np.float32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        secs = {}
        t0 = time.perf_counter()
        off = ex.export_offline(params32, cfg, L)
        secs["offline"] = time.perf_counter() - t0
        ex.save_bundle(os.path.join(tmp, "offline"), cfg, {"offline": off})
        graphs = {"offline": off}
        for block in EXPORT_STEPS:
            t0 = time.perf_counter()
            prime, step = ex.export_stream(params32, cfg, batch=2, block=block)
            secs[f"stream{block}"] = time.perf_counter() - t0
            ex.save_bundle(os.path.join(tmp, f"stream{block}"), cfg,
                           {"prime": prime, "step": step})
            graphs[f"step{block}"] = step
        n_op = {k: sum(n.op == "call_function" and str(n.target) == EXPORT_OP
                       for n in g.graph.nodes) for k, g in graphs.items()}
        want = {"offline": cfg.tsfm_n_layers, "step1": 0, "step16": cfg.tsfm_n_layers}
        if n_op != want:
            raise AssertionError(f"{EXPORT_OP} nodes in the traced graphs: {n_op}, want {want}")

        # eager references on the card
        with torch.no_grad():
            ref = {"offline": forward(params32, x, cfg)}
            for block, n in EXPORT_STEPS.items():
                fn = stream_step if block == 1 else stream_step_block
                state, o = stream_prime(params32, cfg, audio[:, :fl])
                outs = [o]
                for k in range(n):
                    pos = fl + k * block * tick
                    state, o = fn(params32, cfg, state, audio[:, pos:pos + block * tick])
                    outs.append(o)
                ref[f"stream{block}"] = torch.cat(outs, 1)
        torch.save({"params": params32, "x": x, "audio": audio, "fl": fl, "tick": tick},
                   os.path.join(tmp, "inputs.pt"))
        out, load_wall = _run([sys.executable, os.path.abspath(__file__), "--export-worker", tmp],
                              ROOT)
        got = torch.load(os.path.join(tmp, "loaded.pt"))
        if got["modules"]:
            raise AssertionError(f"the loader imported model code: {got['modules']}")
        for name, r in ref.items():
            if not torch.equal(got[name].to(dev), r):
                raise AssertionError(f"loaded {name} differs from eager: max|err| "
                                     f"{_rel_err(got[name].to(dev), r)[0]:.3e}")
        if got["k1_per_step"] != cfg.tsfm_n_layers:
            raise AssertionError(f"loaded block-16 step launched K1 {got['k1_per_step']} times, "
                                 f"want {cfg.tsfm_n_layers}")

        # from_bundle against the live multiplexer: a session joining late
        mux_b = SessionMultiplexer.from_bundle(os.path.join(tmp, "stream16"), params32)
        mux_l = SessionMultiplexer(params32, cfg, slots=2, block=16)
        a = audio.cpu().numpy()
        t16 = 16 * tick
        worst, outs = 0.0, []
        for mux in (mux_b, mux_l):
            s0 = mux.open()
            first = mux.feed(s0, a[0, :fl + t16])
            s1 = mux.open()
            second = mux.feed(s1, a[1, :fl + 2 * t16])
            rest = mux.feed(s0, a[0, fl + t16:])
            outs.append([np.concatenate([first, rest, mux._drain(s0)]),
                         np.concatenate([second, mux._drain(s1)])])
        for g, r in zip(*outs):
            if g.shape != r.shape or g.size == 0:
                raise AssertionError(f"from_bundle session: {g.shape} vs live {r.shape}")
            worst = max(worst, _rel_err(torch.from_numpy(g), torch.from_numpy(r))[1])
        if not worst <= FP32_TOL:
            raise AssertionError(f"from_bundle vs live multiplexer: {worst:.3e} > {FP32_TOL:g}")

        # the eager block-16 step's times, and the op's host cost per K1 call
        state, _ = stream_prime(params32, cfg, audio[:, :fl])
        new = audio[:, fl:fl + t16]
        with torch.no_grad():
            eager_ms = _median(_host_ms(lambda: stream_step_block(params32, cfg, state, new), 30))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    stream_step_block(params32, cfg, state, new)
                torch.cuda.synchronize()
        eager_busy = _device_busy(prof)[0] / 10
        a16 = _scan_inputs(torch.Generator().manual_seed(21), dev, 2, 16, cfg.d_inner,
                           cfg.d_state, torch.float32)
        args16 = [a16[k] for k in SCAN_ARGS]
        via_op = _median(_host_ms(lambda: k1.selective_scan(*args16), 200))
        direct = _median(_host_ms(lambda: k1._scan_op_cuda(*args16, False), 200))
        if keep is not None:
            shutil.copytree(os.path.join(tmp, "stream16"), keep)

    print(f"  E8 bundles exported on the card in {secs['offline']:.1f} s (offline, L={L}), "
          f"{secs['stream1']:.1f} s (prime + block-1 step, batch 2), {secs['stream16']:.1f} s "
          f"(prime + block-16 step); {EXPORT_OP} nodes {n_op}; loader process {load_wall:.1f} s "
          f"(load {got['load_s']:.1f} s), no model module imported; offline, prime and "
          f"{EXPORT_STEPS} steps bitwise equal to eager; loaded block-16 step launched K1 "
          f"{got['k1_per_step']} times; from_bundle vs live multiplexer worst rel {worst:.3e}")
    print(f"  block-16 step, batch 2, on {smi}: loaded {got['step_ms']:.3f} ms wall, "
          f"{got['step_busy_ms']:.3f} ms device busy; eager {eager_ms:.3f} ms wall, "
          f"{eager_busy:.3f} ms busy; K1 through the custom op {via_op * 1e3:.1f} us a call "
          f"(host clock, synchronised) against its ctypes launch alone {direct * 1e3:.1f} us "
          f"({(via_op - direct) * 1e3:.1f} us x {cfg.tsfm_n_layers} calls a step)")
    return got["k1_per_step"]


def check_export_cli():
    """``cli/export.py --selftest`` on the pruned checkpoint, on the card and
    with ``--device cpu``, as two subprocesses at once."""
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[sys.executable, "-m", "cleanumamba_tpu_torch.cli.export", "--ckpt", CKPT,
                 "--out", os.path.join(tmp, f"cli_{d}"), "--selftest"] + extra
                for d, extra in (("cuda", []), ("cpu", ["--device", "cpu"]))]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = list(pool.map(lambda c: _run(c, ROOT), cmds))
    for (text, secs), d in zip(runs, ("cuda", "cpu")):
        if "selftest OK" not in text:
            raise AssertionError(f"cli/export.py --selftest on {d}:\n{text[-2000:]}")
        errs = [ln.strip() for ln in text.splitlines() if "max|err|" in ln]
        print(f"  cli/export.py --selftest ({d}, {secs:.1f} s): " + "; ".join(errs))


def check_clis_of_phases_20_22():
    """Phase 20's torchrun CLI, phase 21's export CLIs and phase 22's TP CLI:
    subprocesses that share nothing, run at once."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(check_torchrun_cli), pool.submit(check_export_cli),
                pool.submit(check_tp_cli)]
        for job in jobs:
            job.result()


# --------------------------------------------------------------------------
# Phases 22-23: tensor and sequence parallelism, gloo ranks on the one card
# --------------------------------------------------------------------------

TP_N = 2
TP_L = 2 * SR  # E8 TP at batch 2 x 2 s
TP_STEPS = 3
SP_L = 10 * SR  # one 10 s utterance over two ranks
SP_TOL = dict(atol=3e-4, rtol=2e-3)  # JAX's (tests/test_sequence_parallel.py)
# The TP gradient is held with the squared error as the loss: the STFT loss's
# log magnitudes amplify any change of summation order (tests/test_torch_tp.py)
TP_GRAD_LOSS = dict(ell_p=2, stft_lambda=0.0)


def _small_cfg(**kw):
    """Phase 8's small config."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig

    return CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=3, tsfm_n_layers=2,
                             tsfm_d_model=32, tsfm_n_head=4, tsfm_d_inner=64, **kw)


def _small_params(cfg, dev, L):
    from cleanumamba_tpu_torch.models.cleanumamba import init_params, prepare_for_length

    return prepare_for_length(init_params(cfg, torch.Generator().manual_seed(8), dev), cfg, L)


def _start_ranks(job, world, timeout=900):
    """``world`` processes of this script (``--parallel-worker``) on ``job``,
    each a gloo rank on ``cuda:0``; their outputs in rank order and the wall."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(job, os.path.join(tmp, "job.pt"))
        env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--parallel-worker", tmp], cwd=ROOT,
                                  env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"{job['mode']} rank {r} exited {p.returncode}:\n"
                                     f"{log[-4000:]}")
        wall = time.perf_counter() - t0
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)], wall


def _reset(counters):
    for c in counters:
        c.launches = 0


def _tp_rank(mesh, job, counters):
    """Phase 22 on one rank: the E8 TP forward, fp32 gradient and steps, the
    bf16 steps' times, and the small config's other families' forwards."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.parallel import tensor as tpar

    dev = mesh.device
    cfg = CleanUMambaConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    clean, noisy = job["clean"].to(dev), job["noisy"].to(dev)  # (1, 2, TP_L)
    out = {}
    with torch.no_grad():
        out["y"] = tpar.tp_forward(params, noisy[0], cfg, mesh).cpu()
    params_tp, specs = tpar.tp_prepare(params, cfg, TP_N)
    local = tpar.tp_shard(params_tp, specs, TP_N, mesh.model_rank)
    # the squared error's gradient in fp32, and in bf16 as the control of its
    # limit; the default loss's, printed beside them
    for key, loss, bf16 in (("grads", LossConfig(**TP_GRAD_LOSS), False),
                            ("grads_bf16", LossConfig(**TP_GRAD_LOSS), True),
                            ("grads_default", LossConfig(), False)):
        grads, _ = tpar.make_tp_grad_fn(cfg, loss, mesh, specs, bf16=bf16)(local, clean, noisy)
        full = tpar.tp_unprepare(tpar.tp_gather(mesh, grads, specs), cfg, TP_N)
        out[key] = [g.float().cpu() for g in tensor_leaves(full)]
    make = tpar.make_tp_train_step(cfg, LossConfig(), OptimizationConfig(learning_rate=1e-4),
                                   mesh, bf16=False)
    p, state, step = make(params)
    _reset(counters)  # the launches of the fp32 steps alone
    for _ in range(TP_STEPS):
        p, state, aux = step(p, state, (clean, noisy))
    out["replicated"] = [x.cpu() for x, s in zip(tensor_leaves(p), tpar.spec_leaves(p, specs))
                         if s is None]
    out["sharded_bytes"] = sum(x.numel() * 4 for x, s in zip(tensor_leaves(p),
                                                              tpar.spec_leaves(p, specs))
                               if s is not None)
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["loss"] = float(aux["loss"])

    # bf16 steps: wall, device busy, and the share of the gloo all-reduces
    p, state, step = tpar.make_tp_train_step(cfg, LossConfig(), OptimizationConfig(), mesh,
                                             bf16=True)(params)
    p, state, _ = step(p, state, (clean, noisy))  # warm-up

    def steps():
        nonlocal p, state
        walls = []
        for _ in range(TP_STEPS):
            dist.barrier(mesh.group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, _ = step(p, state, (clean, noisy))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    out["step_ms"] = steps()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps()
    out["busy_ms"], out["kernels"] = _device_busy(prof)
    reduce_ms = []
    plain_all_reduce = dist.all_reduce

    def timed(t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = plain_all_reduce(t, *a, **k)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    dist.all_reduce = timed
    try:
        out["timed_step_ms"] = steps()
    finally:
        dist.all_reduce = plain_all_reduce
    out["reduce_ms"], out["reduces"] = sum(reduce_ms), len(reduce_ms)

    # (c) the small config's other families
    out["small"] = {}
    x = job["small_x"].to(dev)
    for fam in ("mamba2", "mamba_s4", "mha"):
        scfg = _small_cfg(bottleneck=fam)
        with torch.no_grad():
            out["small"][fam] = tpar.tp_forward(_small_params(scfg, dev, x.shape[1]), x, scfg,
                                                mesh).cpu()
    return out


def _dptp_rank(mesh, job):
    """Phase 22 (e) on one of four ranks (data 2 x model 2): the small
    config's fp32 gradient of the rank's data part, averaged over the data
    group, gathered to the canonical layout."""
    from cleanumamba_tpu_torch.config import LossConfig
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.parallel import batch_sharding
    from cleanumamba_tpu_torch.parallel import tensor as tpar

    dev = mesh.device
    cfg = _small_cfg()
    params = _small_params(cfg, dev, job["clean"].shape[-1])
    clean, noisy = (batch_sharding(mesh, job[k].to(dev), 1) for k in ("clean", "noisy"))
    params_tp, specs = tpar.tp_prepare(params, cfg, mesh.model_size)
    local = tpar.tp_shard(params_tp, specs, mesh.model_size, mesh.model_rank)
    grads, _ = tpar.make_tp_grad_fn(cfg, LossConfig(), mesh, specs, bf16=False)(
        local, clean, noisy)
    full = tpar.tp_unprepare(tpar.tp_gather(mesh, grads, specs), cfg, mesh.model_size)
    return {"grads": [g.cpu() for g in tensor_leaves(full)], "data_rank": mesh.data_rank,
            "model_rank": mesh.model_rank}


def _sp_model(case, dev):
    """(cfg, params) of a phase 23 case: E8 widths of a family with seeded
    weights, or the pruned checkpoint."""
    import dataclasses as dc

    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.params import load_checkpoint

    if case.get("ckpt"):
        return load_checkpoint(os.path.join(ROOT, case["ckpt"]), dev)
    cfg = dc.replace(CleanUMambaConfig(), **case["cfg"])
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), dev)


def _sp_rank(mesh, job, counters):
    """Phase 23 on one rank: ``sp_stream_denoise`` of every case, twice (the
    second timed), K1's launches of one call."""
    import torch.distributed as dist

    from cleanumamba_tpu_torch.parallel.sequence import sp_stream_denoise

    out = {}
    for case in job["cases"]:
        cfg, params = _sp_model(case, mesh.device)
        x = job["x"]
        _reset(counters)
        y = sp_stream_denoise(params, cfg, x, mesh)
        launches = counters[0].launches
        dist.barrier(mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp_stream_denoise(params, cfg, x, mesh)
        torch.cuda.synchronize()
        out[case["name"]] = {"y": y.cpu(), "ms": (time.perf_counter() - t0) * 1e3,
                             "launches": launches}
    return out


def parallel_worker(job_dir) -> int:
    """One rank of phases 22 and 23 (``--parallel-worker DIR``, started with
    the process group's environment): a gloo rank on ``cuda:0``.  Writes
    ``rank{r}.pt``."""
    import torch.distributed as dist

    from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan, selective_scan_bwd
    from cleanumamba_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(os.path.join(job_dir, "job.pt"))
    mesh = make_mesh("cuda:0", backend="gloo", model_parallel=job.get("model_parallel", 1))
    counters = (selective_scan, selective_scan_bwd)
    run = {"tp": lambda: _tp_rank(mesh, job, counters), "dptp": lambda: _dptp_rank(mesh, job),
           "sp": lambda: _sp_rank(mesh, job, counters)}[job["mode"]]
    out = {"rank": mesh.rank, **run()}
    torch.save(out, os.path.join(job_dir, f"rank{mesh.rank}.pt"))
    dist.barrier(mesh.group)
    dist.destroy_process_group()
    return 0


def run_tp(dev, cfg, params32, smi, rep):
    """Phase 22: tensor parallelism, two gloo ranks on ``cuda:0``.  (a) K1 and
    K2 against their plain versions at a rank's shard shape, and their
    device times there; (b) E8 mamba TP=2 at batch 2 x 2 s against one
    process: the forward (1e-4 of max|ref|), the squared error's fp32
    gradient gathered to the canonical layout (max(GRAD_TOL, twice one
    process's CPU-vs-card spread) of each leaf, capped at KD_TOL_CAP, with the
    bf16 TP gradient required above the cap), the ranks' replicated leaves
    bitwise equal after three fp32 steps, K1/K2 counted on those steps; (c) mamba2,
    mamba_s4 and mha at phase 8's small config: the TP forward against one
    process; (d) three bf16 E8 TP steps: wall, device busy a rank, the gloo
    all-reduces' share; (e) DP x TP = 2 x 2, four ranks, the small config's
    gradient against one process.  (The CLI check is ``check_tp_cli``.)
    Returns K1's and K2's launches on both ranks' three fp32 E8 TP steps."""
    from cleanumamba_tpu_torch.config import LossConfig
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as kscan
    from cleanumamba_tpu_torch.params import tensor_leaves, to_device
    from cleanumamba_tpu_torch.train.trainer import make_grad_fn

    Bsz, L, Di, Ds = _scan_shape(cfg, 2, TP_L)
    shard = (Bsz, L, Di // TP_N, Ds)
    check_scan(dev, rep, [(*shard, True), (*shard, False)])
    check_scan_bwd(dev, rep, [(*shard, True)])
    a = _scan_inputs(torch.Generator().manual_seed(22), dev, *shard, torch.bfloat16)
    fwd = {k: a[k] for k in SCAN_ARGS}
    outs = kscan.selective_scan(**fwd, return_starts=True)
    tr1 = _trace_scan(lambda: kscan.selective_scan(**fwd, return_starts=True))
    b1 = _scan_bounds(shard, (*fwd.values(), *outs), bwd=False)
    bwd = (*(a[k] for k in SCAN_ARGS[:6]), outs[2], a["gy"], a["gh_last"])
    grads = kscan.selective_scan_bwd(*bwd)
    tr2 = _trace_scan(lambda: kscan.selective_scan_bwd(*bwd))
    b2 = _scan_bounds(shard, (*bwd, *grads), bwd=True)
    plain1 = _time_ms(lambda: kscan.selective_scan_plain(**fwd), iters=5, warmup=1)
    plain2 = _time_ms(lambda: kscan.selective_scan_bwd_plain(*bwd), iters=5, warmup=1)
    us = lambda tr: sum(n * u for n, u in tr.values())  # noqa: E731
    print(f"  K1/K2 at a rank's shard {shard} vs plain (fp32, bf16, repeated call bitwise): "
          f"passed; bf16 device us a launch from a trace on {smi}: K1 with chunk states "
          f"{us(tr1):.2f} (bound {b1[0] * 1e3:.2f}, {b1[1]}), K2 all launches {us(tr2):.2f} "
          f"(bound {b2[0] * 1e3:.2f}, {b2[1]}); the plain versions (CUDA events, 5 calls) "
          f"{plain1:.3f} ms and {plain2:.3f} ms", flush=True)

    clean, noisy = synth_batch(torch.Generator(device=dev).manual_seed(22), 2, TP_L)
    clean, noisy = clean.reshape(1, 2, TP_L), noisy.reshape(1, 2, TP_L)
    small_x = synth_batch(torch.Generator(device=dev).manual_seed(23), 2, 4096)[1]
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ranks, wall = _start_ranks({"mode": "tp", "model_parallel": TP_N, "clean": clean.cpu(),
                                "noisy": noisy.cpu(), "small_x": small_x.cpu()}, TP_N)
    r0, r1 = ranks
    with torch.no_grad():
        ref = forward(params32, noisy[0], cfg)
    y_rel = _rel_err(r0["y"], ref.cpu())[1]
    # the gradient against one process on the card, beside one process on the
    # CPU against the card (the same arithmetic in another summation order)
    sq = LossConfig(**TP_GRAD_LOSS)
    card = tensor_leaves(make_grad_fn(cfg, sq, bf16=False)(params32, clean, noisy)[0])
    cpu = tensor_leaves(make_grad_fn(cfg, sq, bf16=False)(
        to_device(params32, "cpu"), clean.cpu(), noisy.cpu())[0])
    g_res, spread = _leafwise(r0["grads"], card), _leafwise(cpu, card)
    bf16_err = _leafwise(r0["grads_bf16"], card)["above"]
    d_res = _leafwise(r0["grads_default"], tensor_leaves(
        make_grad_fn(cfg, LossConfig(), bf16=False)(params32, clean, noisy)[0]))
    print(f"  squared-error loss: one process, CPU vs card {spread['above'][0]:.3e} "
          f"({spread['above'][1]}; below the floor {spread['below'][0]:.3e}); the default "
          f"loss: TP vs one process {d_res['above'][0]:.3e} ({d_res['above'][1]}; below "
          f"{d_res['below'][0]:.3e}), not checked", flush=True)
    # at E8 one process moves more than GRAD_TOL between the CPU and the card:
    # hold TP, as phase 19 holds KD, to max(GRAD_TOL, twice that spread), capped;
    # the bf16 TP gradient must lie above the cap, so that the limit tells
    # bf16 arithmetic (or a gradient reduced wrongly) from fp32
    tols = {side: min(max(GRAD_TOL, 2 * spread[side][0]), cap)
            for side, cap in (("above", KD_TOL_CAP), ("below", KD_TOL_CAP_BELOW))}
    failures = []
    if not bf16_err[0] > KD_TOL_CAP:
        failures.append(f"TP gradient: the bf16 gradient is within the cap {KD_TOL_CAP:g} "
                        f"({bf16_err[0]:.3e}), so the cap cannot tell bf16 from fp32")
    if not y_rel <= FP32_TOL:
        failures.append(f"TP forward: relative error {y_rel:.3e} > {FP32_TOL:g}")
    for side, tol in tols.items():
        if not g_res[side][0] <= tol:
            failures.append(f"TP gradient: {g_res[side][1]} off by {g_res[side][0]:.3e} "
                            f"(tol {tol:.3e}, {side} the floor)")
    if not all(torch.equal(x, y) for x, y in zip(r0["replicated"], r1["replicated"])):
        raise AssertionError("the ranks' replicated leaves differ after the TP steps")
    for r in ranks:
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched on a TP rank's steps")
    print(f"  E8 TP={TP_N}, 2 gloo ranks on one card, fp32 batch 2 x 2 s ({wall:.1f} s with "
          f"start-up) vs one process: forward {y_rel:.3e} of max|ref| (tol {FP32_TOL:g}); "
          f"squared-error gradient worst {g_res['above'][0]:.3e} of its leaf's max (tol "
          f"{tols['above']:.3e}; below the floor {g_res['below'][0]:.3e}, tol "
          f"{tols['below']:.3e}); the bf16 TP gradient (control, must exceed "
          f"{KD_TOL_CAP:g}): {bf16_err[0]:.3e} ({bf16_err[1]}); "
          f"{len(r0['replicated'])} replicated leaves "
          f"bitwise equal after {TP_STEPS} steps; sharded params a rank "
          f"{r0['sharded_bytes'] / 2**20:.1f} MiB; launches per rank on the {TP_STEPS} fp32 "
          f"steps {r0['launches']}",
          flush=True)
    for fam, y in r0["small"].items():
        scfg = _small_cfg(bottleneck=fam)
        with torch.no_grad():
            ref = forward(_small_params(scfg, dev, small_x.shape[1]), small_x, scfg)
        rel = _rel_err(y, ref.cpu())[1]
        if not rel <= FP32_TOL:
            raise AssertionError(f"TP forward {fam}: relative error {rel:.3e} > {FP32_TOL:g}")
        print(f"  small config {fam}: TP forward vs one process {rel:.3e} of max|ref|")
    for r in ranks:
        print(f"  rank {r['rank']} bf16 E8 TP step on {smi}: wall "
              f"{' '.join(f'{t:.1f}' for t in r['step_ms'])} ms; traced busy "
              f"{r['busy_ms'] / TP_STEPS:.2f} ms a step ({r['kernels'] // TP_STEPS} kernels); "
              f"with each all-reduce synced: {r['reduces'] // TP_STEPS} all-reduces a step, "
              f"{r['reduce_ms'] / sum(r['timed_step_ms']):.3f} of the step "
              f"({' '.join(f'{t:.1f}' for t in r['timed_step_ms'])} ms)")

    # (e) DP x TP: four ranks, the small config
    sc, sn = synth_batch(torch.Generator(device=dev).manual_seed(24), 4, 4096)
    ranks, wall = _start_ranks({"mode": "dptp", "model_parallel": 2,
                                "clean": sc.reshape(1, 4, -1).cpu(),
                                "noisy": sn.reshape(1, 4, -1).cpu()}, 4)
    scfg = _small_cfg()
    g_ref, _ = make_grad_fn(scfg, LossConfig(), bf16=False)(
        _small_params(scfg, dev, 4096), sc.reshape(2, 2, -1), sn.reshape(2, 2, -1))
    for r in ranks:
        d_res = _check_leafwise(f"DP x TP gradient, rank {r['rank']}", r["grads"],
                                tensor_leaves(g_ref))
    if failures:
        raise AssertionError("; ".join(failures))
    print(f"  DP x TP = 2 x 2, 4 gloo ranks on one card ({wall:.1f} s with start-up), small "
          f"config fp32 batch 4 x 4096: gradient vs one process (2 micro-batches) worst "
          f"{d_res['above'][0]:.3e} of its leaf's max (tol {GRAD_TOL:g}), every rank")
    return {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}


def check_tp_cli():
    """Phase 22 (f): ``cli/train.py --model-parallel 2`` under ``torchrun
    --nproc-per-node 2`` with ``--device cpu`` (NCCL, which ``make_mesh``
    gives a CUDA rank, refuses two ranks on one card), phase 8's small
    config: 2 iterations, then resumed to 3; the banked checkpoint's
    forward on the card."""
    from cleanumamba_tpu_torch.models.cleanumamba import forward
    from cleanumamba_tpu_torch.train.checkpoint import find_max_epoch, load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "exp.json")
        with open(exp, "w") as f:
            json.dump({"network": "CleanUMamba", "exp_path": "tp",
                       "network_config": _small_cfg().to_reference_json()}, f)
        with open(os.path.join(ROOT, "configs", "train_synth.json")) as f:
            conf = json.load(f)
        conf["train_config"]["log"] = {"directory": os.path.join(tmp, "logs"),
                                       "ckpt_iter": "max", "iters_per_ckpt": 2,
                                       "iters_per_valid": 1000}
        conf["trainset_config"] = {"crop_length_sec": 0.25}
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        for max_iters, expect in ((2, "tensor parallel: weights over 2 ranks"),
                                  (3, "resumed from iter 1")):
            out, secs = _run([sys.executable, "-m", "torch.distributed.run",
                              "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
                              "--master-port", str(_free_port()),
                              "-m", "cleanumamba_tpu_torch.cli.train", "-c", path, "-e", exp,
                              "--synthetic", "--log-every", "1", "--device", "cpu",
                              "--model-parallel", "2", "--max-iters", str(max_iters)], ROOT)
            if expect not in out:
                raise AssertionError(f"TP CLI: {expect!r} not in\n{out[-2000:]}")
            lines = [ln for ln in out.splitlines()
                     if ln.startswith(("iter", "resumed", "tensor"))]
            print(f"  torchrun --nproc-per-node 2 --model-parallel 2 --device cpu --max-iters "
                  f"{max_iters} ({secs:.1f} s): " + " | ".join(lines))
        ck_dir = os.path.join(tmp, "logs", "tp", "checkpoint")
        if find_max_epoch(ck_dir) != 2:
            raise AssertionError(f"expected checkpoint 2.pkl, newest is {find_max_epoch(ck_dir)}")
        ck = load_checkpoint(os.path.join(ck_dir, "2.pkl"), "cuda:0")
        if ck["opt_state"]["count"] != 3:
            raise AssertionError(f"resumed count {ck['opt_state']['count']}, expected 3")
        with torch.no_grad():
            x = torch.from_numpy((np.random.default_rng(22).normal(size=(1, SR)) * 0.1)
                                 .astype(np.float32)).to("cuda:0")
            _finite("forward from the TP CLI's canonical checkpoint", forward(
                ck["params"], x, ck["config"]))


SP_CASES = (
    {"name": "E8 mamba normalized", "cfg": {}},
    {"name": "E8 mamba", "cfg": {"normalize_input": False}},
    {"name": "E8 mamba2 normalized", "cfg": {"bottleneck": "mamba2"}},
    {"name": "E8 mamba_s4 normalized", "cfg": {"bottleneck": "mamba_s4"}},
    {"name": "pruned 473k checkpoint", "ckpt": CKPT},
)


def _zero_primed(params, cfg, x, n, dev, eager=False):
    """Zero-primed streaming on one device of x (B, L) as ``n`` ranks pad it:
    ``Streamer`` over ``[zeros(ctx) | x | pad]`` and its flush, sliced back
    to x; the wall it took; and the graphs the ``Streamer`` captured (its
    graphs off with ``eager``)."""
    from cleanumamba_tpu_torch.parallel.sequence import _WARM
    from cleanumamba_tpu_torch.streaming import Streamer

    ts, fl = cfg.total_stride, cfg.frame_length
    ctx = fl + (_WARM - 1) * ts
    B, L = x.shape
    total = -(-(L + fl - ts) // (n * ts)) * (n * ts)
    padded = np.concatenate([np.zeros((B, ctx), np.float32), x,
                             np.zeros((B, total - L), np.float32)], axis=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = Streamer(params, cfg, dev, batch=B)
    if eager:
        s._graphs = None
    y = np.concatenate([s.feed(padded), s.flush()], axis=1)[:, ctx: ctx + L]
    return torch.from_numpy(y), (time.perf_counter() - t0) * 1e3, len(s._graphs or ())


def _close(name, got, ref, tol=SP_TOL):
    err = (got.float() - ref.float()).abs()
    bad = (err > tol["atol"] + tol["rtol"] * ref.float().abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} samples outside atol {tol['atol']:g} + rtol "
                             f"{tol['rtol']:g}; max|err| {err.max().item():.3e}")
    return err.max().item()


def run_sp(dev, smi, rep):
    """Phase 23: sequence parallelism, two gloo ranks on ``cuda:0``.  (a) K1
    against its plain version at a segment's shapes (E8, 10 s over two
    ranks: its tokens, and the 3 warm tokens); (b)-(c) E8 mamba (normalised
    and not), mamba2 and mamba_s4 at E8 widths (seed 0) and the pruned
    checkpoint, on 10 s of ``synth_batch`` audio: the two ranks' output
    against zero-primed streaming on the card and against
    ``sp_stream_denoise(mesh=None)`` on the card (JAX's atol 3e-4, rtol
    2e-3); (d) K1 counted, the wall of a call beside streaming's.  Returns
    K1's launches on both ranks' calls."""
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.parallel.sequence import _WARM, sp_stream_denoise

    x = synth_batch(torch.Generator(device=dev).manual_seed(23), 1, SP_L)[1].cpu().numpy()
    models = {c["name"]: _sp_model(c, dev) for c in SP_CASES}
    cfg = models["E8 mamba"][0]
    ts, fl = cfg.total_stride, cfg.frame_length
    seg = -(-(SP_L + fl - ts) // (2 * ts))  # tokens of a rank's segment
    check_scan(dev, rep, [(1, seg, cfg.tsfm_d_inner, cfg.d_state, True),
                          (1, seg, cfg.tsfm_d_inner, cfg.d_state, False),
                          (1, _WARM, cfg.tsfm_d_inner, cfg.d_state, False)])
    print(f"  K1 at a segment's (1, {seg}, {cfg.tsfm_d_inner}, {cfg.d_state}) and the warm "
          f"tokens' (1, {_WARM}, ...) vs plain (fp32, bf16, repeated call bitwise): passed",
          flush=True)
    torch.cuda.empty_cache()
    ranks, wall = _start_ranks({"mode": "sp", "cases": SP_CASES, "x": torch.from_numpy(x)}, 2)
    r0, r1 = ranks
    launches = 0
    for name, (mcfg, params) in models.items():
        got = r0[name]["y"]
        if not torch.equal(got, r1[name]["y"]):
            raise AssertionError(f"SP {name}: the ranks' outputs differ")
        ref, stream_ms, _ = _zero_primed(params, mcfg, x, 2, dev)
        e_stream = _close(f"SP {name} vs zero-primed streaming", got, ref)
        one = sp_stream_denoise(params, mcfg, x, device=dev).cpu()
        e_one = _close(f"SP {name} vs one segment", got, one)
        n = [r[name]["launches"] for r in ranks]
        if mcfg.bottleneck in ("mamba", "mamba2") and min(n) <= 0:
            raise AssertionError(f"SP {name}: K1 was not launched on a rank: {n}")
        launches += sum(n)
        print(f"  {name}, 10 s over 2 gloo ranks on {smi}: max|err| vs zero-primed streaming "
              f"{e_stream:.3e}, vs one segment {e_one:.3e}; K1 launches a call per rank {n}; "
              f"wall a call {r0[name]['ms']:.1f} / {r1[name]['ms']:.1f} ms (ranks) vs "
              f"streaming {stream_ms:.1f} ms", flush=True)
    print(f"  phase 23 ranks: {wall:.1f} s with start-up")
    return launches


# --------------------------------------------------------------------------
# Phase 24: the one-dispatch steps (CUDA graphs) against their eager bodies
# --------------------------------------------------------------------------

def _window(prof, span):
    """(device-busy ms, kernels, graph launches) of a trace inside the
    ``record_function`` span named ``span``: the CUDA events that start in
    it (the span ends with a synchronise) and the ``cudaGraphLaunch`` calls."""
    events = prof.events()
    w = next(e for e in events
             if e.name == span and e.device_type != torch.autograd.DeviceType.CUDA)
    lo, hi = w.time_range.start, w.time_range.end
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != span and lo <= e.time_range.start <= hi)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    launches = sum(1 for e in events if e.name == "cudaGraphLaunch"
                   and lo <= e.time_range.start <= hi)
    return busy / 1e3, len(spans), launches


def _pool_mb(pool) -> float:
    """MiB of the device memory segments of one graph pool."""
    segs = [s for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == tuple(pool)]
    if not segs:
        raise AssertionError(f"graph pool {pool}: no segment in the memory snapshot")
    return sum(s["total_size"] for s in segs) / 2 ** 20


def _leaf_diffs(got, ref):
    """[(leaf index, max|diff|, that over max|ref|)] of the leaves that differ."""
    from cleanumamba_tpu_torch.params import tensor_leaves

    out = []
    for i, (a, b) in enumerate(zip(tensor_leaves(got), tensor_leaves(ref))):
        if not torch.equal(a, b):
            out.append((i, *_rel_err(a, b)))
    return out


class _GraphCheck:
    """Per path: the graph's and the eager body's outputs held bit for bit
    (a difference is printed, by leaf, and held to the path's tolerance),
    wall per step of both, and a trace of each."""

    def __init__(self, smi):
        self.smi = smi
        self.rows = []

    def same(self, name, got, ref, tol):
        if isinstance(got, np.ndarray):
            got, ref = torch.from_numpy(got), torch.from_numpy(ref)
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: graph {tuple(got.shape)} vs eager {tuple(ref.shape)}")
        if torch.equal(got, ref):
            return 0.0
        err, rel = _rel_err(got, ref)
        print(f"  {name}: graph differs from eager, max|diff| {err:.3e} (rel {rel:.3e}, "
              f"tol {tol:g})")
        if not rel <= tol:
            raise AssertionError(f"{name}: graph vs eager rel {rel:.3e} > {tol:g}")
        return err

    def state(self, name, got, ref, tol):
        diffs = _leaf_diffs(got, ref)
        if diffs:
            print(f"  {name}: state leaves that differ (index, max|diff|, rel): "
                  + ", ".join(f"{i} {e:.2e} {r:.2e}" for i, e, r in diffs[:8]))
            worst = max(r for _, _, r in diffs)
            if not worst <= tol:
                raise AssertionError(f"{name}: graph state vs eager rel {worst:.3e} > {tol:g}")
        return max([e for _, e, _ in diffs], default=0.0)

    def measure(self, name, steps, graph_step, eager_step, pool, per_step=1):
        """Wall (host clock, each step synchronised) of ``steps`` calls of each,
        in turns; then a trace of each: device busy, kernels and graph
        launches a step, idle share.  ``per_step``: steps a call makes."""
        from torch.profiler import ProfilerActivity, profile, record_function

        walls = {"graph": [], "eager": []}
        for _ in range(steps):
            for kind, fn in (("graph", graph_step), ("eager", eager_step)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[kind].append((time.perf_counter() - t0) * 1e3 / per_step)
        traced = {}
        for kind, fn in (("graph", graph_step), ("eager", eager_step)):
            # a trace may drop the records of its first launches: three calls
            # first, then the calls counted, inside a span
            n = max(3, steps // 2)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with record_function("counted"):
                    t0 = time.perf_counter()
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
            busy, kernels, launches = _window(prof, "counted")
            traced[kind] = (busy / n / per_step, kernels / n / per_step, launches / n,
                            1 - busy / wall)
        if traced["graph"][2] != 1:
            raise AssertionError(f"{name}: {traced['graph'][2]:.2f} graph launches a call, want 1")
        stats = {k: (_median(v), sorted(v)[int(len(v) * 0.9)]) for k, v in walls.items()}
        mb = _pool_mb(pool)
        print(f"  {name} on {self.smi}: wall ms a step median/p90 graph "
              f"{stats['graph'][0]:.3f}/{stats['graph'][1]:.3f}, eager "
              f"{stats['eager'][0]:.3f}/{stats['eager'][1]:.3f}; traced: device busy ms a step "
              f"graph {traced['graph'][0]:.4f}, eager {traced['eager'][0]:.4f}; kernels a step "
              f"graph {traced['graph'][1]:.1f}, eager {traced['eager'][1]:.1f}; graph launches a "
              f"call {traced['graph'][2]:.2f}; idle share graph {traced['graph'][3]:.3f}, eager "
              f"{traced['eager'][3]:.3f}; graph pool {mb:.1f} MiB", flush=True)
        self.rows.append((name, stats, traced, mb))


def _graphed_and_eager(make):
    """Two objects from ``make()``: one that replays graphs, one that runs
    the same bodies eagerly on the card."""
    graphed, eager = make(), make()
    eager._graphs = None
    return graphed, eager


def _counts_now(counters):
    return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}


def _leaf_paths(tree, prefix=""):
    """The '/'-joined path of every tensor leaf, in ``tensor_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix] if isinstance(tree, torch.Tensor) else []


@contextlib.contextmanager
def _deterministic(on=True):
    """torch's deterministic algorithms, warning only where an op has none."""
    import warnings

    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def _eager_device_steps(step, B, L, K, params, opt_state, gen):
    """The body of ``make_device_data_steps`` (one process, accum 1), run eagerly."""
    from cleanumamba_tpu_torch.data.synth_device import synth_batch

    for _ in range(K):
        clean, noisy = synth_batch(gen, B, L)
        params, opt_state, aux = step(params, opt_state,
                                      (clean.reshape(1, B, L), noisy.reshape(1, B, L)))
    return params, opt_state, aux


def run_graphs(dev, cfg, params32, smi, bundle=None):
    """Phase 24: every captured path against its eager body on the card.
    ``bundle``: phase 21's E8 block-16 bundle at batch 2 (None: exported
    here).  Returns the printed rows."""
    from cleanumamba_tpu_torch import export as ex
    from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.graphs import launch_counters, own
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.serve import SessionMultiplexer
    from cleanumamba_tpu_torch.streaming import Streamer
    from cleanumamba_tpu_torch.train.optim import make_optimizer
    from cleanumamba_tpu_torch.train.trainer import (
        graph_train_step,
        make_device_data_steps,
        make_grad_fn,
        make_train_step,
    )

    t_phase = time.perf_counter()
    chk = _GraphCheck(smi)
    counters = launch_counters()
    fl, ts = cfg.frame_length, cfg.total_stride
    rng = np.random.default_rng(24)

    # Streamer: E8 bf16 (block 16 and block 1 through the K3/K4 packs), E8
    # int8 block 1, FullMini mega (K5) for mamba and mha
    fm = {f: _fullmini(f) for f in ("mamba", "mha")}
    cases = [("E8 bf16 Streamer block 16", cfg, params32, dict(dtype=torch.bfloat16,
                                                              weights="bf16"), 16, BF16_TOL),
             ("E8 bf16 Streamer block 1 (K3/K4)", cfg, params32,
              dict(dtype=torch.bfloat16, weights="bf16"), 1, BF16_TOL),
             ("E8 int8 Streamer block 1 (int8 K3/K4)", cfg, params32,
              dict(weights="int8", fused=True), 1, BF16_TOL)]
    cases += [(f"FullMini {f} Streamer block 1 (K5)", c,
               init_params(c, torch.Generator().manual_seed(0), dev), {}, 1, FP32_TOL)
              for f, c in fm.items()]
    for name, c, p, kw, block, tol in cases:
        n = 30 if block == 1 else 12
        hop = block * c.total_stride
        audio = (rng.normal(size=(1, c.frame_length + (3 * n + 2) * hop)) * 0.1
                 ).astype(np.float32)
        g, e = _graphed_and_eager(lambda: Streamer(p, c, dev, **kw))
        want_mode = "mega" if c is not cfg else "fused"
        if g.fused_mode != want_mode:
            raise AssertionError(f"{name}: mode {g.fused_mode!r}, want {want_mode!r}")
        pos = {"graph": 0, "eager": 0}

        def feeder(s, kind, width):
            def feed():
                lo = pos[kind]
                pos[kind] += width
                return s.feed(audio[:, lo:lo + width])
            return feed

        # prime and the first step (eager in both: a shape is captured at its
        # second call) outside the comparison's counts, which hold the capture
        for s, kind in ((g, "graph"), (e, "eager")):
            feeder(s, kind, c.frame_length + hop)()
        if len(g._graphs):
            raise AssertionError(f"{name}: {len(g._graphs)} graphs captured at a shape's "
                                 "first call")
        before = _counts_now(counters)
        outs = [feeder(g, "graph", hop)() for _ in range(n)]
        mid = _counts_now(counters)
        refs = [feeder(e, "eager", hop)() for _ in range(n)]
        after = _counts_now(counters)
        moved_g = {k: mid[k] - before[k] for k in before}
        moved_e = {k: after[k] - mid[k] for k in mid}
        if moved_g != moved_e:
            raise AssertionError(f"{name}: launches counted over {n} graph steps {moved_g}, "
                                 f"eager {moved_e}")
        err = chk.same(name, np.concatenate(outs, 1), np.concatenate(refs, 1), tol)
        err = max(err, chk.state(name, g.state, e.state, tol))
        chk.measure(name, n, feeder(g, "graph", hop), feeder(e, "eager", hop), g._graphs.pool)
        print(f"  {name}: graph == eager over {n} steps (max|diff| {err:.3e}); launches "
              f"counted a step {({k: v / n for k, v in moved_g.items() if v})}")
        del g, e

    # SessionMultiplexer: E8 bf16 at slots {1, 8} x block {1, 16}, and from_bundle
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if bundle is None:
            bundle = os.path.join(tmp, "b16")
            prime_b, step_b = ex.export_stream(params32, cfg, batch=2, block=16)
            ex.save_bundle(bundle, cfg, {"prime": prime_b, "step": step_b})
        export_s = time.perf_counter() - t0
        muxes = [(f"multiplexer E8 bf16 slots {sl} block {bl}",
                  lambda sl=sl, bl=bl: SessionMultiplexer(params32, cfg, slots=sl, block=bl,
                                                          dtype=torch.bfloat16, weights="bf16",
                                                          device=dev),
                  sl, bl, BF16_TOL) for sl in (1, 8) for bl in (1, 16)]
        muxes.append(("multiplexer from_bundle (E8 fp32 slots 2 block 16)",
                      lambda: SessionMultiplexer.from_bundle(bundle, params32),
                      2, 16, FP32_TOL))
        for name, make, slots, block, tol in muxes:
            g, e = _graphed_and_eager(make)
            tick = g.tick_samples
            n = 12 if block == 1 else 6
            x = (rng.normal(size=(slots, fl + (3 * n + 4) * tick)) * 0.1).astype(np.float32)
            pos = {"graph": [0] * slots, "eager": [0] * slots}

            def ticker(mux, kind, starve=None):
                """One tick of every session but ``starve``: their samples are
                buffered, and the last one's feed runs the tick."""
                live = [sid for sid in range(slots) if sid != starve]

                def tick_all():
                    for sid in live:
                        lo = pos[kind][sid]
                        pos[kind][sid] += tick
                        chunk = x[sid, lo:lo + tick]
                        if sid != live[-1]:
                            mux._buf[sid] = np.concatenate([mux._buf[sid], chunk])
                            mux._fed[sid] += tick
                        else:
                            before = mux.ticks
                            mux.feed(sid, chunk)
                            if mux.ticks != before + 1:
                                raise AssertionError(f"{name}: {mux.ticks - before} ticks")
                    return [mux._drain(sid) for sid in live]
                return tick_all

            for mux, kind in ((g, "graph"), (e, "eager")):
                for sid in [mux.open() for _ in range(slots)]:
                    mux.feed(sid, x[sid, :fl + tick])
                    pos[kind][sid] = fl + tick
            # one session starved for two ticks (paused), then every one live
            starve = slots - 1 if slots > 1 else None
            outs = [ticker(g, "graph", starve)() for _ in range(2)]
            refs = [ticker(e, "eager", starve)() for _ in range(2)]
            outs += [ticker(g, "graph")() for _ in range(n)]
            refs += [ticker(e, "eager")() for _ in range(n)]
            flat = lambda rows: np.concatenate([np.concatenate(r) for r in rows if r])  # noqa
            err = chk.same(name, flat(outs), flat(refs), tol)
            err = max(err, chk.state(name, g.pool, e.pool, tol))
            chk.measure(name, n, ticker(g, "graph"), ticker(e, "eager"), g._graphs.pool)
            paused = ", a session paused for 2" if slots > 1 else ""
            exported = (f"; bundle exported or reused in {export_s:.1f} s"
                        if "bundle" in name else "")
            print(f"  {name}: graph == eager over {n + 2} ticks{paused} (max|diff| "
                  f"{err:.3e}){exported}")
            del g, e

    # train step and make_device_data_steps: E8 bf16, batch 2 x 10 s, Adam
    # (lr 1e-4 after the warm-up cosine's first steps)
    opt_cfg = OptimizationConfig()
    optimizer = make_optimizer(opt_cfg)
    step = make_train_step(cfg, LossConfig(), optimizer, bf16=True)
    B, L = 2, 10 * SR
    gen = torch.Generator(device=dev).manual_seed(24)
    batches = [tuple(t.reshape(1, B, L) for t in synth_batch(gen, B, L)) for _ in range(6)]
    grad_fn = make_grad_fn(cfg, LossConfig(), bf16=True)
    names = _leaf_paths(params32)
    for det in (False, True):
        with _deterministic(det):
            g1, _ = grad_fn(params32, *batches[0])
            g2, _ = grad_fn(params32, *batches[0])
        diffs = [(n, *_rel_err(x, y)) for n, x, y in
                 zip(names, tensor_leaves(g1), tensor_leaves(g2)) if not torch.equal(x, y)]
        print(f"  E8 bf16 gradient, eager against itself ({'torch deterministic algorithms' if det else 'default algorithms'}): "
              f"{len(diffs)} of {len(names)} leaves differ"
              + (": " + ", ".join(f"{n} rel {r:.1e}" for n, _, r in diffs[:6]) if diffs else ""),
              flush=True)
    del g1, g2

    def hold_train(name, got, ref, n_steps):
        """aux to the bf16 bound; the params to 2 lr a step (Adam's update is
        ~lr sign(g): a gradient near zero may flip it, as the CPU tests hold
        a step); the moments to the bf16 bound of each leaf's max."""
        (pg, sg, aux_g), (pe, se, aux_e) = got, ref
        err = max(chk.same(f"{name} aux {k}", aux_g[k].float().reshape(1),
                           aux_e[k].float().reshape(1), BF16_TOL) for k in aux_e)
        moved = [e for _, e, _ in (_leaf_diffs(pg, pe))]
        if moved and max(moved) > 2 * opt_cfg.learning_rate * n_steps:
            raise AssertionError(f"{name}: params moved {max(moved):.3e} from eager's, more "
                                 f"than 2 lr a step")
        if moved:
            print(f"  {name}: {len(moved)} param leaves differ, max|diff| {max(moved):.3e}")
        return max([err, chk.state(f"{name} opt state", sg, se, BF16_TOL)] + moved)

    # graph against eager, with torch's deterministic algorithms (warn only:
    # cuBLAS's workspace setting is fixed once a process has used it)
    with _deterministic(True):
        graphed = graph_train_step(step, dev)
        pg, sg = own(params32), optimizer.init(params32)
        pe, se = own(params32), optimizer.init(params32)
        err = 0.0
        for i in range(3):
            pg, sg, aux_g = graphed(pg, sg, batches[i])
            pe, se, aux_e = step(pe, se, batches[i])
            err = max(err, hold_train(f"train step {i}", (pg, sg, aux_g), (pe, se, aux_e), i + 1))
        print(f"  E8 bf16 train step, deterministic algorithms: graph against eager over 3 "
              f"steps (params, opt state, aux) max|diff| {err:.3e}", flush=True)
        stepper = make_device_data_steps(step, B, L, 4)
        gen_g = torch.Generator(device=dev).manual_seed(7)
        gen_e = torch.Generator(device=dev).manual_seed(7)
        pg, sg = own(params32), optimizer.init(params32)
        pe, se = own(params32), optimizer.init(params32)
        pg, sg, _ = stepper(pg, sg, gen_g)  # eager: the capture is at the second call
        pe, se, _ = _eager_device_steps(step, B, L, 4, pe, se, gen_e)
        if len(stepper.graphs):
            raise AssertionError("make_device_data_steps: a graph captured at the first call")
        t0 = time.perf_counter()
        got = stepper(pg, sg, gen_g)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        err = hold_train("make_device_data_steps K=4", got,
                         _eager_device_steps(step, B, L, 4, pe, se, gen_e), 8)
        if not torch.equal(gen_g.get_state(), gen_e.get_state()):
            raise AssertionError("device-data steps: the graph advanced its generator otherwise "
                                 "than the eager steps")
        print(f"  make_device_data_steps K=4, deterministic algorithms: graph against eager "
              f"(params, opt state, aux; the generator's state equal) max|diff| {err:.3e}; second "
              f"call (3 warm-up calls and the capture) {capture_s:.1f} s", flush=True)
    del graphed, stepper, got, pg, sg, pe, se, aux_g, aux_e
    torch.cuda.empty_cache()

    # times, with the default algorithms (what cli/train.py runs)
    graphed = graph_train_step(step, dev)
    state = {"graph": [own(params32), optimizer.init(params32)],
             "eager": [own(params32), optimizer.init(params32)]}
    turn = {"graph": 0, "eager": 0}

    def train_turn(kind, fn):
        def run():
            st = state[kind]
            st[0], st[1], _ = fn(st[0], st[1], batches[turn[kind] % 6])
            turn[kind] += 1
        return run

    for _ in range(2):  # eager, then the capture
        train_turn("graph", graphed)()
    chk.measure("E8 bf16 train step, batch 2 x 10 s", 4, train_turn("graph", graphed),
                train_turn("eager", step), graphed.graphs.pool)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    del graphed, state
    torch.cuda.empty_cache()

    K = 4
    stepper = make_device_data_steps(step, B, L, K)
    gens = {k: torch.Generator(device=dev).manual_seed(7) for k in ("graph", "eager")}
    state = {k: [own(params32), optimizer.init(params32)] for k in ("graph", "eager")}

    def device_turn(kind):
        def run():
            st = state[kind]
            if kind == "graph":
                st[0], st[1], _ = stepper(st[0], st[1], gens[kind])
            else:
                st[0], st[1], _ = _eager_device_steps(step, B, L, K, st[0], st[1], gens[kind])
        return run

    for _ in range(2):  # eager, then the capture
        device_turn("graph")()
    chk.measure(f"E8 bf16 make_device_data_steps K={K}", 3, device_turn("graph"),
                device_turn("eager"), stepper.graphs.pool, per_step=K)
    del stepper, state
    torch.cuda.empty_cache()
    run_graphs_offline(dev, cfg, params32, smi, chk)
    print(f"  phase 24: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return chk.rows


class _EagerOwner:
    """A stand-in for ``graphs.ForwardGraphs`` that runs ``fn`` eagerly on the
    card, on the same inputs (the eager side of a comparison)."""

    def __init__(self, fn, device):
        self.fn, self.device = fn, torch.device(device)

    def __call__(self, params, *inputs):
        return self.fn(params, *[x.to(self.device) for x in inputs])

    def __len__(self):
        return 0

    def reset(self):
        pass


def run_graphs_offline(dev, cfg, params32, smi, chk):
    """Phase 24 (b): the offline paths' graphs against their eager bodies on
    the card.  The offline forward (``graphs.ForwardGraphs``: E8 bf16 as
    ``cli/denoise.py --bf16`` runs it and fp32 at 10 s x 2, the
    ``__graft_entry__`` shape (1, 16000) fp32, mamba2 and mamba_s4 at E8
    widths), ``validate`` graphed and eager; the KD step (``graph_kd_step``,
    phase 19's E8 teacher and FullMini student, bf16, 2 x 10 s), the E8 fp32
    pruning gradient before and after a prune event, and a finetune step of
    the pruned checkpoint (``graph_train_step``), each compared over three
    calls under torch's deterministic algorithms and timed with the default
    ones; ``cli/serve.py``'s bench rep at 8 x 16 bf16; phase 23's one-shot
    10 s feeds (no graph may be captured).  Each graph's first call runs
    eagerly and its second captures: three calls give eager, captured and
    replayed outputs, each held bit for bit against the eager body (a
    difference is printed and held to the path's tolerance).  The forward
    owner must not write the caller's params and must see params changed
    in place and replaced; the pruning gradient's reserved memory may grow
    across the event by one graph pool at most."""
    from cleanumamba_tpu_torch.cli.serve import make_bench_run
    from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.data import SyntheticDenoiseDataset
    from cleanumamba_tpu_torch.data.synth_device import synth_batch
    from cleanumamba_tpu_torch.graphs import ForwardGraphs, launch_counters, own
    from cleanumamba_tpu_torch.models.cleanumamba import forward, init_params, prepare_for_length
    from cleanumamba_tpu_torch.params import (
        load_checkpoint,
        prepare_weight_view,
        tensor_leaves,
        tree_map,
    )
    from cleanumamba_tpu_torch.prune import driver
    from cleanumamba_tpu_torch.prune.groups import build_groups
    from cleanumamba_tpu_torch.prune.pruner import apply_pruning
    from cleanumamba_tpu_torch.streaming import stream_prime
    from cleanumamba_tpu_torch.train.distill import (
        graph_kd_step,
        make_kd_adapters,
        make_kd_train_step,
    )
    from cleanumamba_tpu_torch.train.optim import make_optimizer
    from cleanumamba_tpu_torch.train.trainer import graph_train_step, make_train_step

    # the module (the package's ``validate`` is the function)
    validate_mod = importlib.import_module("cleanumamba_tpu_torch.eval.validate")
    t_part = time.perf_counter()
    spent = {}  # seconds of each part

    def lap(part):
        spent[part] = time.perf_counter() - t_part - sum(spent.values())

    counters = launch_counters()
    gen = torch.Generator(device=dev).manual_seed(2413)

    def moved(fn):
        """The launch counts one call of ``fn`` adds."""
        before = _counts_now(counters)
        fn()
        torch.cuda.synchronize()
        after = _counts_now(counters)
        return {k: after[k] - before[k] for k in before if after[k] != before[k]}

    def same_counts(name, graphed, eager):
        g, e = moved(graphed), moved(eager)
        if g != e:
            raise AssertionError(f"{name}: launches counted a replay {g}, an eager call {e}")
        return g

    def three_calls(name, owner, call, ref, tol, copy):
        """The owner's first three calls (eager, captured, replayed) against
        ``ref``: outputs through ``copy`` (read before the next replay)."""
        err = 0.0
        for i in range(3):
            got = copy(call())
            if len(owner) != min(i, 1):
                raise AssertionError(f"{name}: {len(owner)} graphs after call {i + 1}, want "
                                     f"{min(i, 1)}")
            err = max(err, chk.state(f"{name} call {i + 1}", got, ref, tol))
        return err

    def host(out):
        return [t.float().cpu() for t in tensor_leaves(out)]

    # (1) the offline forward
    x10 = synth_batch(gen, 2, 10 * SR)[1].cpu()
    x1 = torch.from_numpy((np.random.default_rng(0).normal(size=(1, 16000)) * 0.1
                           ).astype(np.float32))
    fwd32 = lambda p, x: forward(p, x, cfg)  # noqa: E731
    fwd16 = lambda p, x: forward(p, x.to(torch.bfloat16), cfg).float()  # noqa: E731

    def offline(name, fn, params, x, tol, steps=6):
        owner = ForwardGraphs(fn, dev)
        with torch.no_grad():
            ref = host(fn(params, x.to(dev)))
            err = three_calls(name, owner, lambda: owner(params, x), ref, tol, host)
            n = same_counts(name, lambda: owner(params, x), lambda: fn(params, x.to(dev)))
            chk.measure(name, steps, lambda: owner(params, x), lambda: fn(params, x.to(dev)),
                        owner.pool)
        print(f"  {name}: graph == eager over its first 3 calls (eager, captured, replayed; "
              f"max|diff| {err:.3e}); launches a call {n}", flush=True)
        return owner

    bf16 = tree_map(lambda v: v.to(torch.bfloat16) if isinstance(v, torch.Tensor)
                    and v.dtype == torch.float32 else v, params32)
    offline("E8 bf16 offline 10 s x 2 (cli/denoise.py --bf16)", fwd16, bf16, x10, BF16_TOL)
    del bf16
    offline("E8 fp32 offline 10 s x 2", fwd32, params32, x10, FP32_TOL)
    kept = own(params32)
    owner = offline("E8 fp32 (1, 16000), the __graft_entry__ shape", fwd32, params32, x1,
                    FP32_TOL)
    with torch.no_grad():
        if not all(torch.equal(a, b) for a, b in zip(tensor_leaves(params32),
                                                     tensor_leaves(kept))):
            raise AssertionError("ForwardGraphs wrote the caller's params")
        changed = own(params32)
        for t in tensor_leaves(changed):
            t.mul_(1.01)
        replaced = tree_map(lambda t: t * 0.98 if isinstance(t, torch.Tensor) else t, params32)
        for what, p in (("changed in place", changed), ("replaced", replaced)):
            got, ref = owner(p, x1).cpu(), fwd32(p, x1.to(dev)).cpu()
            if not torch.equal(got, ref) or len(owner) != 1:
                raise AssertionError(f"ForwardGraphs: params {what} not seen by the replay "
                                     f"({len(owner)} graphs)")
    del kept, changed, replaced, owner
    print("  ForwardGraphs left the caller's params as they were, and its replay saw params "
          "changed in place and replaced (bit for bit against eager)", flush=True)
    fams = {}  # E8 widths, seed 0 (phase 23's models; kept for its one-shot feeds)
    for fam in ("mamba2", "mamba_s4"):
        c = dataclasses.replace(cfg, bottleneck=fam)
        fams[fam] = prepare_for_length(init_params(c, torch.Generator().manual_seed(0), dev), c,
                                       10 * SR)
        offline(f"E8 {fam} fp32 offline 10 s x 2", lambda q, x, c=c: forward(q, x, c),
                fams[fam], x10, FP32_TOL, steps=4)

    # validate: 3 items (eager, captured, replayed), eager and graphed in turns
    ds = SyntheticDenoiseDataset(n_items=3, seed=4242)
    walls, metrics = {"graph": [], "eager": []}, {}
    for kind in ("eager", "graph", "graph", "eager"):
        with _wrapped(validate_mod, "ForwardGraphs",
                      (lambda real: _EagerOwner) if kind == "eager" else (lambda real: real)):
            t1 = time.perf_counter()
            metrics[kind] = validate_mod.validate(params32, cfg, ds, max_items=3, pad_to=4 * SR)
            walls[kind].append(time.perf_counter() - t1)
    if metrics["graph"] != metrics["eager"]:
        raise AssertionError(f"validate: graphed {metrics['graph']} vs eager {metrics['eager']}")
    print(f"  validate, E8 fp32, 3 items of 4 s, on {smi}: graphed "
          f"{' '.join(f'{t:.3f}' for t in walls['graph'])} s, eager "
          f"{' '.join(f'{t:.3f}' for t in walls['eager'])} s; the same metrics", flush=True)
    lap("forward")

    # (2) the KD step: phase 19's teacher and student, bf16, 2 x 10 s
    s_cfg = _fullmini("mamba")
    student = init_params(s_cfg, torch.Generator().manual_seed(19), dev)
    adapters = make_kd_adapters(torch.Generator().manual_seed(20), s_cfg, cfg, device=dev)
    opt_cfg = OptimizationConfig()
    optimizer = make_optimizer(opt_cfg, schedule=lambda s: opt_cfg.learning_rate)
    step = make_kd_train_step(s_cfg, cfg, LossConfig(kd_p=1.0), optimizer, bf16=opt_cfg.bf16)
    batches = [synth_batch(gen, 2, 10 * SR) for _ in range(4)]

    def fresh_kd():
        return [own(student), own(adapters), optimizer.init((student, adapters))]

    with _deterministic(True):
        graphed = graph_kd_step(step, dev)
        g, e = fresh_kd(), fresh_kd()
        err = 0.0
        for i in range(3):
            *g, aux_g = graphed(*g, params32, batches[i])
            *e, aux_e = step(*e, params32, batches[i])
            if len(graphed.graphs) != min(i, 1):
                raise AssertionError(f"KD: {len(graphed.graphs)} graphs after call {i + 1}")
            err = max([err, chk.state(f"KD step {i}", g, e, BF16_TOL)]
                      + [chk.same(f"KD step {i} aux {k}", aux_g[k].float().reshape(1),
                                  aux_e[k].float().reshape(1), BF16_TOL) for k in aux_e])
        n = same_counts("KD step", lambda: graphed(*g, params32, batches[3]),
                        lambda: step(*e, params32, batches[3]))
    print(f"  KD step, deterministic algorithms: graph against eager over 3 steps (student, "
          f"adapters, Adam state, aux) max|diff| {err:.3e}; launches a step {n}", flush=True)
    del graphed, g, e
    graphed = graph_kd_step(step, dev)
    st = {"graph": fresh_kd(), "eager": fresh_kd()}
    turn = {"graph": 0, "eager": 0}

    def kd_turn(kind, fn):
        def run():
            st[kind][:] = fn(*st[kind], params32, batches[turn[kind] % 4])[:3]
            turn[kind] += 1
        return run

    for _ in range(2):  # eager, then the capture
        kd_turn("graph", graphed)()
    chk.measure("KD step, E8 teacher + FullMini student, bf16, 2 x 10 s", 3,
                kd_turn("graph", graphed), kd_turn("eager", step), graphed.graphs.pool)
    del graphed, st, student, adapters
    torch.cuda.empty_cache()
    lap("KD")

    # (3) the E8 fp32 pruning gradient, before and after a prune event
    loss_and_grad = driver.make_loss_and_grad(cfg, LossConfig())
    clean, noisy = synth_batch(gen, 2, 10 * SR)
    rng = np.random.default_rng(24)
    selection = {gr.name: sorted(rng.choice(gr.n_channels, size=8 if gr.name.startswith(
        "d_inner") else 3, replace=False).tolist()) for gr in build_groups(params32, cfg)}
    timed = ForwardGraphs(loss_and_grad, dev)
    reserved = {}
    for label, p in (("at the start", params32),
                     ("after a prune event", apply_pruning(params32, selection, cfg)[0])):
        name = f"E8 fp32 pruning gradient {label}, 2 x 10 s"
        with _deterministic(True):
            checked = ForwardGraphs(loss_and_grad, dev)
            ref = host(loss_and_grad(p, clean, noisy))
            err = three_calls(name, checked, lambda: checked(p, clean, noisy), ref, FP32_TOL,
                              host)
            n = same_counts(name, lambda: checked(p, clean, noisy),
                            lambda: loss_and_grad(p, clean, noisy))
            del checked
        torch.cuda.empty_cache()
        if label != "at the start":  # the event: the old width's graphs go first
            reserved["before the event"] = torch.cuda.memory_reserved()
            timed.reset()
            reserved["after the reset"] = torch.cuda.memory_reserved()
        for _ in range(2):  # eager, then the capture
            timed(p, clean, noisy)
        chk.measure(name, 3, lambda: timed(p, clean, noisy),
                    lambda: loss_and_grad(p, clean, noisy), timed.pool)
        reserved[label] = torch.cuda.memory_reserved()
        pool = _pool_mb(timed.pool) * 2 ** 20
        print(f"  {name}: graph == eager over its first 3 calls, deterministic algorithms "
              f"(loss and every gradient leaf; max|diff| {err:.3e}); launches a call {n}",
              flush=True)
    if not reserved["after a prune event"] <= reserved["before the event"] + pool:
        raise AssertionError(f"pruning gradient: reserved memory grew across the event by more "
                             f"than one graph pool: {reserved}")
    print("  pruning gradient, reserved MiB " + ", ".join(
        f"{k} {v / 2 ** 20:.0f}" for k, v in reserved.items())
          + f"; the new width's pool {pool / 2 ** 20:.0f} MiB", flush=True)
    del timed
    lap("pruning")

    # (4) a finetune step of the pruned checkpoint (cli/finetune.py's step)
    fcfg, fparams = load_checkpoint(os.path.join(ROOT, CKPT), dev)
    f_opt = OptimizationConfig(n_iters=10_000, learning_rate=1e-4)
    foptim = make_optimizer(f_opt)
    fstep = make_train_step(fcfg, LossConfig(), foptim, bf16=f_opt.bf16)
    fb = [tuple(t.reshape(1, 2, 10 * SR) for t in synth_batch(gen, 2, 10 * SR))
          for _ in range(4)]
    name = f"finetune step, {CKPT}, bf16, 2 x 10 s"
    with _deterministic(True):
        graphed = graph_train_step(fstep, dev)
        g = [own(fparams), foptim.init(fparams)]
        e = [own(fparams), foptim.init(fparams)]
        err = 0.0
        for i in range(3):
            *g, aux_g = graphed(*g, fb[i])
            *e, aux_e = fstep(*e, fb[i])
            if len(graphed.graphs) != min(i, 1):
                raise AssertionError(f"finetune: {len(graphed.graphs)} graphs after call {i + 1}")
            err = max([err, chk.state(f"finetune step {i}", g, e, BF16_TOL)]
                      + [chk.same(f"finetune step {i} aux {k}", aux_g[k].float().reshape(1),
                                  aux_e[k].float().reshape(1), BF16_TOL) for k in aux_e])
        n = same_counts(name, lambda: graphed(*g, fb[3]), lambda: fstep(*e, fb[3]))
    print(f"  {name}, deterministic algorithms: graph against eager over 3 steps (params, Adam "
          f"state, aux) max|diff| {err:.3e}; launches a step {n}", flush=True)
    graphed = graph_train_step(fstep, dev)
    st = {"graph": [own(fparams), foptim.init(fparams)],
          "eager": [own(fparams), foptim.init(fparams)]}
    turn = {"graph": 0, "eager": 0}

    def ft_turn(kind, fn):
        def run():
            st[kind][:] = fn(*st[kind], fb[turn[kind] % 4])[:2]
            turn[kind] += 1
        return run

    for _ in range(2):  # eager, then the capture
        ft_turn("graph", graphed)()
    chk.measure(name, 3, ft_turn("graph", graphed), ft_turn("eager", fstep), graphed.graphs.pool)
    del graphed, st, g, e
    torch.cuda.empty_cache()
    lap("finetune")

    # (5) cli/serve.py's bench rep, 8 slots x block 16, bf16 weights
    stored, view = prepare_weight_view(params32, "bf16", torch.bfloat16)
    run = make_bench_run(cfg, view, 16, torch.bfloat16)
    B, tick = 8, 16 * cfg.total_stride
    n_ticks = 4  # a rep of 4 ticks: its eager trace stays short
    audio = torch.from_numpy((np.random.default_rng(15).normal(
        size=(B, cfg.frame_length + n_ticks * tick)) * 0.1).astype(np.float32)).to(dev)
    ticks = audio[:, cfg.frame_length:].reshape(B, n_ticks, tick).transpose(0, 1).contiguous()
    name = "cli/serve.py bench rep, E8 bf16, 8 slots x block 16"
    with torch.no_grad():
        state, _ = stream_prime(view(stored), cfg, audio[:, :cfg.frame_length].contiguous(),
                                torch.bfloat16)
        kept = own(state)
        owner = ForwardGraphs(run, dev)
        err = 0.0
        for i, scale in enumerate((1.0, 1.001, 1.002)):
            got = owner((stored, state), ticks, torch.tensor(scale)).reshape(1).cpu()
            if len(owner) != min(i, 1):
                raise AssertionError(f"serve bench: {len(owner)} graphs after call {i + 1}")
            err = max(err, chk.same(f"{name} rep {i}", got, run(
                (stored, state), ticks, torch.tensor(scale, device=dev)).reshape(1).cpu(),
                BF16_TOL))
        if not all(torch.equal(a, b) for a, b in zip(tensor_leaves(state), tensor_leaves(kept))):
            raise AssertionError("serve bench: a rep wrote the primed state")
        one = torch.tensor(1.0)
        n = same_counts(name, lambda: owner((stored, state), ticks, one),
                        lambda: run((stored, state), ticks, one.to(dev)))
        chk.measure(name, 3, lambda: owner((stored, state), ticks, one).item(),
                    lambda: run((stored, state), ticks, one.to(dev)).item(), owner.pool,
                    per_step=n_ticks)
    rate = {k: B * tick / SR / (v[0] / 1e3) for k, v in chk.rows[-1][1].items()}
    print(f"  {name}: the rep's sum |output| graph == eager over 3 reps (max|diff| {err:.3e}), "
          f"the primed state untouched; launches a rep {n}; {n_ticks} ticks a rep: graph "
          f"{rate['graph']:.1f}, eager {rate['eager']:.1f} audio-s/s (median tick)", flush=True)
    del owner, state, kept, stored
    lap("serve bench")

    # (6) phase 23's one-shot 10 s feeds: a shape that comes once is not
    # captured (its models: E8 widths, seed 0, as above, and the checkpoint)
    x = synth_batch(torch.Generator(device=dev).manual_seed(23), 1, SP_L)[1].cpu().numpy()
    for case in SP_CASES:
        if case.get("ckpt"):
            mcfg, p = _sp_model(case, dev)
        else:
            mcfg = dataclasses.replace(cfg, **case["cfg"])
            p = fams.get(mcfg.bottleneck, params32)
        runs = {"graph": [], "eager": []}
        for kind in ("eager", "graph", "graph", "eager"):
            runs[kind].append(_zero_primed(p, mcfg, x, 2, dev, eager=kind == "eager"))
        ref = runs["eager"][0][0]
        for y, _, n_graphs in runs["graph"] + runs["eager"]:
            if not torch.equal(y, ref):
                raise AssertionError(f"one-shot feed {case['name']}: graphed differs from eager")
            if n_graphs:
                raise AssertionError(f"one-shot feed {case['name']}: {n_graphs} graphs captured")
        ms = {k: [r[1] for r in v] for k, v in runs.items()}
        print(f"  one-shot 10 s feed (phase 23's), {case['name']}, on {smi}: graphed Streamer "
              f"{' '.join(f'{t:.1f}' for t in ms['graph'])} ms, eager "
              f"{' '.join(f'{t:.1f}' for t in ms['eager'])} ms, in turns; nothing captured; "
              f"equal bit for bit", flush=True)
    del p, fams
    torch.cuda.empty_cache()
    lap("one-shot feeds")
    print(f"  phase 24 (b): {time.perf_counter() - t_part:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")", flush=True)


# --------------------------------------------------------------------------
# Phase 25: K6, one token of attention over per-row KV rings
# --------------------------------------------------------------------------

KV_KERNEL = "kv_attention_kernel"  # K6's name in a trace
# 16 rows (the multiplexer's slots): an empty window to rings wrapped many times
KV_POS = (0, 1, 2, 7, 78, 79, 80, 300, 623, 624, 625, 626, 1249, 1250, 5000, 40)
KV_FULL_ROW = 14  # KV_POS[14]: a window wrapped and full, as a call's after 10 s
# (d_model, heads) of every head width K6 is built for: CleanUNet's (E8's
# widths), the released small geometry's, a test configuration's
KV_GEOMETRIES = ((512, 8), (64, 8), (32, 2))
KV_LAYERS, KV_WINDOW = 5, 625  # CleanUNet's layers; 10 s of tokens
CLEANUNET = dict(bottleneck="mha", tsfm_n_layers=5, norm_epsilon=1e-6)  # E8's U-Net and widths


def _kv_rows(pattern, dev, B=16):
    """The rows of the 16 that a call steps, gathered as a tick gathers its
    own: one (the cells' tick), all, or a subset."""
    rows = {"one row": [KV_FULL_ROW], "all rows": list(range(B)),
            "a subset of rows": [b for b in range(B) if b % 5 != 3]}[pattern]
    return torch.tensor(rows, device=dev)


def _kv_inputs(g, dev, d, dtype, B=16):
    """q, k, v (B, d) and the rings (B, layers, W, d), scaled so that the
    softmax is neither flat nor one-hot."""
    rings = [torch.randn((B, KV_LAYERS, KV_WINDOW, d), generator=g, device=dev).to(dtype)
             for _ in range(2)]
    tok = [(torch.randn((B, d), generator=g, device=dev) * 8 / d ** 0.5).to(dtype)
           for _ in range(3)]
    return (*tok, *rings)


def _kv_in_place_plain(q, k, v, k_ring, v_ring, pos, n_head):
    """The simplest in-place step in plain torch, for the times only: each
    row's slot written by one ``scatter_`` (no host read, so a tick's graph
    captures it), then one masked ``scaled_dot_product_attention`` over the
    whole rings."""
    B, W, d = k_ring.shape
    idx = (pos % W).long()[:, None, None].expand(B, 1, d)
    for ring, new in ((k_ring, k), (v_ring, v)):
        ring.scatter_(1, idx, new[:, None, :])
    return _kv_library(q, k_ring, v_ring, pos, n_head).reshape(B, d)


def _kv_library(q, k_ring, v_ring, pos, n_head):
    """One masked ``scaled_dot_product_attention`` over the rings (the
    library's nearest call: it neither writes the rings nor skips a row)."""
    B, W, d = k_ring.shape
    dk = d // n_head
    valid = torch.arange(W, device=q.device)[None, :] < torch.clamp(pos + 1, max=W)[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, n_head, 1, dk), k_ring.reshape(B, W, n_head, dk).transpose(1, 2),
        v_ring.reshape(B, W, n_head, dk).transpose(1, 2), attn_mask=valid[:, None, None, :])


def _trace_per_call(fn, iters=50, warmup=5, kernel=None):
    """(device-busy ms a call, median ms of the kernels named ``kernel`` or
    None) from a ``torch.profiler`` trace of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy, _ = _device_busy(prof)
    own = [e.time_range.end - e.time_range.start for e in prof.events()
           if kernel and e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if kernel and len(own) < iters // 2:
        raise AssertionError(f"a trace of {iters} calls held {len(own)} {kernel} launches")
    return busy / iters, (_median(own) / 1e3 if own else None)


def _kv_cost(pos, d, H, esize):
    """(bytes, operations, exps) of one launch over the rows at ``pos``,
    counted as the benchmark's ``portbench/counts/k6.py`` counts them: per
    attended position its key and value read, 4 d operations and an exp a
    head; per row q read, the output written, the new key and value
    written."""
    n = torch.clamp(pos.long() + 1, max=KV_WINDOW)
    positions, rows = int(n.sum()), n.shape[0]
    return (2 * d * positions + 4 * d * rows) * esize, 4 * d * positions, H * positions


def _kv_tick_arm(dev, cfg, params32, label, sessions=6, fill=640, timed=200, traced=150):
    """The CleanUNet multiplexer's tick (16 slots, bf16 weights, fp32 state,
    graphed) with one live row a tick: ``sessions`` sessions each stepped
    ``fill`` ticks (full windows), then one hop to each in turn.  Returns
    (the outputs of the timed and traced hops, wall ms a tick, device-busy
    ms a tick, K6 launches over those ticks, ticks, the top kernels of the
    traced ticks)."""
    from torch.profiler import ProfilerActivity, profile

    from cleanumamba_tpu_torch.ops.cuda.kv_attention import kv_attention
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    rng = np.random.default_rng(251)
    mux = SessionMultiplexer(params32, cfg, slots=16, block=1, weights="bf16", device=dev)
    fl, ts = cfg.frame_length, cfg.total_stride
    sids = [mux.open() for _ in range(sessions)]
    for s in sids:
        mux.feed(s, (rng.normal(size=fl + fill * ts) * 0.1).astype(np.float32))
    hops = (rng.normal(size=(timed + traced, ts)) * 0.1).astype(np.float32)
    torch.cuda.synchronize()
    kv_attention.launches = 0
    outs, n0 = [], mux.ticks
    t0 = time.perf_counter()
    for i in range(timed):
        outs.append(mux.feed(sids[i % sessions], hops[i]))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / timed
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(timed, timed + traced):
            outs.append(mux.feed(sids[i % sessions], hops[i]))
        torch.cuda.synchronize()
    busy, _ = _device_busy(prof)
    ticks = mux.ticks - n0
    top = sorted(((e.device_time_total / traced, e.key) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)[:6]
    launches = kv_attention.launches
    print(f"  {label}: wall {wall:.4f} ms a tick, device busy {busy / traced:.4f} ms a tick "
          f"({ticks} ticks, one live row each, windows full), K6 launches {launches}, "
          f"memory peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)
    for us, name in top:
        print(f"      {us:9.2f} us a tick  {name[:100]}", flush=True)
    del mux
    torch.cuda.empty_cache()
    return np.concatenate(outs), wall, busy / traced, launches, ticks


def check_kv_attention(dev, rep: Report, smi):
    """Phase 25: K6 against its plain version on the card, its times, and
    the CleanUNet tick with K6 against the plain in-place step.  Returns K6's
    launches over the K6 arm's ticks."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models import bottleneck_mha
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.ops.cuda.kv_attention import kv_attention, kv_attention_ref

    g = torch.Generator(device=dev).manual_seed(25)
    pos = torch.tensor(KV_POS, dtype=torch.int32, device=dev)
    li = KV_LAYERS - 1  # the last layer's rings: a view 4 * W * d into each row
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for d, H in KV_GEOMETRIES:
            q, k, v, kc, vc = _kv_inputs(g, dev, d, dtype)
            for pattern in ("one row", "all rows", "a subset of rows"):
                r = _kv_rows(pattern, dev)
                qr, kr, vr, pr = q[r], k[r], v[r], pos[r]
                kk, vk, kp, vp = kc[r], vc[r], kc[r], vc[r]  # gathered: copies
                got = kv_attention(qr, kr, vr, kk[:, li], vk[:, li], pr, H)
                again = kv_attention(qr, kr, vr, kk[:, li], vk[:, li], pr, H)
                want = kv_attention_ref(qr, kr, vr, kp[:, li], vp[:, li], pr, H)
                torch.cuda.synchronize()
                label = f"{str(dtype)[6:]} {H} heads of {d // H}, W {KV_WINDOW}, {pattern}"
                _same_bits(f"kv_attention {label}", [got], [again])
                if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                    raise AssertionError(f"kv_attention {label}: the rings differ from the "
                                         "plain version's")
                rep.check("kv_attention_kernel", label, got, want, tol)

    # times at the cell's shape (fp32), every row's window full
    d, H = KV_GEOMETRIES[0]
    q16, k16, v16, kc, vc = _kv_inputs(g, dev, d, torch.float32)
    full16 = torch.full((16,), 1000, dtype=torch.int32, device=dev) + torch.arange(
        16, dtype=torch.int32, device=dev)
    for pattern in ("one row", "all rows"):
        r = _kv_rows(pattern, dev)
        q, k, v, full = q16[r], k16[r], v16[r], full16[r]
        kr, vr = kc[r][:, li], vc[r][:, li]
        plain_inplace = _kv_in_place_plain(q, k, v, kr.clone(), vr.clone(), full, H)
        want = kv_attention_ref(q, k, v, kr.clone(), vr.clone(), full, H)
        err = _rel_err(plain_inplace, want)[1]
        if not err <= FP32_TOL:
            raise AssertionError(f"the plain in-place step ({pattern}): rel {err:.3e}")
        _, k6_ms = _trace_per_call(
            lambda: kv_attention(q, k, v, kr, vr, full, H), kernel=KV_KERNEL)
        plain_ms, _ = _trace_per_call(
            lambda: kv_attention_ref(q, k, v, kr, vr, full, H), iters=20)
        inplace_ms, _ = _trace_per_call(
            lambda: _kv_in_place_plain(q, k, v, kr, vr, full, H))
        lib_ms, _ = _trace_per_call(lambda: _kv_library(q, kr, vr, full, H))
        nbytes, flops, exps = _kv_cost(full, d, H, 4)
        bound_ms, by = _bound(nbytes, flops, torch.float32, sfu=exps)
        print(f"  K6 times on {smi}, fp32, {H} heads of {d // H}, W {KV_WINDOW}, "
              f"{pattern} (windows full): K6 {k6_ms * 1e3:.2f} us a launch; plain version "
              f"{plain_ms * 1e3:.2f} us busy; plain in-place step (one-slot scatter + masked "
              f"SDPA) {inplace_ms * 1e3:.2f} us busy; masked SDPA alone {lib_ms * 1e3:.2f} us "
              f"busy; bound {bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e6:.3f} MFLOP, {exps} exps), K6 at {100 * bound_ms / k6_ms:.1f} % "
              f"of it", flush=True)
        if pattern == "one row":  # the cell's tick: one row
            rep.ms["kv_attention_kernel"] = (k6_ms, plain_ms)
            rep.bound["kv_attention_kernel"] = (bound_ms, by)
            rep.library["kv_attention_kernel"] = lib_ms

    # the CleanUNet tick: K6 against the plain in-place step in its place
    cfg = CleanUMambaConfig(**CLEANUNET)
    params32 = init_params(cfg, torch.Generator().manual_seed(0), dev)
    arms = {}
    for label in ("K6", "plain in-place step", "K6 again"):
        if label == "plain in-place step":
            bottleneck_mha.kv_attention = _kv_in_place_plain
        try:
            arms[label] = _kv_tick_arm(dev, cfg, params32, f"CleanUNet tick, {label}")
        finally:
            bottleneck_mha.kv_attention = kv_attention
    (y_k6, _, busy_k6, n_k6, ticks), (y_pl, _, busy_pl, n_pl, _) = \
        arms["K6"], arms["plain in-place step"]
    err = _rel_err(torch.from_numpy(y_k6), torch.from_numpy(y_pl))[1]
    print(f"  CleanUNet tick on {smi}: plain in-place step - K6 = "
          f"{busy_pl - busy_k6:.4f} ms device busy a tick ({busy_pl:.4f} against {busy_k6:.4f}; "
          f"K6 again {arms['K6 again'][2]:.4f}); outputs rel {err:.3e}", flush=True)
    if not err <= FP32_TOL:
        raise AssertionError(f"the CleanUNet tick, K6 against the plain step: rel {err:.3e}")
    if n_k6 != ticks * KV_LAYERS or n_pl != 0:
        raise AssertionError(f"K6 launches {n_k6} over {ticks} ticks of {KV_LAYERS} layers "
                             f"(the plain arm: {n_pl})")
    return n_k6


def _kv_entry(rep: Report, launches):
    """K6's entry of the kernels' summary: its launches over the CleanUNet
    tick (phase 25), its time and bound at one row with a full window, and
    the masked ``scaled_dot_product_attention`` over the rings as the
    library's nearest call (which does not write the rings)."""
    ms, plain_ms = rep.ms["kv_attention_kernel"]
    bound_ms, bound_by = rep.bound["kv_attention_kernel"]
    return {"name": "kv_attention_kernel", "route": "cuda",
            "source": "cleanumamba_tpu_torch/csrc/kv_attention.cu",
            "replaces": "cleanumamba_tpu/models/bottleneck_mha.py:114 (no TPU kernel: XLA's "
                        "whole-ring where and softmax, one position for the batch)",
            "launches": launches, "max_abs_err": rep.err["kv_attention_kernel"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": rep.library["kv_attention_kernel"]}


# --------------------------------------------------------------------------
# Phase 26: K7, rows of a multiplexer's pool gathered and scattered back
# --------------------------------------------------------------------------

def _random_like(x, g):
    if x.dtype.is_floating_point:
        return torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
    return torch.randint(-2 ** 20, 2 ** 20, x.shape, generator=g, device=x.device,
                         dtype=x.dtype)


def _pool_rows(w, slots, rng):
    """``w`` distinct rows of a pool of ``slots``, about a third of them (never
    all, where w > 1) given as padding rows, ``~row``."""
    rows = rng.permutation(slots)[:w]
    pad = rng.random(w) < 1 / 3
    pad[0] = False
    return [int(~r) if p else int(r) for r, p in zip(rows, pad)]


def check_row_copy(dev, rep: Report, smi, slots=16):
    """Phase 26: K7 against its plain versions at the pools of the
    benchmark's live multiplexers (E8 and CleanUNet, 16 slots, bf16
    weights, fp32 state), every batch-leading leaf filled with random
    values.  At each width from 1 to 16: a gather of that many rows, some
    as padding rows (``~row``), and a scatter of as many rows back under
    the same indices (the padding rows skipped), each bit for bit against
    the plain version, and a repeated call bit for bit.  Then, at width 1
    (the cells' tick), device times from a trace: K7's gather and scatter a
    launch, the plain versions as a tick would run them (one
    ``index_select`` or ``index_copy_`` a leaf) a call, and the bound of the
    bytes the row reads and writes.  E8's figures go to the kernels'
    summary."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params
    from cleanumamba_tpu_torch.ops.cuda.row_copy import (
        gather_rows,
        gather_rows_ref,
        scatter_rows,
        scatter_rows_ref,
    )
    from cleanumamba_tpu_torch.params import tree_leaves
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    rng = np.random.default_rng(26)
    g = torch.Generator(device=dev).manual_seed(26)
    for label, cfg in (("E8", CleanUMambaConfig()), ("CleanUNet", CleanUMambaConfig(**CLEANUNET))):
        mux = SessionMultiplexer(init_params(cfg, torch.Generator().manual_seed(0), dev), cfg,
                                 slots=slots, weights="bf16", device=dev)
        _admit_every_slot(mux, rng)
        pool = [_random_like(x, g) for x in tree_leaves(mux.pool)
                if x.ndim and x.shape[0] == slots]
        del mux
        torch.cuda.empty_cache()
        row_bytes = sum(x[:1].numel() * x.element_size() for x in pool)
        for w in range(1, slots + 1):
            idx = torch.tensor(_pool_rows(w, slots, rng), device=dev)
            got = [x.new_empty((w, *x.shape[1:])) for x in pool]
            want = [t.clone() for t in got]
            gather_rows(got, pool, idx)
            first = [t.clone() for t in got]
            gather_rows(got, pool, idx)
            gather_rows_ref(want, pool, idx)
            vals = [_random_like(t, g) for t in got]
            mine, ref = [x.clone() for x in pool], [x.clone() for x in pool]
            scatter_rows(mine, vals, idx)
            once = [t.clone() for t in mine]
            scatter_rows(mine, vals, idx)
            scatter_rows_ref(ref, vals, idx)
            torch.cuda.synchronize()
            case = f"{label} pool ({len(pool)} leaves, {row_bytes / 1e6:.2f} MB a row), width {w}"
            _same_bits(f"gather_rows {case}", first, got)
            _same_bits(f"scatter_rows {case}", once, mine)
            for name, a, b in (("gather_rows", got, want), ("scatter_rows", mine, ref)):
                bad = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
                if bad:
                    raise AssertionError(f"{name} {case}: leaves {bad} differ from the plain "
                                         "version's")
            del mine, ref, once
        print(f"  K7 {label} pool ({len(pool)} leaves, {row_bytes / 1e6:.3f} MB a row): gathers "
              f"and scatters of widths 1-{slots} with padding rows equal the plain versions bit "
              f"for bit, and a repeated call", flush=True)
        idx = torch.tensor([5], device=dev)
        got = [x.new_empty((1, *x.shape[1:])) for x in pool]
        _, gather_ms = _trace_per_call(lambda: gather_rows(got, pool, idx),
                                       kernel=ROW_COPY_KERNEL)
        _, scatter_ms = _trace_per_call(lambda: scatter_rows(pool, got, idx),
                                        kernel=ROW_COPY_KERNEL)
        plain_gather, _ = _trace_per_call(
            lambda: [torch.index_select(x, 0, idx, out=t) for t, x in zip(got, pool)])
        plain_scatter, _ = _trace_per_call(
            lambda: [x.index_copy_(0, idx, t) for t, x in zip(got, pool)])
        nbytes = 4 * row_bytes  # each way a row of every leaf read and written
        bound_ms, by = _bound(nbytes, 0)
        ms, plain_ms = gather_ms + scatter_ms, plain_gather + plain_scatter
        print(f"  K7 times on {smi}, {label} pool at width 1: gather {gather_ms * 1e3:.2f} us, "
              f"scatter {scatter_ms * 1e3:.2f} us a launch; plain ({len(pool)} index_select, "
              f"{len(pool)} index_copy_) {plain_gather * 1e3:.2f} + {plain_scatter * 1e3:.2f} us "
              f"busy; bound of both {bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.3f} MB), K7 "
              f"at {100 * bound_ms / ms:.1f} % of it", flush=True)
        if label == "E8":  # the e8-mux-live cell's tick
            rep.err["row_copy_kernel"] = 0.0  # bit for bit, checked above
            rep.ms["row_copy_kernel"] = (ms, plain_ms)
            rep.bound["row_copy_kernel"] = (bound_ms, by)
        del pool, got
        torch.cuda.empty_cache()


def _k7_entry(rep: Report, launches):
    """K7's entry of the kernels' summary: its launches over the graphed ticks
    of phase 15 (c), and the gather and scatter of E8's tick at width 1
    (phase 26) as one: time, plain version and bound.  No single library
    call copies rows of many tensors (``library_ms`` None)."""
    ms, plain_ms = rep.ms["row_copy_kernel"]
    bound_ms, bound_by = rep.bound["row_copy_kernel"]
    return {"name": "row_copy_kernel", "route": "cuda",
            "source": "cleanumamba_tpu_torch/csrc/row_copy.cu",
            "replaces": "cleanumamba_tpu/serve.py:207 (no TPU kernel: the JAX tick steps every "
                        "slot under the pause mask)",
            "launches": launches, "max_abs_err": rep.err["row_copy_kernel"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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
    parser.add_argument("--prune-only", action="store_true",
                        help="build K1/K2 only and run phase 18 (pruning and finetune) and "
                             "print no result lines")
    parser.add_argument("--dist-only", action="store_true",
                        help="build K1/K2 only and run phases 19 and 20 (distillation and data "
                             "parallelism) and print no result lines")
    parser.add_argument("--export-only", action="store_true",
                        help="build K1/K2 only and run phase 21 (serving bundles) and print no "
                             "result lines")
    parser.add_argument("--parallel-only", action="store_true",
                        help="build K1/K2 only and run phases 22 and 23 (tensor and sequence "
                             "parallelism) and print no result lines")
    parser.add_argument("--graphs-only", action="store_true",
                        help="build every kernel and run phase 24 (the CUDA graphs against "
                             "the eager steps) and print no result lines")
    parser.add_argument("--kv-only", action="store_true",
                        help="build K3/K4, K6 and K7 only and run phase 25 (K6) and print K6's "
                             "entry of the kernels' summary")
    parser.add_argument("--widths-only", action="store_true",
                        help="build K3/K4, K6 and K7 only and run phase 15's ticks at each width "
                             "(packed against per op; E8 and CleanUNet) and phase 26 (K7) and "
                             "print K7's entry of the kernels' summary")
    parser.add_argument("--dp-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--parallel-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--export-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--base-k5", metavar="DIR",
                        help="a checkout of an earlier version (e.g. the parent commit unpacked "
                             "with git archive): phase 12 times its K5 beside this one's in "
                             "one trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    # the processes phases 20 and 21 start (before any import of model code)
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if args.export_worker:
        return export_worker(args.export_worker)
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker)
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
    sources = ("stream_fused",) if args.fused_only else \
        ("selective_scan",) if (args.scan_only or args.prune_only or args.dist_only
                                or args.export_only or args.parallel_only) else \
        ("stream_fused", "kv_attention", "row_copy") if args.kv_only or args.widths_only else \
        ("selective_scan", "stream_fused", "stream_mega", "kv_attention", "row_copy")
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
    if args.prune_only:
        print("phase 18 structured channel pruning and finetune:", flush=True)
        run_pruning(dev, cfg, params32, (selective_scan, selective_scan_bwd), smi, rep)
        check_prune_card_vs_cpu(dev)
        run_prune_clis(dev)
        print("prune-only run: phase 18 passed (no result lines)")
        return 0
    if args.dist_only:
        print("phase 19 knowledge distillation (E8 teacher, FullMini student):", flush=True)
        run_kd(dev, cfg, params32, smi, (selective_scan, selective_scan_bwd), rep)
        print("phase 20 data parallelism (two gloo ranks on one card, torchrun):", flush=True)
        run_dp(dev, cfg, params32, smi, rep)
        check_torchrun_cli()
        print("dist-only run: phases 19 and 20 passed (no result lines)")
        return 0
    if args.export_only:
        print("phase 21 serving bundles (export.py, K1 as a custom op):", flush=True)
        run_export(dev, cfg, params32, smi)
        check_export_cli()
        print("export-only run: phase 21 passed (no result lines)")
        return 0
    if args.graphs_only:
        print("phase 24 CUDA graphs against the eager steps:", flush=True)
        run_graphs(dev, cfg, params32, smi)
        print("graphs-only run: phase 24 passed (no result lines)")
        return 0
    if args.kv_only:
        print("phase 25 K6 vs its plain version, its times, the CleanUNet tick:", flush=True)
        launches = check_kv_attention(dev, rep, smi)
        print(json.dumps({"kernels": [_kv_entry(rep, launches)]}))
        print("kv-only run: phase 25 passed (K6's entry above; no result lines)")
        return 0
    if args.widths_only:
        print("phase 15 (b) the packed tick against the per-op tick at each width:", flush=True)
        check_tick_packs(dev, cfg, params32, smi)
        print("phase 15 (c) the multiplexer's tick at each width:", flush=True)
        k7 = check_tick_widths(dev, smi)
        print("phase 26 K7 vs its plain versions at the multiplexers' pools:", flush=True)
        check_row_copy(dev, rep, smi)
        print(json.dumps({"kernels": [_k7_entry(rep, k7)]}))
        print("widths-only run: phases 15 (b), 15 (c) and 26 passed (K7's entry above; no "
              "result lines)")
        return 0
    if args.parallel_only:
        print("phase 22 tensor parallelism (gloo ranks on one card, torchrun on the CPU):",
              flush=True)
        run_tp(dev, cfg, params32, smi, rep)
        check_tp_cli()
        print("phase 23 sequence parallelism (two gloo ranks on one card):", flush=True)
        run_sp(dev, smi, rep)
        print("parallel-only run: phases 22 and 23 passed (no result lines)")
        return 0
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
    k1, mma, k7 = run_multiplexer(dev, cfg, params32, smi, selective_scan)
    launches["selective_scan"] += k1
    launches.update(mma)
    print("phase 16 the offline forward of mamba2 and mamba_s4:", flush=True)
    check_offline_families(dev, smi)
    print("phase 17 evaluation (validate, cli/evaluate.py, validation inside cli/train.py):",
          flush=True)
    launches["selective_scan"] += run_eval_path(dev, cfg, params32, selective_scan, smi)
    print("phase 18 structured channel pruning and finetune:", flush=True)
    prune_launches = run_pruning(dev, cfg, params32, (selective_scan, selective_scan_bwd), smi,
                                 rep)
    check_prune_card_vs_cpu(dev)
    run_prune_clis(dev)
    print("phase 19 knowledge distillation (E8 teacher, FullMini student):", flush=True)
    kd_launches = run_kd(dev, cfg, params32, smi, (selective_scan, selective_scan_bwd), rep)
    print("phase 20 data parallelism (two gloo ranks on one card, torchrun):", flush=True)
    dp_launches = run_dp(dev, cfg, params32, smi, rep)
    print("phase 21 serving bundles (export.py, K1 as a custom op):", flush=True)
    kept = tempfile.mkdtemp()
    bundle16 = os.path.join(kept, "stream16")
    launches["selective_scan"] += run_export(dev, cfg, params32, smi, keep=bundle16)
    print("phase 22 tensor parallelism (gloo ranks on one card, torchrun on the CPU):",
          flush=True)
    tp_launches = run_tp(dev, cfg, params32, smi, rep)
    print("phase 23 sequence parallelism (two gloo ranks on one card):", flush=True)
    launches["selective_scan"] += run_sp(dev, smi, rep)
    print("phases 20-22 the torchrun training CLIs and the export CLI, at once:", flush=True)
    check_clis_of_phases_20_22()
    print("phase 24 CUDA graphs against the eager steps:", flush=True)
    try:
        run_graphs(dev, cfg, params32, smi, bundle=bundle16)
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    print("phase 25 K6 vs its plain version, its times, the CleanUNet tick:", flush=True)
    kv_launches = check_kv_attention(dev, rep, smi)
    print("phase 26 K7 vs its plain versions at the multiplexers' pools:", flush=True)
    check_row_copy(dev, rep, smi)

    # launches: each path's own run (serving, phase 4; training, phase 7; the
    # int8 serving path, phase 14; the multiplexer's block-16 ticks, phase 15;
    # validate, phase 17; the pruning pipeline, phase 18; the KD steps, phase
    # 19; both DP ranks' steps, phase 20; the loaded block-16 step, phase 21;
    # both TP ranks' three fp32 E8 steps, phase 22; both SP ranks' calls, phase 23)
    for name, n in (list(train_launches.items()) + list(prune_launches.items())
                    + list(kd_launches.items()) + list(dp_launches.items())
                    + list(tp_launches.items())):
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
        # bf16 weights in an fp32 pack fed fp32 (the tensor cores), at the
        # multiplexer's 16 slots: launches of its ticks (phase 15)
        "fused_encoder_level_mma": ("fused_encoder_level_mma",
                                    "cleanumamba_tpu_torch/csrc/stream_fused.cu",
                                    "cleanumamba_tpu/ops/pallas/stream_fused.py:297"),
        "fused_decoder_level_mma": ("fused_decoder_level_mma",
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
    kernels.append(_kv_entry(rep, kv_launches))
    kernels.append(_k7_entry(rep, k7))
    print(f"E8 streaming RTF on {smi}: block 16 (bf16) {rtf16:.1f}x, "
          f"block 1 (Streamer, bf16 packs) {rtf1:.1f}x realtime")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
