"""Concurrent-session serving demo and aggregate throughput bench (port of
``cleanumamba_tpu/cli/serve.py``).

    # demo: staggered synthetic sessions through the multiplexer
    python -m cleanumamba_tpu_torch.cli.serve --ckpt <pkl> --slots 4 --sessions 3

    # aggregate serving throughput
    python -m cleanumamba_tpu_torch.cli.serve --ckpt flagship --slots 8 --block 16 \
        --bench --seconds 40

``serve.SessionMultiplexer`` steps every session in one batched call, so the
weights are read once per tick whatever the number of sessions.  The bench
primes ``slots`` streams, stages every tick's audio on the device, and runs
the ticks back to back with one synchronisation at the end of each rep; it
reports the audio-seconds per second of all slots together.  On a card a
rep is one CUDA graph over every tick (``graphs.ForwardGraphs``, the
counterpart of the JAX bench's jitted ``lax.scan``): the primed state goes
in as an input and nothing is donated, so every rep starts from it.  ``--ckpt
flagship`` is the E8 model from ``init_params`` with a seeded generator.
Runs on ``cuda:0`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.graphs import ForwardGraphs
from cleanumamba_tpu_torch.params import prepare_weight_view, resolve_device
from cleanumamba_tpu_torch.serve import SessionMultiplexer
from cleanumamba_tpu_torch.streaming import stream_prime, stream_step, stream_step_block

SR = 16000


def _load(args, device):
    if args.ckpt == "flagship":
        from cleanumamba_tpu_torch.models.cleanumamba import init_params

        cfg = CleanUMambaConfig()
        return cfg, init_params(cfg, torch.Generator().manual_seed(0), device)
    from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint

    cfg, params, _ = load_any_checkpoint(args.ckpt, device)
    return cfg, params


def _card(device) -> dict:
    """Where the numbers were taken: the backend, and on a card its name and
    power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return {"backend": device.type, "card": None, "power_limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                          "-i", str(device.index or 0)],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"backend": "cuda", "card": torch.cuda.get_device_name(device),
            "power_limit": smi.stdout.strip()}


def demo(args, device) -> None:
    cfg, params = _load(args, device)
    fl, ts = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(params, cfg, slots=args.slots, block=args.block,
                             weights=args.weights, device=device)
    rng = np.random.default_rng(0)
    n = fl + 40 * mux.tick_samples
    sessions, outs = {}, {}
    for _ in range(args.sessions):
        sid = mux.open()
        sessions[sid] = (rng.normal(size=n) * 0.2).astype(np.float32)
        outs[sid] = []
    # staggered, uneven feeding: sessions join and progress independently
    pos = {sid: 0 for sid in sessions}
    chunk = {sid: (i + 2) * ts for i, sid in enumerate(sessions)}
    t0 = time.perf_counter()
    while any(pos[s] < n for s in sessions):
        for sid, audio in sessions.items():
            if pos[sid] < n:
                nxt = min(pos[sid] + chunk[sid], n)
                outs[sid].append(mux.feed(sid, audio[pos[sid]:nxt]))
                pos[sid] = nxt
    for sid in sessions:
        outs[sid].append(mux.flush(sid))
        mux.close(sid)
    dt = time.perf_counter() - t0
    total = 0
    for sid in sessions:
        y = np.concatenate(outs[sid])
        total += y.shape[0]
        print(f"session {sid}: in {n} samples -> out {y.shape[0]} samples, "
              f"rms {float(np.sqrt(np.mean(y ** 2))):.4f}")
    print(f"{args.sessions} sessions, {mux.ticks} ticks, {total / SR:.1f} audio-s in "
          f"{dt:.1f} s host-loop wall on {device} (--bench for the throughput)")


def make_bench_run(cfg: CleanUMambaConfig, view, block: int, dtype):
    """The bench's rep: ``run((stored, state), ticks, scale) -> the sum of
    |output|`` over every tick of ``ticks`` (n_ticks, B, block *
    total_stride), each scaled by the 0-d tensor ``scale``, stepped from
    ``state``.  Reads its arguments and writes none of them."""
    step = stream_step if block == 1 else stream_step_block

    def run(weights_and_state, ticks, scale):
        stored, st = weights_and_state
        if cfg.bottleneck == "mha":  # a step writes the rings in place: step a copy
            st = dict(st, bottleneck=dict(st["bottleneck"], k=st["bottleneck"]["k"].clone(),
                                          v=st["bottleneck"]["v"].clone()))
        acc = torch.zeros((), device=ticks.device)
        for blk in ticks:
            st, out = step(view(stored), cfg, st, blk * scale, dtype)
            acc = acc + out.float().abs().sum()
        return acc

    return run


def bench(args, device) -> None:
    """Aggregate throughput: the ticks of ``--seconds`` of audio at batch =
    slots, back to back on the device (one graph on a card), one
    synchronisation per rep."""
    cfg, params = _load(args, device)
    fl, ts = cfg.frame_length, cfg.total_stride
    B, block = args.slots, args.block
    dtype = torch.bfloat16 if args.weights == "bf16" else torch.float32
    stored, view = prepare_weight_view(params, args.weights, dtype)
    tick = block * ts
    n_ticks = max(1, int(args.seconds * SR) // tick)

    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        (rng.normal(size=(B, fl + n_ticks * tick)) * 0.1).astype(np.float32)).to(device)
    ticks = audio[:, fl:].reshape(B, n_ticks, tick).transpose(0, 1).contiguous()
    run = ForwardGraphs(make_bench_run(cfg, view, block, dtype), device)
    with torch.no_grad():
        state, _ = stream_prime(view(stored), cfg, audio[:, :fl].contiguous(), dtype)

        def rep(scale: float) -> float:
            # the rep's one synchronisation, after the replay
            return run((stored, state), ticks, torch.tensor(scale, device=device)).item()

        for _ in range(2):  # warm-up: on a card the first runs eagerly, the second captures
            rep(1.0)
        dts = []
        for i in range(args.reps):
            t0 = time.perf_counter()
            rep(1.0 + 0.001 * (i + 1))
            dts.append(time.perf_counter() - t0)
    dt = min(dts)
    audio_s = n_ticks * tick / SR  # per session
    print(json.dumps({
        "metric": "serving_throughput",
        "value": _sig(B * audio_s / dt),
        "unit": "audio_seconds_per_second",
        "slots": B,
        "block": block,
        "weights": args.weights,
        "per_session_rtf": _sig(audio_s / dt),
        "tick_ms": round(dt / n_ticks * 1e3, 3),
        "reps_ms": [round(d * 1e3, 1) for d in dts],
        **_card(device),
    }))


def _sig(v: float) -> float:
    """``v`` to four significant digits: a slow but positive rate stays positive."""
    return float(f"{v:.4g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint path, or 'flagship' for the E8 model from a seeded init")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block", type=int, default=1)
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--weights", choices=["fp32", "bf16", "int8"], default="bf16")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--seconds", type=float, default=40.0,
                    help="audio seconds per session per timed rep (bench)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)
    if args.slots < 1 or args.block < 1 or args.sessions < 1:
        ap.error("--slots/--block/--sessions must be >= 1")
    if args.sessions > args.slots:
        ap.error("--sessions cannot exceed --slots")
    (bench if args.bench else demo)(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
