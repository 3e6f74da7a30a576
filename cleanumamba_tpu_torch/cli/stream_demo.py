"""Streaming demo CLI (port of ``cleanumamba_tpu/cli/stream_demo.py``).

    python -m cleanumamba_tpu_torch.cli.stream_demo --ckpt <pkl> --synthetic [--out y.wav]
    python -m cleanumamba_tpu_torch.cli.stream_demo --ckpt <pkl> --wav x.wav

Streams a wav file (``--wav``) or a synthetic tone in noise (``--synthetic``)
chunk by chunk through ``streaming.Streamer`` and reports ms per frame and
the real-time factor; ``--mic`` streams the microphone through ``sounddevice``
(not a dependency: without it the CLI exits with a message).  Runs on
``cuda:0`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.data.wavio import read_wav, write_wav
from cleanumamba_tpu_torch.params import resolve_device
from cleanumamba_tpu_torch.streaming import Streamer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--wav", default=None, help="stream this wav file")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--mic", action="store_true", help="live microphone input")
    ap.add_argument("--out", default=None, help="write the denoised wav here")
    ap.add_argument("--chunk", type=int, default=4096,
                    help="samples per feed (the reference's CHUNK=4096)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params, _ = load_any_checkpoint(args.ckpt, device)
    s = Streamer(params, cfg, device)
    sr = 16000
    if args.mic:
        _run_mic(s, args, sr)
        return
    if args.wav:
        audio, _ = read_wav(args.wav, sr)
    else:
        rng = np.random.default_rng(0)
        t = np.arange(int(args.seconds * sr)) / sr
        audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                 + 0.05 * rng.normal(size=t.shape)).astype(np.float32)

    outs = []
    t_total, n_frames = 0.0, 0
    warm_feeds = 3  # the first feeds build the kernels and warm the allocator
    for fi, i in enumerate(range(0, len(audio), args.chunk)):
        chunk = audio[None, i: i + args.chunk]
        t0 = time.perf_counter()
        out = s.feed(chunk)
        if fi >= warm_feeds:
            t_total += time.perf_counter() - t0
            n_frames += out.shape[1] // cfg.total_stride
        outs.append(out)
    outs.append(s.flush())
    den = np.concatenate(outs, axis=1)[0]

    frame_ms = cfg.total_stride / sr * 1e3
    ms_per_frame = t_total / max(n_frames, 1) * 1e3
    print(f"streamed {len(audio)/sr:.1f}s on {device} ({s.fused_mode}): steady-state "
          f"{ms_per_frame:.2f} ms/frame (frame = {frame_ms:.0f} ms audio) -> "
          f"{frame_ms/max(ms_per_frame, 1e-9):.1f}x realtime")
    if args.out:
        write_wav(args.out, den, sr)
        print(f"wrote {args.out}")


def _run_mic(s: Streamer, args, sr: int):  # pragma: no cover - needs hardware
    try:
        import sounddevice as sd
    except ImportError:
        raise SystemExit("sounddevice not installed; use --wav or --synthetic")
    print("streaming from microphone, Ctrl-C to stop")
    with sd.InputStream(samplerate=sr, channels=1, blocksize=args.chunk) as stream:
        try:
            while True:
                block, _ = stream.read(args.chunk)
                s.feed(block[:, 0][None, :])  # a real app would play the output back here
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
