"""Bulk denoising CLI (port of ``cleanumamba_tpu/cli/denoise.py``): a folder
of noisy wavs in, ``enhanced_*.wav`` out.

    python -m cleanumamba_tpu_torch.cli.denoise --ckpt <pkl> --input <dir> \
        --output <dir> [--bf16] [--pad-to-sec S] [--device D]

Reads either this project's checkpoints or the reference's PyTorch pickles
(:func:`load_any_checkpoint`).  Runs on ``cuda:0`` unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from cleanumamba_tpu_torch.convert import convert_payload
from cleanumamba_tpu_torch.data.dataset import NoisyOnlyDataset
from cleanumamba_tpu_torch.data.wavio import write_wav
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.params import from_numpy, payload_config, resolve_device, tree_map


def load_any_checkpoint(path: str, device=None):
    """``(cfg, params on device, meta)`` from a checkpoint of either format,
    told apart by content: a reference pickle (``torch.save`` of a dict with
    ``model_state_dict``) goes through ``convert``; this project's pickle (a
    dict with ``params`` and ``network_config``) through ``params``.  Only
    load checkpoints from a trusted source: unpickling runs code."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        zipped = f.read(2) == b"PK"  # torch.save's zip archive
    if zipped:
        payload = torch.load(path, map_location="cpu", weights_only=False)
    else:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    if isinstance(payload, dict) and "model_state_dict" in payload:
        return convert_payload(payload, device)
    if isinstance(payload, dict) and "params" in payload:
        meta = {k: v for k, v in payload.items() if k != "params"}
        return payload_config(payload), from_numpy(payload["params"], device), meta
    raise ValueError(f"{path}: neither a reference checkpoint (model_state_dict) nor one of "
                     "this project's (params)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--input", required=True, help="folder of noisy .wav files")
    ap.add_argument("--output", required=True, help="output folder")
    ap.add_argument("--sample-rate", type=int, default=16000)
    ap.add_argument("--pad-to-sec", type=float, default=None,
                    help="pad/crop every file to this length")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights and activations (normalisation and scan state stay fp32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, params, _ = load_any_checkpoint(args.ckpt, device)
    if args.bf16:
        params = tree_map(lambda v: v.to(torch.bfloat16) if isinstance(v, torch.Tensor)
                          and v.dtype == torch.float32 else v, params)
    in_dtype = torch.bfloat16 if args.bf16 else torch.float32
    ds = NoisyOnlyDataset(args.input, args.sample_rate)
    os.makedirs(args.output, exist_ok=True)

    total_audio, total_time = 0.0, 0.0
    for i in range(len(ds)):
        noisy, path = ds[i]
        L = len(noisy)
        x = noisy
        if args.pad_to_sec:
            target = int(args.pad_to_sec * args.sample_rate)
            x = np.pad(noisy, (0, max(0, target - L)))[:target]
        t0 = time.perf_counter()
        with torch.no_grad():
            xin = torch.from_numpy(np.ascontiguousarray(x[None], np.float32)).to(device)
            den = forward(params, xin.to(in_dtype), cfg).float().cpu().numpy()[0][:L]
        dt = time.perf_counter() - t0
        total_audio += L / args.sample_rate
        total_time += dt
        out_path = os.path.join(args.output, "enhanced_" + os.path.basename(path))
        write_wav(out_path, den, args.sample_rate)
        print(f"[{i+1}/{len(ds)}] {os.path.basename(path)} "
              f"({L/args.sample_rate:.1f}s in {dt*1e3:.0f}ms)")
    if total_time:
        print(f"offline throughput on {device}: {total_audio/total_time:.1f}x realtime "
              f"(first call included)")


if __name__ == "__main__":
    main()
