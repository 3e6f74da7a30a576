"""Importance-calibration experiment CLI (port of
``cleanumamba_tpu/cli/calibrate.py``; the reference's
src/pruning/layerwise_calibration.py:161-276 harness): measure how well each
importance metric predicts the real loss change of pruning, per group, and
optionally render the log-log scatter.

    python -m cleanumamba_tpu_torch.cli.calibrate [--ckpt <pkl>] [--n-batches N] \
        [--sample-size S] [--out DIR] [--plot PNG] [--device D]

Writes one ``calibration_experiment`` row per probe to
``{out}/metrics.jsonl``.  The forward and the gradient run on ``cuda:0``
unless ``--device`` names another device; ``--plot`` needs matplotlib.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, STFTLossConfig
from cleanumamba_tpu_torch.data import SyntheticDenoiseDataset
from cleanumamba_tpu_torch.losses import loss_fn
from cleanumamba_tpu_torch.models.cleanumamba import forward, init_params
from cleanumamba_tpu_torch.params import resolve_device
from cleanumamba_tpu_torch.prune.calibrate import (
    importance_loss_experiment,
    scatter_importance_loss,
)
from cleanumamba_tpu_torch.prune.groups import build_groups
from cleanumamba_tpu_torch.train.trainer import make_grad_fn
from cleanumamba_tpu_torch.utils import MetricsLogger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None, help="checkpoint (default: fresh init)")
    ap.add_argument("--n-batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--crop-sec", type=float, default=2.0)
    ap.add_argument("--sample-size", type=int, default=6)
    ap.add_argument("--n-remove", type=int, default=4)
    ap.add_argument("--out", default="./exp/calibration")
    ap.add_argument("--plot", default=None, help="write scatter PNG here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.ckpt:
        cfg, params, _ = load_any_checkpoint(args.ckpt, device)
    else:
        cfg = CleanUMambaConfig()
        params = init_params(cfg, torch.Generator().manual_seed(0), device)

    loss_cfg = LossConfig(
        stft_config=STFTLossConfig(fft_sizes=(512,), hop_sizes=(50,), win_lengths=(240,))
    )
    ds = SyntheticDenoiseDataset(n_items=args.n_batches * args.batch_size,
                                 crop_length_sec=args.crop_sec, seed=42)
    batches = []
    for b in range(args.n_batches):
        items = [ds[b * args.batch_size + i] for i in range(args.batch_size)]
        clean = torch.from_numpy(np.stack([c for c, _ in items])).to(device)
        noisy = torch.from_numpy(np.stack([n for _, n in items])).to(device)
        batches.append((clean, noisy))

    def loss_sampler(p):
        with torch.no_grad():
            return float(np.mean([
                float(loss_fn(forward(p, n, cfg), c, loss_cfg)[0]) for c, n in batches
            ]))

    # gradient sample for the taylor metrics (fixed first batch), fp32
    clean0, noisy0 = batches[0]
    grads, _ = make_grad_fn(cfg, loss_cfg, bf16=False)(params, clean0[None], noisy0[None])
    groups = build_groups(params, cfg)
    sink = MetricsLogger.for_run(args.out)
    results = importance_loss_experiment(
        params, cfg, grads, groups, loss_sampler,
        sample_size=args.sample_size, n_remove=args.n_remove, sink=sink,
    )
    sink.close()
    print(f"{len(results)} probes -> {args.out}/metrics.jsonl")
    if args.plot:
        print("scatter:", scatter_importance_loss(results, out_path=args.plot))


if __name__ == "__main__":
    main()
