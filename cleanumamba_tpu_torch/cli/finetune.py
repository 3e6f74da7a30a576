"""Finetuning CLI for (pruned) checkpoints (port of
``cleanumamba_tpu/cli/finetune.py``; the reference's
src/training/train_finetune.py): load a ragged checkpoint, fresh Adam +
warmup-cosine, the same bf16 train step, loss and validation as
``cli/train.py``.

    python -m cleanumamba_tpu_torch.cli.finetune --ckpt <pkl> --synthetic \
        [--iters N] [--device-data K] [--out DIR] [--device D]

Validates every 1,000 iterations, logs train and valid rows to
``metrics.jsonl`` beside ``--out``, and saves ``{out}/{iters - 1}.pkl``.
Runs on ``cuda:0`` unless ``--device`` names another device.  On a card
the train step is a CUDA graph over params and Adam state as static
buffers (``trainer.graph_train_step``, the counterpart of the JAX CLI's
``jax.jit(raw_step, donate_argnums=(0, 1))``); ``--device-data K`` makes
the K steps one graph instead.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig, load_train_config
from cleanumamba_tpu_torch.data import (
    CleanNoisyPairDataset,
    SyntheticDenoiseDataset,
    make_loader,
)
from cleanumamba_tpu_torch.eval.validate import validate
from cleanumamba_tpu_torch.models.cleanumamba import count_params
from cleanumamba_tpu_torch.params import resolve_device
from cleanumamba_tpu_torch.train.checkpoint import save_checkpoint
from cleanumamba_tpu_torch.train.optim import make_optimizer
from cleanumamba_tpu_torch.train.trainer import (
    graph_train_step,
    make_device_data_steps,
    make_train_step,
)
from cleanumamba_tpu_torch.utils import MetricsLogger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="(pruned) checkpoint to finetune")
    ap.add_argument("-c", "--config", default=None, help="global config JSON")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--dataset", default="dns", choices=["dns", "VCTK-DEMAND"])
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--iters", type=int, default=10_000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--crop-sec", type=float, default=10.0)
    ap.add_argument("--out", default="./exp/finetune/checkpoint")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--device-data", type=int, default=0, metavar="K",
                    help="K train steps per call on batches synthesized on the device "
                         "(train.trainer.make_device_data_steps); implies --synthetic")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)
    if args.device_data:
        if args.data_root:
            ap.error("--device-data trains on device-synthesized batches; "
                     "it cannot be combined with --data-root")
        args.synthetic = True
        if args.log_every % args.device_data:
            ap.error("--log-every must be a multiple of --device-data")
        if args.iters % args.device_data:
            # one call advances K iters at a time: a non-multiple would
            # overshoot the LR schedule and mislabel the checkpoint
            ap.error("--iters must be a multiple of --device-data")
    device = resolve_device(args.device)

    cfg, params, _ = load_any_checkpoint(args.ckpt, device)
    print(f"finetuning {count_params(params)/1e6:.3f}M params ({cfg.bottleneck})")

    loss_cfg = load_train_config(args.config).loss if args.config else LossConfig()
    opt_cfg = OptimizationConfig(n_iters=args.iters, learning_rate=args.lr)
    optimizer = make_optimizer(opt_cfg)
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, loss_cfg, optimizer, bf16=opt_cfg.bf16)
    stepper = None
    if args.device_data:
        L0 = int(args.crop_sec * 16000)
        stepper = make_device_data_steps(step, args.batch_size, L0, args.device_data)
    elif device.type == "cuda":
        step = graph_train_step(step, device)

    if args.synthetic or not args.data_root:
        ds = SyntheticDenoiseDataset(crop_length_sec=args.crop_sec)
        val_ds = SyntheticDenoiseDataset(n_items=8, crop_length_sec=args.crop_sec, seed=99)
    else:
        ds = CleanNoisyPairDataset(args.data_root, "training", args.crop_sec,
                                   dataset=args.dataset)
        val_ds = CleanNoisyPairDataset(args.data_root, "testing",
                                       dataset=args.dataset)
    loader = make_loader(ds, args.batch_size)

    sink = MetricsLogger.for_run(os.path.dirname(args.out.rstrip("/")) or args.out,
                                 config={"ckpt": args.ckpt, "lr": args.lr})
    L = int(args.crop_sec * 16000)
    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(4321)
    stride = args.device_data or 1
    crossed = lambda it, every: (it // every) > ((it - stride) // every)  # noqa: E731
    n_iter = 0
    while n_iter < args.iters:
        if stepper is not None:
            params, opt_state, aux = stepper(params, opt_state, gen)
            n_iter += stride - 1  # land on the last iteration of the call
        else:
            clean, noisy = next(loader)
            batch = (torch.from_numpy(clean[None]).to(device),
                     torch.from_numpy(noisy[None]).to(device))
            params, opt_state, aux = step(params, opt_state, batch)
        if crossed(n_iter, args.log_every):
            print(f"iter {n_iter}: loss={float(aux['loss']):.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
            sink.log({k: float(v) for k, v in aux.items()}, step=n_iter,
                     kind="train")
        if crossed(n_iter, 1000) and n_iter >= 1000:
            metrics = validate(params, cfg, val_ds, max_items=4, pad_to=L)
            print("valid " + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()),
                  flush=True)
            sink.log(metrics, step=n_iter, kind="valid")
        n_iter += 1
    save_checkpoint(args.out, args.iters - 1, params, opt_state, cfg,
                    run_id=sink.run_id, training_time_seconds=time.time() - t0)
    sink.close()
    print(f"saved to {args.out}")


if __name__ == "__main__":
    main()
