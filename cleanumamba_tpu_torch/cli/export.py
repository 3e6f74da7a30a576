"""Export a checkpoint's computations as a serving bundle (port of
``cleanumamba_tpu/cli/export.py``).

Traces the offline forward and the streaming prime/step with
``torch.export`` (``export.py``) so that a serving process runs them
without this package's model code.

    python -m cleanumamba_tpu_torch.cli.export --ckpt <pkl> --out <dir> \
        [--length 160000] [--block 1] [--batch 1] [--selftest] [--device D]

The functions are traced on ``cuda:0`` unless ``--device`` names another
device (``cpu`` for the CPU), and the bundle runs on that device.
``--selftest`` reloads the bundle and asserts that the loaded offline and
prime outputs equal the live eager calls exactly.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cleanumamba_tpu_torch import export as ex
from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.models.cleanumamba import count_params, forward, prepare_for_length
from cleanumamba_tpu_torch.params import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True, help="bundle directory to write")
    ap.add_argument("--length", type=int, default=160000,
                    help="offline forward input length (samples)")
    ap.add_argument("--block", type=int, default=1,
                    help="streaming step granularity in frames")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--selftest", action="store_true",
                    help="reload the bundle and compare against live calls")
    ap.add_argument("--device", default=None,
                    help="torch device to trace on and serve from (default: cuda:0; "
                         "\"cpu\" for the CPU)")
    args = ap.parse_args(argv)
    if args.block < 1 or args.batch < 1 or args.length < 1:
        ap.error("--block/--batch/--length must be >= 1")
    device = resolve_device(args.device)

    cfg, params, _ = load_any_checkpoint(args.ckpt, device)
    L = cfg.valid_length(args.length)
    params = prepare_for_length(params, cfg, max(2 * L, 2 * cfg.frame_length))
    print(f"exporting {count_params(params)/1e6:.3f}M params ({cfg.bottleneck}) on {device}: "
          f"offline L={L}, stream block={args.block}, batch={args.batch}")

    t0 = time.time()
    offline = ex.export_offline(params, cfg, L, batch=args.batch)
    prime, step = ex.export_stream(params, cfg, batch=args.batch, block=args.block)
    # batch/block land in the bundle schema (save_bundle derives them from
    # the traced shapes)
    ex.save_bundle(args.out, cfg, {"offline": offline, "prime": prime, "step": step},
                   extra_meta={"length": L, "ckpt": args.ckpt})
    print(f"wrote {args.out} in {time.time() - t0:.1f}s (device {device})")

    if args.selftest:
        from cleanumamba_tpu_torch.streaming import stream_prime

        cfg2, fns = ex.load_bundle(args.out)
        if cfg2 != cfg:
            raise RuntimeError("selftest: the bundle's config differs from the checkpoint's")
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(args.batch, L)).astype(np.float32) * 0.1)
        x = x.to(device)
        f0 = x[:, : cfg.frame_length]
        with torch.no_grad():
            y_live = forward(params, x, cfg)
            _, out_d = stream_prime(params, cfg, f0)
            y_loaded = fns["offline"](params, x)
            st_l, out_l = fns["prime"](params, f0)
            new = x[:, cfg.frame_length: cfg.frame_length + args.block * cfg.total_stride]
            _, step_out = fns["step"](params, st_l, new)
        err = (y_loaded - y_live).abs().max().item()
        perr = (out_l - out_d).abs().max().item()
        print(f"selftest offline max|err| = {err:.3g}")
        print(f"selftest prime   max|err| = {perr:.3g}")
        print(f"selftest step    out shape {tuple(step_out.shape)} "
              f"finite={bool(torch.isfinite(step_out).all())}")
        if not (err == 0.0 and perr == 0.0):
            raise RuntimeError("selftest: the loaded bundle deviates from the live calls")
        print("selftest OK")


if __name__ == "__main__":
    main()
