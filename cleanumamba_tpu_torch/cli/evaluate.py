"""Evaluation CLI (port of ``cleanumamba_tpu/cli/evaluate.py``; the
reference's python_eval.py standalone DNS eval and denoise_eval.py
test_validation): the full metric suite over a paired test set, printed as
length-weighted means.

    python -m cleanumamba_tpu_torch.cli.evaluate --ckpt <pkl> --synthetic \
        [--max-items N] [--pad-to-sec S] [--json] [--device D]

Reads either checkpoint format (``cli.denoise.load_any_checkpoint``).  The
forward runs on ``cuda:0`` unless ``--device`` names another device; the
metrics run on the host.
"""

from __future__ import annotations

import argparse
import json

from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.data import CleanNoisyPairDataset, SyntheticDenoiseDataset
from cleanumamba_tpu_torch.eval.validate import validate
from cleanumamba_tpu_torch.params import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data-root", default=None,
                    help="DNS-style root (datasets/test_set/synthetic/no_reverb)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--dataset", default="dns", choices=["dns", "VCTK-DEMAND"])
    ap.add_argument("--max-items", type=int, default=None)
    ap.add_argument("--pad-to-sec", type=float, default=10.0)
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)

    cfg, params, _ = load_any_checkpoint(args.ckpt, resolve_device(args.device))
    if args.synthetic or not args.data_root:
        ds = SyntheticDenoiseDataset(n_items=args.max_items or 16, seed=4242)
    else:
        ds = CleanNoisyPairDataset(args.data_root, "testing", dataset=args.dataset)
    metrics = validate(
        params, cfg, ds, max_items=args.max_items,
        pad_to=int(args.pad_to_sec * 16000), verbose=not args.json,
    )
    if args.json:
        print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    else:
        print("== length-weighted means ==")
        for k, v in metrics.items():
            print(f"  {k}: {v:.4f}")


if __name__ == "__main__":
    main()
