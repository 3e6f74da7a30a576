"""Pruning CLI of the port (port of ``cleanumamba_tpu/cli/prune.py``; the
reference's src/training/pruning.py:250-289).

    python -m cleanumamba_tpu_torch.cli.prune -t <teacher ckpt> \
        -e configs/prune_2m_synth.json [--synthetic] [--max-iters N] [--device D]

Reads the teacher in either checkpoint format (``cli.denoise.
load_any_checkpoint``), or resumes from the newest checkpoint in
``{out}/{exp_path}/checkpoint`` under its run id, so the metrics JSONL
(``{out}/{exp_path}/metrics.jsonl``) keeps one trajectory.  Validates every
``steps_per_valid`` prune steps and always saves the final pruned params.
Runs on ``cuda:0`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os

from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.config import LossConfig
from cleanumamba_tpu_torch.data import CleanNoisyPairDataset, SyntheticDenoiseDataset, make_loader
from cleanumamba_tpu_torch.eval.validate import validate
from cleanumamba_tpu_torch.models.cleanumamba import count_params
from cleanumamba_tpu_torch.params import resolve_device
from cleanumamba_tpu_torch.prune.driver import PruningConfig, pruning_pipeline
from cleanumamba_tpu_torch.train.checkpoint import load_latest, save_checkpoint
from cleanumamba_tpu_torch.utils import MetricsLogger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--teacher", required=True, help="checkpoint to prune")
    ap.add_argument("-e", "--exp", required=True, help="pruning experiment JSON")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--dataset", default="dns", choices=["dns", "VCTK-DEMAND"])
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--crop-sec", type=float, default=10.0)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--out", default="./exp")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; \"cpu\" for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with open(args.exp) as f:
        raw = json.load(f)
    pc_raw = raw.get("pruning_config", {})
    known = {f.name for f in PruningConfig.__dataclass_fields__.values()}
    pcfg = PruningConfig(**{k: v for k, v in pc_raw.items() if k in known})

    exp_dir = os.path.join(args.out, raw.get("exp_path", "pruning"))
    ckpt_dir = os.path.join(exp_dir, "checkpoint")

    # resume: pick up the latest pruning checkpoint (same run_id so the
    # metrics JSONL keeps appending to one trajectory); the teacher pickle
    # is only loaded/converted when starting fresh
    start_iter = 0
    opt_state = None
    ck = load_latest(ckpt_dir, device)
    run_id = None
    if ck is not None:
        cfg = ck["config"]
        params = ck["params"]
        state = ck.get("opt_state")
        if isinstance(state, dict) and {"count", "mu", "nu"} <= state.keys():
            opt_state = {"count": int(state["count"]), "mu": state["mu"], "nu": state["nu"]}
        else:
            print("checkpoint has no optimizer state in this port's layout: fresh moments")
        start_iter = ck["iter"] + 1
        run_id = ck.get("run_id")
        print(f"resumed pruning from iter {ck['iter']} "
              f"({count_params(params)/1e6:.3f}M params)")
    else:
        cfg, params, _ = load_any_checkpoint(args.teacher, device)
        print(f"teacher: {count_params(params)/1e6:.3f}M params ({cfg.bottleneck})")

    sink = MetricsLogger.for_run(exp_dir, run_id=run_id, config=pc_raw)
    run_id = sink.run_id

    if args.synthetic or not args.data_root:
        ds = SyntheticDenoiseDataset(crop_length_sec=args.crop_sec)
        val_ds = SyntheticDenoiseDataset(n_items=8, crop_length_sec=args.crop_sec, seed=77)
    else:
        ds = CleanNoisyPairDataset(args.data_root, "training", args.crop_sec,
                                   dataset=args.dataset)
        val_ds = CleanNoisyPairDataset(args.data_root, "testing",
                                       dataset=args.dataset)

    loader = make_loader(ds, args.batch_size)

    def validate_fn(p):
        return validate(p, cfg, val_ds, max_items=4,
                        pad_to=int(args.crop_sec * 16000))

    def log_fn(rec):
        print(json.dumps({k: v for k, v in rec.items()}), flush=True)
        rec = dict(rec)
        kind = rec.pop("kind", "prune")
        sink.log(rec, step=rec.get("n_iter"), kind=kind)

    params, opt_state, history, stopped = pruning_pipeline(
        params, cfg, LossConfig(), loader, pcfg,
        batch_size=args.batch_size, ckpt_dir=ckpt_dir,
        validate_fn=validate_fn, log_fn=log_fn, max_iters=args.max_iters,
        start_iter=start_iter, opt_state=opt_state, log_every=50,
        run_id=run_id,
    )
    sink.log({"stopped": stopped, "final_params": count_params(params)},
             kind="summary")
    sink.close()
    # always bank the FINAL pruned params: stop conditions (prune_steps,
    # stoi_stop, min_total_channels) usually fire inside a pruning phase,
    # between the training_done boundaries the periodic checkpoints land on
    # — without this the last prune events exist only in memory
    last = history[-1]["n_iter"] if history else start_iter
    path = save_checkpoint(ckpt_dir, last, params, opt_state,
                           cfg, run_id=run_id)
    print(f"stopped: {stopped} | final params {count_params(params)/1e6:.3f}M "
          f"| saved {path}")


if __name__ == "__main__":
    main()
