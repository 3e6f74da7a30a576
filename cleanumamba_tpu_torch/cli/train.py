"""Training CLI of the port (port of ``cleanumamba_tpu/cli/train.py``).

    python -m cleanumamba_tpu_torch.cli.train -c configs/train_synth.json \
        -e <experiment.json> --synthetic [--max-iters N] [--device-data K] [--device D]
    torchrun --nproc-per-node N -m cleanumamba_tpu_torch.cli.train ...   # N ranks

Same flags and checkpoint layout as the JAX CLI: resumes from the newest
``{log_directory}/{exp_path}/checkpoint/{n}.pkl``, logs
``iter N: loss=... rec=... sc=... mag=... gnorm=...`` every ``--log-every``
iterations, validates every ``iters_per_valid`` (``eval.validate`` on
``valid_max_items`` utterances padded to the crop length), and saves every
``iters_per_ckpt`` and at the end.  Train and valid rows go to
``{log_directory}/{exp_path}/metrics.jsonl`` (``utils.MetricsLogger``) under
the run id that the checkpoints carry, so a resumed run appends to its own
record.  Runs on ``cuda:0`` unless ``--device`` names another device, and
raises where there is no CUDA device and none was named.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each rank is one process
on ``cuda:{LOCAL_RANK}`` (NCCL; ``--device cpu``: the CPU with gloo), and the
ranks train one model data-parallel, as JAX's CLI does over its devices: a
step takes ``batch_size_per_device x world`` items (times ``accum``) and the
gradients are averaged over the ranks.  Each rank draws its
``batch_size_per_device`` items from a loader of its own over its shard of
the training set, seeded by its rank (rank 0's is the one-process loader's
seed), as the reference's DistributedSampler did; so a run of N ranks sees
other items than one process, and every rank decodes only its own.  With
``--device-data K`` each rank makes its own batches on its device.  Rank 0
alone logs, validates (serially, as JAX does) and writes the checkpoints,
which keep the one-device layout; the others wait for it in the next
all-reduce, for at most ``GROUP_TIMEOUT``.

On a CUDA device without ``torchrun``, each step is one replay of a CUDA
graph (``trainer.graph_train_step``; with ``--device-data K``, K steps a
replay, ``trainer.make_device_data_steps``), over params and optimizer
state held in static buffers, which validation and the checkpoints read.
Under ``torchrun`` the steps run eagerly (the gloo and NCCL collectives are
not captured).

``--model-parallel M`` (M divides the world) shards the weights over M ranks
(``parallel/tensor.py``) and the other factor is the data axis (DP x TP, the
mesh of ``parallel.make_mesh``): a step takes ``batch_size_per_device x
world / M`` items.  Each model row's first rank holds the loader of its data
index (seed and shard) and broadcasts its batch to the row, so that the row
steps on one batch.  Checkpoints are banked in the canonical layout (the
shards gathered over the model group, ``tp_unprepare``, the moments through
``tp_opt_state_like``), so the JAX package and every other CLI read them; a
resume permutes them again.  ``--device-data`` and ``--model-parallel`` are
exclusive, as in JAX.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from cleanumamba_tpu_torch.config import load_experiment_config, load_train_config
from cleanumamba_tpu_torch.data import (
    CleanNoisyPairDataset,
    SyntheticDenoiseDataset,
    make_training_loader,
)
from cleanumamba_tpu_torch.eval.validate import validate
from cleanumamba_tpu_torch.models.cleanumamba import count_params, init_params
from cleanumamba_tpu_torch.parallel.mesh import make_mesh, replicated_sharding
from cleanumamba_tpu_torch.parallel.tensor import (
    make_tp_train_step,
    tp_gather,
    tp_opt_state_like,
    tp_prepare,
    tp_shard,
    tp_unprepare,
)
from cleanumamba_tpu_torch.params import resolve_device
from cleanumamba_tpu_torch.train.checkpoint import (
    find_max_epoch,
    load_checkpoint,
    save_checkpoint,
)
from cleanumamba_tpu_torch.train.optim import make_optimizer
from cleanumamba_tpu_torch.train.trainer import (
    graph_train_step,
    make_device_data_steps,
    make_train_step,
)
from cleanumamba_tpu_torch.utils import MetricsLogger

# How long a rank waits in a collective for the others: it covers rank 0's
# validation (the whole test set unless valid_max_items cuts it: P.862 and
# the other metrics run on the host, seconds an utterance) and checkpoint.
GROUP_TIMEOUT = datetime.timedelta(hours=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True, help="global config JSON")
    ap.add_argument("-e", "--exp", required=True, help="experiment JSON")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no DNS download needed)")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--device-data", type=int, default=0, metavar="K",
                    help="synthetic batches generated on the device, K train steps "
                         "per call (trainer.make_device_data_steps; implies --synthetic)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda:0; \"cpu\" for the CPU)")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="M",
                    help="shard weights over M ranks (Megatron-style TP, parallel/tensor.py); "
                         "the other ranks form the data axis.  Checkpoints are banked in the "
                         "canonical (one-device) layout, so TP runs interoperate with every "
                         "other CLI.")
    args = ap.parse_args(argv)
    if args.device_data:
        args.synthetic = True
        if args.log_every % args.device_data:
            ap.error("--log-every must be a multiple of --device-data")
        if args.model_parallel > 1:
            ap.error("--device-data and --model-parallel are exclusive")

    tc = load_train_config(args.config)
    network, cfg, raw_exp = load_experiment_config(args.exp)
    exp_path = raw_exp.get("exp_path", "exp")
    ckpt_dir = os.path.join(tc.log_directory, exp_path, "checkpoint")
    opt = tc.optimization
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    n_devices = int(os.environ["WORLD_SIZE"]) if launched else 1
    tp = args.model_parallel
    if tp < 1:
        ap.error(f"--model-parallel must be >= 1, got {tp}")
    if n_devices % tp:
        ap.error(f"--model-parallel {tp} does not divide {n_devices} devices")
    mesh = make_mesh(args.device, timeout=GROUP_TIMEOUT, model_parallel=tp) if launched else None
    world = 1 if mesh is None else mesh.world
    dp = world // tp
    lead = mesh is None or mesh.rank == 0  # the rank that logs, validates and saves
    say = print if lead else (lambda *a, **k: None)
    per_step_batch = opt.batch_size_per_device * dp
    accum = max(1, opt.batch_size_total // per_step_batch)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    say(f"model: {network} ({cfg.bottleneck}) | device: {dev} | ranks: {world} | "
        f"batch/step: {per_step_batch} x accum {accum}")

    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    say(f"params: {count_params(params)/1e6:.3f}M")
    optimizer = make_optimizer(opt)
    opt_state = optimizer.init(params)

    start_iter, run_id, t_prev = 0, None, 0.0
    ck_iter = find_max_epoch(ckpt_dir) if tc.ckpt_iter == "max" else int(tc.ckpt_iter)
    if ck_iter >= 0:
        ck = load_checkpoint(os.path.join(ckpt_dir, f"{ck_iter}.pkl"), dev)
        params = ck["params"]
        state = ck.get("opt_state")
        if isinstance(state, dict) and {"count", "mu", "nu"} <= state.keys():
            count = torch.tensor(int(state["count"]), dtype=torch.int32, device=dev)
            opt_state = {"count": count, "mu": state["mu"], "nu": state["nu"]}
        else:
            say("checkpoint has no optimizer state in this port's layout: fresh moments")
        start_iter = ck["iter"] + 1
        run_id = ck.get("run_id")
        t_prev = ck.get("training_time_seconds", 0.0)
        say(f"resumed from iter {ck['iter']}")
    if mesh is not None:  # every replica starts from rank 0's (the reference's broadcast)
        params, mu, nu = replicated_sharding(mesh, [params, opt_state["mu"], opt_state["nu"]])
        opt_state = {"count": opt_state["count"], "mu": mu, "nu": nu}

    sink = None
    if lead:
        sink = MetricsLogger.for_run(os.path.join(tc.log_directory, exp_path),
                                     run_id=run_id, config=raw_exp)
        run_id = sink.run_id

    max_iters = args.max_iters or opt.n_iters
    L = int(tc.crop_length_sec * tc.sample_rate)

    def bank(p, state):  # the canonical layout of (params, opt_state), on every rank
        return p, state

    if tp > 1:
        step_fn, params, opt_state, bank = _tensor_parallel(cfg, tc, mesh, params, opt_state)
        say(f"tensor parallel: weights over {tp} ranks"
            + (f" x data over {dp}" if dp > 1 else ""))
    else:
        step_fn = make_train_step(cfg, tc.loss, optimizer, bf16=opt.bf16, remat=opt.remat,
                                  mesh=mesh)
    stepper = loader = None
    if dev.type == "cuda" and mesh is None and not args.device_data:
        # one CUDA graph a step, over params and opt_state as static buffers
        step_fn = graph_train_step(step_fn, dev)
    if args.device_data:
        stepper = make_device_data_steps(step_fn, opt.batch_size_per_device, L,
                                         args.device_data, accum=accum, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(1234 + start_iter)
    if args.synthetic or not tc.data_root or not os.path.isdir(tc.data_root):
        if not args.synthetic:
            print(f"data root {tc.data_root!r} not found -> synthetic dataset")
        ds = SyntheticDenoiseDataset(crop_length_sec=tc.crop_length_sec,
                                     sample_rate=tc.sample_rate)
        val_ds = SyntheticDenoiseDataset(n_items=16, crop_length_sec=tc.crop_length_sec,
                                         sample_rate=tc.sample_rate, seed=1234)
    else:
        ds = CleanNoisyPairDataset(tc.data_root, "training", tc.crop_length_sec,
                                   tc.sample_rate, dataset=tc.dataset)
        val_ds = CleanNoisyPairDataset(tc.data_root, "testing", sample_rate=tc.sample_rate,
                                       dataset=tc.dataset)
    loader = None
    if stepper is None and (mesh is None or mesh.model_rank == 0):
        # data index d: shard d of the items, seed d, read by the row's first rank
        rank = 0 if mesh is None else mesh.data_rank
        loader = make_training_loader(ds, opt.batch_size_per_device * accum, seed=rank,
                                      num_shards=dp, shard_index=rank)

    n_iter = start_iter
    t0 = time.time() - t_prev
    stride = args.device_data or 1
    crossed = lambda every: (n_iter // every) > ((n_iter - stride) // every)  # noqa: E731
    while n_iter < max_iters:
        if stepper is not None:
            params, opt_state, aux = stepper(params, opt_state, gen)
            n_iter += stride - 1  # land on the last iteration of the call
        else:
            if loader is not None:
                both = torch.from_numpy(np.stack(next(loader))).to(dev, torch.float32)
            else:
                both = torch.empty(2, accum * opt.batch_size_per_device, L, device=dev)
            if tp > 1:  # the row steps on its first rank's batch
                dist.broadcast(both, mesh.data_rank * tp, group=mesh.model_group)
            shape = (accum, opt.batch_size_per_device, L)
            batch = both[0].reshape(shape), both[1].reshape(shape)
            params, opt_state, aux = step_fn(params, opt_state, batch)

        if lead and (crossed(args.log_every) or n_iter == start_iter):
            print(f"iter {n_iter}: loss={float(aux['loss']):.4f} "
                  f"rec={float(aux['reconstruct']):.4f} "
                  f"sc={float(aux.get('stft_sc', 0)):.4f} "
                  f"mag={float(aux.get('stft_mag', 0)):.4f} "
                  f"gnorm={float(aux['grad_norm']):.3f} ({time.time() - t0:.0f}s)", flush=True)
            sink.log({k: float(v) for k, v in aux.items()}, step=n_iter, kind="train")
        valid_now = crossed(tc.iters_per_valid) and n_iter >= tc.iters_per_valid
        ckpt_now = crossed(tc.iters_per_ckpt) and n_iter >= tc.iters_per_ckpt
        if valid_now or ckpt_now:
            banked = bank(params, opt_state)
        if lead and valid_now:
            metrics = validate(banked[0], cfg, val_ds, max_items=tc.valid_max_items, pad_to=L)
            print(f"iter {n_iter}: valid " + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()),
                  flush=True)
            sink.log(metrics, step=n_iter, kind="valid")
        if lead and ckpt_now:
            path = save_checkpoint(ckpt_dir, n_iter, *banked, cfg, run_id=run_id,
                                   training_time_seconds=time.time() - t0)
            print(f"saved {path}")
        n_iter += 1

    banked = bank(params, opt_state)
    if lead:
        path = save_checkpoint(ckpt_dir, n_iter - 1, *banked, cfg, run_id=run_id,
                               training_time_seconds=time.time() - t0)
        print(f"saved {path}")
        sink.close()
    if mesh is not None:
        dist.barrier(mesh.group)  # no rank leaves before the last checkpoint is written
        dist.destroy_process_group()


def _tensor_parallel(cfg, tc, mesh, params, opt_state):
    """(step, the rank's part of params and opt_state, bank) for
    ``--model-parallel``: the canonical state permuted to the TP layout and
    cut to the rank's shards; ``bank(params, opt_state)`` gathers them back
    to the canonical layout (a collective over the model group: every rank
    calls it)."""
    n, k = mesh.model_size, mesh.model_rank
    opt = tc.optimization
    make = make_tp_train_step(cfg, tc.loss, opt, mesh, bf16=opt.bf16, remat=opt.remat)
    specs = tp_prepare(params, cfg, n)[1]
    local, _, step = make(params)
    # the (resumed or fresh) canonical moments, permuted and cut like the params
    full = tp_opt_state_like(opt_state, params, cfg, n)
    state = {"count": full["count"], "mu": tp_shard(full["mu"], specs, n, k),
             "nu": tp_shard(full["nu"], specs, n, k)}

    def bank(p, s):
        full_p = tp_gather(mesh, p, specs)
        moments = {"count": s["count"], "mu": tp_gather(mesh, s["mu"], specs),
                   "nu": tp_gather(mesh, s["nu"], specs)}
        return (tp_unprepare(full_p, cfg, n),
                tp_opt_state_like(moments, full_p, cfg, n, inverse=True))

    return step, local, state, bank


if __name__ == "__main__":
    main()
