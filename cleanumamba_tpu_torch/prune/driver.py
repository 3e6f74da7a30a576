"""Iterative prune-train driver (port of ``cleanumamba_tpu/prune/driver.py``).

Reference: src/training/pruning.py:18-227 with the phase machine of
pruning/util.py get_state (:255-306): per macro-step, repeat
``pruning_repeats`` times [accumulate grads over ``pruning_grad_samples``
samples -> prune], then train ``training_samples * pruning_repeats`` samples,
and loop; early-stop on quality (STOI < threshold) or channel floor
(< min_total_channels).  Checkpoints carry the (ragged) param pytree, in the
payload both packages read.

``PruningConfig`` and ``get_state`` are copies.  ``pruning_pipeline`` runs
the JAX package's loop on the port's tree: the gradient is an fp32 forward
and loss (``train/trainer.make_grad_fn`` with ``bf16=False``), accumulated
in fp32, and the optimizer is the port's ``Optimizer`` with the chain of
the JAX driver (clip by global norm, Adam with optax's defaults, a
constant ``lr / lr_divider``).  Every tensor of the loop stays on the
params' device; pruning makes new tensors, and the loop keeps no reference
to the trees of the width before.  On a card the gradient is a CUDA graph
per width (``graphs.ForwardGraphs``, the counterpart of the JAX driver's
``jax.jit(jax.value_and_grad(loss_of))``, which recompiles at every width):
a width's first gradient runs eagerly, its second is captured, the later
ones replay, and each prune event drops the old width's graphs and their
memory before the new trees come.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
from cleanumamba_tpu_torch.graphs import ForwardGraphs
from cleanumamba_tpu_torch.models.cleanumamba import count_params
from cleanumamba_tpu_torch.params import tensor_leaves, tree_map, tree_unflatten
from cleanumamba_tpu_torch.prune.calibrate import Calibrator
from cleanumamba_tpu_torch.prune.groups import build_groups
from cleanumamba_tpu_torch.prune.importance import get_prune_channels
from cleanumamba_tpu_torch.prune.pruner import apply_pruning
from cleanumamba_tpu_torch.train.checkpoint import save_checkpoint
from cleanumamba_tpu_torch.train.optim import Optimizer, apply_updates
from cleanumamba_tpu_torch.train.trainer import make_grad_fn


@dataclasses.dataclass
class PruningConfig:
    """Mirror of the reference pruning_config JSON
    (configs/exp/pruning/DNS-CleanUMamba-Pruning12.json)."""

    training_samples: int = 8192
    pruning_grad_samples: int = 128
    pruning_repeats: int = 5
    prune_steps: int = 2840
    steps_per_valid: int = 10
    steps_per_ckpt: int = 60
    n_prune_channels_per_iter: Optional[int] = None
    perc_prune_channels_per_iter: float = 0.005
    max_prune_importance_per_iter: Optional[float] = 3e-13
    min_prune_channels_per_iter: int = 4
    min_channels_per_group: int = 8
    clip_grad_norm_max: float = 10.0
    lr: float = 1e-4
    lr_divider: float = 10.0
    importance_metric: str = "taylor_squared_individual*n_filters/n_parameters"
    calibration: bool = True
    steps_per_calibration: int = 20
    calibration_ema: float = 0.5
    # stopping rules (reference pruning.py:220-226)
    stoi_stop: float = 0.9
    min_total_channels: int = 1000


def get_state(n_iter, batch_size, training_samples, grad_samples, pruning_repeats,
              steps_per_valid, steps_per_ckpt, steps_per_calibrate):
    """Phase machine (value-parity with reference pruning/util.py:255-306).

    Fails fast on mis-phased configs (reference :266-269): every phase length
    must land on a batch boundary or the accumulate/prune/train cadence drifts.
    """
    if training_samples % batch_size != 0:
        raise ValueError(
            f"training_samples ({training_samples}) must be a multiple of "
            f"batch_size ({batch_size})")
    if grad_samples % batch_size != 0:
        raise ValueError(
            f"pruning_grad_samples ({grad_samples}) must be a multiple of "
            f"batch_size ({batch_size})")
    if steps_per_valid % pruning_repeats != 0:
        raise ValueError(
            f"steps_per_valid ({steps_per_valid}) must be a multiple of "
            f"pruning_repeats ({pruning_repeats})")
    iters_per_step = (grad_samples + training_samples) * pruning_repeats // batch_size
    step = n_iter // iters_per_step
    folded = n_iter % iters_per_step
    prune_step = step * pruning_repeats + min(
        folded // (grad_samples // batch_size), pruning_repeats - 1
    )
    pruning = folded < grad_samples * pruning_repeats // batch_size
    go_prune = pruning and folded % (grad_samples // batch_size) == (grad_samples // batch_size) - 1
    training_done = folded == iters_per_step - 1
    # cumulative sample counters (reference :283-290) — consumed by logging.
    if pruning:
        prune_samples = prune_step * grad_samples + folded * batch_size % grad_samples
    else:
        prune_samples = prune_step * grad_samples + grad_samples
    train_samples = (
        (prune_step // pruning_repeats) * training_samples * pruning_repeats
        + max(0, folded * batch_size - grad_samples * pruning_repeats)
    )
    return {
        "pruning": pruning,
        "training": not pruning,
        "go_prune": go_prune,
        "training_done": training_done,
        "valid": prune_step % steps_per_valid == steps_per_valid - 1 and (go_prune or training_done),
        "ckpt": prune_step % steps_per_ckpt == steps_per_ckpt - 1 and training_done,
        "calibrate": prune_step % steps_per_calibrate == 0 and folded == 0,
        "prune_step": prune_step,
        "prune_samples": prune_samples,
        "train_samples": train_samples,
    }


def make_loss_and_grad(cfg: CleanUMambaConfig, loss_cfg: LossConfig) -> Callable:
    """``loss_and_grad(params, clean, noisy) -> (loss, grads)``: the fp32 loss
    of one (B, L) batch and its gradient, the pipeline's ``jax.value_and_grad``
    of the JAX driver's ``loss_of``."""
    grad_fn = make_grad_fn(cfg, loss_cfg, bf16=False)

    def loss_and_grad(p, clean, noisy):
        grads, aux = grad_fn(p, clean[None], noisy[None])
        return aux["loss"], grads

    return loss_and_grad


def pruning_pipeline(
    params,
    cfg: CleanUMambaConfig,
    loss_cfg: LossConfig,
    data_iter: Iterator,
    prune_cfg: PruningConfig,
    batch_size: int,
    ckpt_dir: Optional[str] = None,
    validate_fn: Optional[Callable] = None,
    log_fn: Optional[Callable[[dict], None]] = None,
    max_iters: Optional[int] = None,
    start_iter: int = 0,
    opt_state=None,
    log_every: Optional[int] = None,
    log_macs: bool = False,
    run_id: Optional[str] = None,
):
    """Run the prune-train loop.  data_iter yields (clean, noisy) numpy
    batches of ``batch_size``, moved to the params' device.  Returns
    ``(params, opt_state, history, stopped)``, the final (pruned) params.

    Resume: pass ``start_iter`` (the checkpointed ``n_iter + 1``) and the
    checkpointed ``opt_state`` (the port's ``{"count", "mu", "nu"}``);
    checkpoints land on training_done boundaries so the gradient accumulator
    is legitimately empty there (reference pruning/util.py load_state
    :215-253).  ``log_every`` emits periodic training-loss records through
    ``log_fn``.  ``log_macs=True`` raises: the JAX package counts the MACs
    from XLA's cost analysis of a compiled function, which has no
    counterpart here (``utils.py``).  The JAX function's ``bf16`` argument,
    which it never reads, is not taken: the gradient is fp32.

    As in the JAX package, the calibrator runs only when a macro step's
    first iteration finds gradients accumulated, which the phase machine
    never leaves there (they are emptied at each prune): ``calibration``
    changes nothing in a run, and ``calibration_scales`` stays empty.
    """
    if log_macs:
        raise ValueError("log_macs: the MAC count of a compiled function (XLA's cost analysis) "
                         "has no counterpart in this port")
    device = tensor_leaves(params)[0].device
    loss_and_grad = make_loss_and_grad(cfg, loss_cfg)
    # the loop's gradient: its outputs live in the graphs' pool until the next
    # call, so every branch sums or applies them first
    grad_step = ForwardGraphs(loss_and_grad, device)

    lr = prune_cfg.lr / prune_cfg.lr_divider
    optimizer = Optimizer(schedule=lambda s: lr, clip_norm=prune_cfg.clip_grad_norm_max)
    if opt_state is None:
        opt_state = optimizer.init(params)
    calibrator = Calibrator(ema_factor=prune_cfg.calibration_ema)
    zero_grads = lambda p: tree_map(  # noqa: E731
        lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else x, p)
    grads_acc = zero_grads(params)
    grad_batches = 0
    history = []
    n_iter = start_iter
    t0 = time.time()
    stopped = None

    while stopped is None:
        if max_iters is not None and n_iter >= max_iters:
            break
        state = get_state(
            n_iter, batch_size, prune_cfg.training_samples,
            prune_cfg.pruning_grad_samples, prune_cfg.pruning_repeats,
            prune_cfg.steps_per_valid, prune_cfg.steps_per_ckpt,
            prune_cfg.steps_per_calibration,
        )
        if state["prune_step"] >= prune_cfg.prune_steps:
            stopped = "prune_steps"
            break

        clean, noisy = next(data_iter)
        clean = torch.as_tensor(clean, dtype=torch.float32).to(device)
        noisy = torch.as_tensor(noisy, dtype=torch.float32).to(device)

        if state["calibrate"] and prune_cfg.calibration and grad_batches > 0:
            groups = build_groups(params, cfg)
            fixed = (clean, noisy)

            def loss_sampler(p):
                v, _ = loss_and_grad(p, *fixed)
                return v

            scales = calibrator.gather(
                params, cfg, _normalize(grads_acc, grad_batches), groups,
                loss_sampler, prune_cfg.importance_metric,
            )
            if log_fn:
                # persist calibration scales (reference
                # layerwise_calibration.py:46-55 logs these to wandb)
                log_fn({"kind": "calibration", "n_iter": n_iter,
                        "prune_step": state["prune_step"],
                        "scales": {k: float(v) for k, v in scales.items()}})

        if state["pruning"]:
            loss, grads = grad_step(params, clean, noisy)
            grads_acc = tree_unflatten(grads_acc, [
                a + g for a, g in zip(tensor_leaves(grads_acc), tensor_leaves(grads))])
            del grads
            grad_batches += 1

            if state["go_prune"]:
                groups = build_groups(params, cfg)
                selection, pruned_params, imp_min = get_prune_channels(
                    groups, params, _normalize(grads_acc, grad_batches),
                    prune_cfg.importance_metric,
                    n_prune_channels=prune_cfg.n_prune_channels_per_iter,
                    perc_prune_channels_per_iter=prune_cfg.perc_prune_channels_per_iter,
                    min_channels_per_group=prune_cfg.min_channels_per_group,
                    max_prune_importance_per_iter=prune_cfg.max_prune_importance_per_iter,
                    min_prune_channels=prune_cfg.min_prune_channels_per_iter,
                    calibration_scales=calibrator.as_dict() if prune_cfg.calibration else None,
                )
                loss = float(loss)  # read before the graphs' pool goes
                # the old widths' accumulator and graphs go before the new trees come
                grads_acc = None
                grad_step.reset()
                params, _, opt_state = apply_pruning(
                    params, selection, cfg, opt_state=opt_state
                )
                grads_acc = zero_grads(params)
                grad_batches = 0
                n_ch = sum(g.n_channels for g in build_groups(params, cfg))
                rec = {
                    "kind": "prune",
                    "prune_step": state["prune_step"],
                    "n_iter": n_iter,
                    "prune_samples": state["prune_samples"],
                    "train_samples": state["train_samples"],
                    "loss": loss,
                    "params": count_params(params),
                    "channels": n_ch,
                    "min_importance": (
                        min(imp_min.values()) if imp_min else None),
                    "pruned": {k: len(v) for k, v in selection.items()},
                }
                history.append(rec)
                if log_fn:
                    log_fn(rec)
                if n_ch < prune_cfg.min_total_channels:
                    stopped = "channel_floor"
        else:
            loss, grads = grad_step(params, clean, noisy)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            del grads
            params = apply_updates(params, updates)
            if log_fn and log_every and n_iter % log_every == 0:
                log_fn({"kind": "train", "n_iter": n_iter,
                        "prune_step": state["prune_step"],
                        "train_samples": state["train_samples"],
                        "loss": float(loss),
                        "lr": lr})

        if state["valid"] and validate_fn is not None:
            metrics = validate_fn(params)
            if log_fn:
                log_fn({"kind": "valid", "n_iter": n_iter, **metrics})
            if metrics.get("stoi", 1.0) < prune_cfg.stoi_stop:
                stopped = "stoi_floor"

        if state["ckpt"] and ckpt_dir:
            save_checkpoint(
                ckpt_dir, n_iter, params, opt_state, cfg, run_id=run_id,
                training_time_seconds=time.time() - t0,
                extra={"prune_step": state["prune_step"]},
            )

        n_iter += 1

    return params, opt_state, history, stopped


def _normalize(grads_acc, n):
    return tree_map(lambda g: g / max(n, 1) if isinstance(g, torch.Tensor) else g, grads_acc)
