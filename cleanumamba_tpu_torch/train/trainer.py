"""The train step (port of ``cleanumamba_tpu/train/trainer.py``).

``make_train_step`` returns ``train_step(params, opt_state, (clean, noisy))``
with a leading accumulation axis on clean and noisy, as the JAX step has:
gradients averaged over the micro-batches, optional ``skip_nonfinite_updates``
and ``remat`` (``torch.utils.checkpoint``).  The params are the port's
pytree of fp32 master tensors; a step returns new trees and leaves its
inputs as they were.

Under ``bf16=True`` every fp32 leaf is cast to bf16 for the forward,
``A_log``, ``dt_proj_b`` and the norm scales included, and so is ``noisy``
(as the JAX step does; ``params.prepare_weight_view`` keeps some leaves
fp32 and is not used here).  The scan state and the loss stay fp32.

On a CUDA device :func:`graph_train_step` is the counterpart of
``jax.jit(train_step, donate_argnums=(0, 1))``: forward, backward (K1/K2),
clip and Adam captured as one CUDA graph per (accum, B, L) over static
param and optimizer-state buffers, replayed each step; and
:func:`make_device_data_steps` captures its K steps, batch synthesis
included, as one graph (JAX's jitted ``lax.scan``).  ``make_train_step``
stays the eager step (the counterpart of the unjitted callable), which is
what runs on the CPU and what the graphs capture.  A step with a ``mesh``
stays eager on a card too: its gloo all-reduces go through the host, which
a graph cannot hold.

Data parallelism: with ``mesh`` (``parallel.make_mesh``, one process per
device) the step averages the gradients and every aux scalar over the ranks
(``parallel.pmean``, the counterpart of JAX's ``pmean`` over ``axis_name``)
before clipping and Adam, so every rank applies the same update to its
replica; :func:`shard_train_step` hands each rank its slice of the global
batch.  This replaces the reference's NCCL DDP (rank-0 broadcast, gradient
all-reduce).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
from cleanumamba_tpu_torch.data.synth_device import synth_batch
from cleanumamba_tpu_torch.graphs import StepGraphs
from cleanumamba_tpu_torch.losses import loss_fn
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.parallel.mesh import Mesh, batch_sharding, pmean
from cleanumamba_tpu_torch.params import tensor_leaves, tree_leaves, tree_map, tree_unflatten
from cleanumamba_tpu_torch.train.optim import Optimizer, apply_updates, global_norm


def make_grad_fn(model_cfg: CleanUMambaConfig, loss_cfg: LossConfig, bf16: bool = True,
                 remat: bool = False) -> Callable:
    """Returns grad_fn(params, clean, noisy) -> (grads, aux).

    clean, noisy: (accum, B, L).  grads is a tree like params, fp32, the
    mean over the accum micro-batches of the gradient of each one's loss;
    aux holds the micro-batch means of ``loss`` and its parts (0-d tensors).
    """

    def fwd(p, noisy):
        return forward(p, noisy, model_cfg)

    def micro_loss(params, clean, noisy):
        p = params
        if bf16:
            p = tree_map(lambda x: x.to(torch.bfloat16) if isinstance(x, torch.Tensor)
                         and x.dtype == torch.float32 else x, params)
            noisy = noisy.to(torch.bfloat16)
        # the forward draws no random numbers: no RNG state to keep (which a
        # CUDA graph's capture could not read)
        denoised = (checkpoint(fwd, p, noisy, use_reentrant=False, preserve_rng_state=False)
                    if remat else fwd(p, noisy))
        return loss_fn(denoised.float(), clean.float(), loss_cfg)

    def grad_fn(params, clean, noisy):
        grads, auxs = None, []
        for c, n in zip(clean, noisy):
            leaf_params = tree_map(lambda x: x.detach().requires_grad_()
                                   if isinstance(x, torch.Tensor) else x, params)
            loss, aux = micro_loss(leaf_params, c, n)
            g = torch.autograd.grad(loss, tensor_leaves(leaf_params))
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            auxs.append({k: v.detach() for k, v in aux.items()})
        grads = tree_unflatten(params, [g / clean.shape[0] for g in grads])
        return grads, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

    return grad_fn


def make_train_step(model_cfg: CleanUMambaConfig, loss_cfg: LossConfig, optimizer: Optimizer,
                    bf16: bool = True, skip_nonfinite_updates: bool = False,
                    remat: bool = False, mesh: Optional[Mesh] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, aux).

    batch: (clean, noisy), each (accum, B, L) on the params' device.  aux is
    :func:`make_grad_fn`'s plus ``grad_norm`` (before clipping) and
    ``grads_finite``, as 0-d tensors.  With ``skip_nonfinite_updates`` a
    step whose gradient is not finite returns params and opt_state with the
    values they had, count included (``torch.where`` over every leaf, as
    JAX's ``jnp.where``: no host read).  With ``mesh`` the gradients and aux
    are means over the ranks' batches (one all-reduce per dtype of a flat
    buffer), taken after the division by accum.
    """
    grad_fn = make_grad_fn(model_cfg, loss_cfg, bf16=bf16, remat=remat)

    def train_step(params, opt_state, batch):
        grads, aux = grad_fn(params, *batch)
        if mesh is not None:
            keys = sorted(aux)
            g = tensor_leaves(grads)
            mean = pmean(mesh, g + [aux[k] for k in keys])
            grads = tree_unflatten(grads, mean[:len(g)])
            aux = dict(zip(keys, mean[len(g):]))
        aux["grad_norm"] = global_norm(tensor_leaves(grads))
        aux["grads_finite"] = torch.isfinite(aux["grad_norm"])
        updates, new_state = optimizer.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        if skip_nonfinite_updates:
            ok = aux["grads_finite"]
            new_params = _where(ok, new_params, params)
            new_state = _where(ok, new_state, opt_state)
        return new_params, new_state, aux

    return train_step


def _where(ok, new, old):
    """``new`` where ``ok`` (a 0-d bool tensor) else ``old``, leaf by leaf over
    two trees of one structure; an old leaf that is not a tensor (an int
    count) is taken as a value.  A non-tensor leaf of ``new`` is kept."""
    olds = iter(tree_leaves(old))

    def pick(n):
        o = next(olds)
        return torch.where(ok, n, o) if isinstance(n, torch.Tensor) else n

    return tree_map(pick, new)


def graph_train_step(train_step, device) -> Callable:
    """``train_step`` (from :func:`make_train_step` without a mesh) as a CUDA
    graph per (accum, B, L), run eagerly at a shape's first call, captured
    at its second and replayed after: the counterpart of
    ``jax.jit(train_step, donate_argnums=(0, 1))``.

    Returns ``step(params, opt_state, batch) -> (params, opt_state, aux)``.
    The first call adopts ``params`` and ``opt_state`` as the graphs' static
    buffers, and every call writes the new values into them (the returned
    trees are those buffers): a caller's earlier reference to a leaf sees
    the new values, as a donated JAX buffer is no longer the caller's.  A
    call given other trees copies their values in first (a resumed state).
    ``aux`` lives in the graph's memory until the next step.  ``batch`` is
    copied into the graph's input buffers.  The opt_state's ``count`` must
    be a tensor (``Optimizer.init`` makes one).  A capture that fails raises.
    """
    graphs = StepGraphs(device)

    def body(state, clean, noisy):
        params, opt_state, aux = train_step(state[0], state[1], (clean, noisy))
        return [params, opt_state], aux

    def step(params, opt_state, batch):
        (params, opt_state), aux = graphs("train_step", body, [params, opt_state], *batch)
        return params, opt_state, aux

    step.graphs = graphs
    return step


def make_device_data_steps(step_fn, batch: int, length: int, k_steps: int, accum: int = 1,
                           sr: int = 16000, snr=(0.0, 15.0),
                           mesh: Optional[Mesh] = None) -> Callable:
    """K train steps over batches synthesized on the params' device
    (``data/synth_device.synth_batch``), with no host data at all.

    Returns stepper(params, opt_state, generator) -> (params, opt_state,
    aux), aux from the last of the K steps; ``generator`` is a
    ``torch.Generator`` on the params' device, advanced by each batch.

    On a CUDA device without ``mesh`` the K steps, batch synthesis included,
    are one CUDA graph (the counterpart of the JAX stepper's jitted
    ``lax.scan``) with ``generator`` registered to it: the first call runs
    them eagerly, the second captures them, the later ones replay; params and opt_state are donated as in
    :func:`graph_train_step`, and every call must pass the generator of the
    first.  ``step_fn`` must then be the eager step of
    :func:`make_train_step` (without a mesh).  Elsewhere the K steps run
    eagerly.

    With ``mesh`` (``step_fn`` built with the same mesh) ``batch`` is each
    rank's local batch.  Every rank holds a generator seeded alike; for
    each step it draws one seed from it and makes its batch from a
    generator seeded with (that seed, its rank), the counterpart of JAX's
    ``fold_in(sub, axis_index)``: the ranks' batches differ, and no data
    moves between them.
    """

    def batch_generator(generator: torch.Generator) -> torch.Generator:
        if mesh is None:
            return generator
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
        return torch.Generator(device=generator.device).manual_seed(
            (seed * 1_000_003 + mesh.rank) % 2 ** 63)

    def steps(params, opt_state, generator: torch.Generator):
        aux = None
        shape = (accum, batch, length)
        for _ in range(k_steps):
            clean, noisy = synth_batch(batch_generator(generator), batch * accum, length, sr,
                                       float(snr[0]), float(snr[1]))
            params, opt_state, aux = step_fn(params, opt_state,
                                             (clean.reshape(shape), noisy.reshape(shape)))
        return params, opt_state, aux

    def stepper(params, opt_state, generator: torch.Generator):
        if mesh is not None or generator.device.type != "cuda":
            return steps(params, opt_state, generator)
        if stepper.graphs is None:
            stepper.graphs = StepGraphs(generator.device, generator)
        elif stepper.graphs.generator is not generator:
            raise ValueError("make_device_data_steps: the graph holds the generator of its "
                             "first call; pass that one")

        def body(state):
            params, opt_state, aux = steps(state[0], state[1], generator)
            return [params, opt_state], aux

        (params, opt_state), aux = stepper.graphs("device_data_steps", body,
                                                  [params, opt_state])
        return params, opt_state, aux

    stepper.graphs = None  # the StepGraphs of the first call on a card
    return stepper


def shard_train_step(train_step, mesh: Mesh) -> Callable:
    """Data-parallel step: the global batch (clean, noisy), each
    (accum, B_total, L), goes in on every rank, and each rank steps on its
    slice of axis 1 (B_total / world items).  ``train_step`` must be built
    with ``make_train_step(..., mesh=mesh)`` so that the gradients are
    averaged inside it."""

    def sharded(params, opt_state, batch):
        clean, noisy = batch
        return train_step(params, opt_state, (batch_sharding(mesh, clean, 1),
                                              batch_sharding(mesh, noisy, 1)))

    return sharded


@dataclasses.dataclass
class TrainState:
    """Checkpointable training state (the reference checkpoint's fields)."""

    step: int
    params: Any
    opt_state: Any
    run_id: Optional[str] = None
    training_time_seconds: float = 0.0
