"""Knowledge distillation over skip connections (port of
``cleanumamba_tpu/train/distill.py``).

The reference's loss supports KD (util.py:215-327: student skip -> 1x1
projection + batch norm, teacher skip -> batch norm, log(sum |diff|^4) per
connection, after Miles & Mikolajczyk 2023), but its student-teacher training loop
is not shipped; the JAX package supplies the adapters and a KD train step,
and so does this module.  There is no KD CLI in either package.  On a card
:func:`graph_kd_step` replays the step as a CUDA graph, as the JAX
package's callers jit it with the trainable state donated.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
from cleanumamba_tpu_torch.graphs import StepGraphs
from cleanumamba_tpu_torch.losses import loss_fn
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.params import resolve_device, tensor_leaves, tree_map, tree_unflatten
from cleanumamba_tpu_torch.train.optim import Optimizer, apply_updates


def skip_widths(cfg: CleanUMambaConfig) -> List[int]:
    """Channel widths of the skip activations of ``forward(...,
    return_skips=True)``: the encoder outputs deepest first, then the
    bottleneck output (``tsfm_d_model``).  Read from the config, as JAX does."""
    return cfg.encoder_widths()[::-1] + [cfg.tsfm_d_model]


def make_kd_adapters(generator: torch.Generator, student_cfg: CleanUMambaConfig,
                     teacher_cfg: CleanUMambaConfig, dtype=torch.float32, device=None):
    """One adapter per skip connection: the student's 1x1 projection to the
    teacher's width (``embed_w`` uniform in +-1/sqrt(student width), zero
    ``embed_b``) and a batch-norm affine per side (unit scale, zero bias).
    ``generator`` is a CPU generator; ``device`` None means the default
    device (``params.default_device``)."""
    device = resolve_device(device)
    s_w, t_w = skip_widths(student_cfg), skip_widths(teacher_cfg)
    if len(s_w) != len(t_w):
        raise ValueError(f"student has {len(s_w)} skip connections, teacher {len(t_w)}")
    adapters = []
    for sw, tw in zip(s_w, t_w):
        bound = 1.0 / math.sqrt(sw)
        w = torch.rand((sw, tw), generator=generator, dtype=torch.float32) * (2 * bound) - bound
        ones = torch.ones(tw, dtype=dtype, device=device)
        zeros = torch.zeros(tw, dtype=dtype, device=device)
        adapters.append({"embed_w": w.to(device=device, dtype=dtype), "embed_b": zeros.clone(),
                         "bn_s": {"scale": ones.clone(), "bias": zeros.clone()},
                         "bn_t": {"scale": ones.clone(), "bias": zeros.clone()}})
    return adapters


def make_kd_grad_fn(student_cfg: CleanUMambaConfig, teacher_cfg: CleanUMambaConfig,
                    loss_cfg: LossConfig, bf16: bool = False):
    """Returns grad_fn(params, adapters, teacher_params, (clean, noisy)) ->
    ((grad params, grad adapters), aux): the gradient of the KD loss with
    respect to the pair (student params, adapters).  clean, noisy: (B, L).

    Under ``bf16`` only the student's fp32 params are cast to bf16, as in
    the JAX step: ``noisy`` stays fp32 (the student computes in fp32 with
    bf16-rounded weights), and the teacher runs in fp32.  The teacher runs
    under ``torch.no_grad()`` (JAX's ``stop_gradient``); each skip pair is
    cropped to the shorter length.
    """

    def grad_fn(params, adapters, teacher_params, batch):
        clean, noisy = batch
        trainable = (params, adapters)
        leaf = tree_map(lambda x: x.detach().requires_grad_()
                        if isinstance(x, torch.Tensor) else x, trainable)
        p, ad = leaf
        if bf16:
            p = tree_map(lambda x: x.to(torch.bfloat16) if isinstance(x, torch.Tensor)
                         and x.dtype == torch.float32 else x, p)
        denoised, skips = forward(p, noisy, student_cfg, return_skips=True)
        with torch.no_grad():
            _, teacher_skips = forward(teacher_params, noisy, teacher_cfg, return_skips=True)
        n = [min(s.shape[1], t.shape[1]) for s, t in zip(skips, teacher_skips)]
        loss, aux = loss_fn(denoised.float(), clean.float(), loss_cfg,
                            skips=[s[:, :k].float() for s, k in zip(skips, n)],
                            teacher_skips=[t[:, :k].float() for t, k in zip(teacher_skips, n)],
                            kd_adapters=ad)
        grads = torch.autograd.grad(loss, tensor_leaves(leaf))
        return tree_unflatten(trainable, grads), {k: v.detach() for k, v in aux.items()}

    return grad_fn


def make_kd_train_step(student_cfg: CleanUMambaConfig, teacher_cfg: CleanUMambaConfig,
                       loss_cfg: LossConfig, optimizer: Optimizer, bf16: bool = False):
    """Returns step(params, adapters, opt_state, teacher_params, (clean,
    noisy)) -> (params, adapters, opt_state, aux): one update of the pair
    (student params, adapters) against the frozen teacher, with
    :func:`make_kd_grad_fn`'s gradient.  ``opt_state`` is
    ``optimizer.init((params, adapters))``.
    """
    grad_fn = make_kd_grad_fn(student_cfg, teacher_cfg, loss_cfg, bf16=bf16)

    def step(params, adapters, opt_state, teacher_params, batch):
        trainable = (params, adapters)
        grads, aux = grad_fn(params, adapters, teacher_params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        params, adapters = apply_updates(trainable, updates)
        return params, adapters, opt_state, aux

    return step


def graph_kd_step(step, device) -> Callable:
    """``step`` (from :func:`make_kd_train_step`) as a CUDA graph per (B, L),
    run eagerly at a shape's first call, captured at its second and replayed
    after: the counterpart of ``jax.jit(step, donate_argnums=(0, 1, 2))``.

    Returns ``kd_step(params, adapters, opt_state, teacher_params, batch) ->
    (params, adapters, opt_state, aux)``.  The trainable state is donated as
    in ``trainer.graph_train_step``: the first call adopts the three trees
    as the graphs' static buffers and every call writes the new values into
    them (the returned trees are those buffers); a call given other trees
    copies their values in first.  The frozen teacher is read in place: the
    graphs read the tensors of the first call's ``teacher_params`` (an
    in-place change to them is seen), and a call with a teacher tree of
    other tensors raises.  ``aux`` lives in the graph's memory until the
    next step; ``batch`` is copied into the graph's inputs.  On the CPU
    ``step`` runs as it is, on the same checks.
    """
    graphs = StepGraphs(device) if torch.device(device).type == "cuda" else None
    frozen = []  # the first call's teacher tree and its tensor leaves

    def body(state, clean, noisy):
        params, adapters, opt_state, aux = step(state[0], state[1], state[2], frozen[0],
                                                (clean, noisy))
        return [params, adapters, opt_state], aux

    def kd_step(params, adapters, opt_state, teacher_params, batch):
        leaves = tensor_leaves(teacher_params)
        if not frozen:
            frozen.extend((teacher_params, leaves))
        elif len(leaves) != len(frozen[1]) or any(a is not b for a, b in zip(leaves, frozen[1])):
            raise ValueError("graph_kd_step: the graphs read the teacher of the first call in "
                             "place; pass that tree (change its tensors in place to update it)")
        state = [params, adapters, opt_state]
        if graphs is None:
            state, aux = body(state, *batch)
        else:
            state, aux = graphs("kd_step", body, state, *batch)
        return state[0], state[1], state[2], aux

    kd_step.graphs = graphs
    return kd_step
