"""The optimizer chain of ``cleanumamba_tpu/train/trainer.py::make_optimizer``,
on the port's parameter pytree.

In order, as optax chains it:

1. clip by global norm: g * max_norm / ||g|| when ||g|| >= max_norm (no
   epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
2. ``adam``: weight decay added to the gradient (L2, as torch Adam does);
3. Adam moments with bias correction, update mu_hat / (sqrt(nu_hat) + eps);
4. ``adamw``: decoupled decay added to the update, on leaves of ndim >= 2 only;
5. times -schedule(k) for update k (0-based).

Each stage runs as ``torch._foreach_*`` ops over the leaves (a few
multi-tensor launches a stage on a card, where a loop over the leaves made
several launches a leaf), with the arithmetic and order per leaf of the
loop it replaced: ``x / norm * max_norm`` for a clipped leaf (and ``x / 1 *
1`` for one that is not, which is exact), the decay as ``wd * w`` added, the
moments as ``(1 - b) * g + b * m``.  The global norm is the sum over the
leaves, in order, of each leaf's sum of squares.

The state is a plain pytree ``{"count": tensor, "mu": tree, "nu": tree}``
with the params' structure (a non-tensor leaf, such as an S4 kernel's
``l_kernel``, is carried as it is and never updated).  ``count`` is a 0-d
int32 tensor on the params' device (an int, as a checkpoint holds it, is
taken too), and the learning rate is the schedule of ``count - 1``, so an
update reads no host value and can be captured in a CUDA graph.
:func:`cleanumamba_tpu_torch.params.to_numpy` makes the state picklable.  A
step that :func:`make_train_step` skips leaves it as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cleanumamba_tpu_torch.config import OptimizationConfig
from cleanumamba_tpu_torch.params import tensor_leaves, tree_map, tree_unflatten
from cleanumamba_tpu_torch.train.schedule import linear_warmup_cosine_decay_fp32


def global_norm(leaves):
    """sqrt of the sum of squares of every element of every leaf (fp32)."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax-style: ``init(params) -> state``; ``update(grads, state, params)
    -> (updates, state)``; :func:`apply_updates` adds the updates.
    ``schedule(step)``: the learning rate of update ``step`` (0-based, a
    0-d int32 tensor), as a tensor or a float."""

    schedule: Callable
    optimizer: str = "adam"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 10.0
    weight_decay: float = 0.0

    def init(self, params):
        zeros = lambda p: (torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                           if isinstance(p, torch.Tensor) else p)
        device = tensor_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(self, grads, state, params):
        g = [x.float() for x in tensor_leaves(grads)]
        p = tensor_leaves(params)
        norm = global_norm(g)
        clip = norm >= self.clip_norm  # optax: identity below the limit
        one = torch.ones_like(norm)
        g = torch._foreach_mul(torch._foreach_div(g, torch.where(clip, norm, one)),
                               torch.where(clip, self.clip_norm * one, one))
        wd = self.weight_decay
        if self.optimizer == "adam":
            if wd:
                g = torch._foreach_add(g, torch._foreach_mul(p, wd))
        elif self.optimizer != "adamw":
            raise ValueError(self.optimizer)
        count = torch.as_tensor(state["count"], dtype=torch.int32, device=norm.device) + 1
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(tensor_leaves(state["mu"]), self.b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(tensor_leaves(state["nu"]), self.b2))
        c1, c2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
        if self.optimizer == "adamw" and wd:
            decayed = [i for i, w in enumerate(p) if w.ndim >= 2]
            if decayed:
                part = [upd[i] for i in decayed]
                torch._foreach_add_(part, torch._foreach_mul([p[i] for i in decayed], wd))
        lr = self.schedule(count - 1)
        upd = torch._foreach_mul(upd, -lr)
        new_state = {"count": count, "mu": tree_unflatten(params, mu),
                     "nu": tree_unflatten(params, nu)}
        return tree_unflatten(params, upd), new_state


def apply_updates(params, updates):
    """params + updates, leaf by leaf, in each param's dtype."""
    w = tensor_leaves(params)
    return tree_unflatten(params, [x.to(p.dtype) for x, p in
                                   zip(torch._foreach_add(w, tensor_leaves(updates)), w)])


def make_optimizer(opt_cfg: OptimizationConfig, schedule=None) -> Optimizer:
    """The chain of ``make_optimizer`` from an OptimizationConfig; the
    schedule defaults to the warm-up cosine over ``n_iters``, in fp32 on the
    device (``schedule.linear_warmup_cosine_decay_fp32``)."""
    if opt_cfg.optimizer not in ("adam", "adamw"):
        raise ValueError(opt_cfg.optimizer)
    if schedule is None:
        schedule = linear_warmup_cosine_decay_fp32(opt_cfg.learning_rate, opt_cfg.n_iters)
    b1, b2 = opt_cfg.betas
    return Optimizer(schedule=schedule, optimizer=opt_cfg.optimizer, b1=b1, b2=b2,
                     eps=opt_cfg.eps, clip_norm=opt_cfg.clip_grad_norm_max,
                     weight_decay=opt_cfg.weight_decay)
