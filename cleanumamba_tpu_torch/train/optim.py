"""The optimizer chain of ``cleanumamba_tpu/train/trainer.py::make_optimizer``,
on the port's parameter pytree.

In order, as optax chains it:

1. clip by global norm: g * max_norm / ||g|| when ||g|| >= max_norm (no
   epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
2. ``adam``: weight decay added to the gradient (L2, as torch Adam does);
3. Adam moments with bias correction, update mu_hat / (sqrt(nu_hat) + eps);
4. ``adamw``: decoupled decay added to the update, on leaves of ndim >= 2 only;
5. times -schedule(k) for update k (0-based).

The state is a plain pytree ``{"count": int, "mu": tree, "nu": tree}`` with
the params' structure (a non-tensor leaf, such as an S4 kernel's
``l_kernel``, is carried as it is and never updated);
:func:`cleanumamba_tpu_torch.params.to_numpy` makes it picklable.  A step that :func:`make_train_step` skips leaves it as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cleanumamba_tpu_torch.config import OptimizationConfig
from cleanumamba_tpu_torch.params import tensor_leaves, tree_map, tree_unflatten
from cleanumamba_tpu_torch.train.schedule import linear_warmup_cosine_decay


def global_norm(leaves):
    """sqrt of the sum of squares of every element of every leaf (fp32)."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax-style: ``init(params) -> state``; ``update(grads, state, params)
    -> (updates, state)``; :func:`apply_updates` adds the updates."""

    schedule: Callable[[int], float]
    optimizer: str = "adam"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 10.0
    weight_decay: float = 0.0

    def init(self, params):
        zeros = lambda p: (torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                           if isinstance(p, torch.Tensor) else p)
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(self, grads, state, params):
        g = [x.float() for x in tensor_leaves(grads)]
        p = tensor_leaves(params)
        norm = global_norm(g)
        clip = norm >= self.clip_norm  # optax: identity below the limit
        g = [torch.where(clip, x / norm * self.clip_norm, x) for x in g]
        wd = self.weight_decay
        if self.optimizer == "adam":
            if wd:
                g = [x + wd * w for x, w in zip(g, p)]
        elif self.optimizer != "adamw":
            raise ValueError(self.optimizer)
        count = int(state["count"]) + 1
        mu = [(1 - self.b1) * x + self.b1 * m for x, m in zip(g, tensor_leaves(state["mu"]))]
        nu = [(1 - self.b2) * x.square() + self.b2 * v
              for x, v in zip(g, tensor_leaves(state["nu"]))]
        c1, c2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        upd = [(m / c1) / (torch.sqrt(v / c2) + self.eps) for m, v in zip(mu, nu)]
        if self.optimizer == "adamw" and wd:
            upd = [u + wd * w if w.ndim >= 2 else u for u, w in zip(upd, p)]
        lr = self.schedule(count - 1)
        upd = [-lr * u for u in upd]
        new_state = {"count": count, "mu": tree_unflatten(params, mu),
                     "nu": tree_unflatten(params, nu)}
        return tree_unflatten(params, upd), new_state


def apply_updates(params, updates):
    """params + updates, leaf by leaf, in each param's dtype."""
    return tree_unflatten(params, [(w + u).to(w.dtype)
                                   for w, u in zip(tensor_leaves(params), tensor_leaves(updates))])


def make_optimizer(opt_cfg: OptimizationConfig, schedule=None) -> Optimizer:
    """The chain of ``make_optimizer`` from an OptimizationConfig; the
    schedule defaults to the warm-up cosine over ``n_iters``."""
    if opt_cfg.optimizer not in ("adam", "adamw"):
        raise ValueError(opt_cfg.optimizer)
    if schedule is None:
        schedule = linear_warmup_cosine_decay(opt_cfg.learning_rate, opt_cfg.n_iters)
    b1, b2 = opt_cfg.betas
    return Optimizer(schedule=schedule, optimizer=opt_cfg.optimizer, b1=b1, b2=b2,
                     eps=opt_cfg.eps, clip_norm=opt_cfg.clip_grad_norm_max,
                     weight_decay=opt_cfg.weight_decay)
