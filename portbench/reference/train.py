"""The plain reference of a training step: the model's forward
(``model.forward``, products at ``precision``), the L1 + multi-resolution
STFT loss, the gradient by autograd, clipping by the global norm (no
epsilon; identity below the limit), Adam with bias correction and the
reference's learning rate: linear warm-up from lr / 25 over the first 5 %
of ``n_iters``, then a cosine to lr / 25e4.  fp32 master weights.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import model as ref
from portbench.weights import leaf_paths


def learning_rate(step: int, opt: dict) -> float:
    """The rate of update ``step`` (0-based)."""
    lr_max, n = opt["learning_rate"], opt["n_iters"]
    phase1 = int(n * 0.05)
    lr_min = lr_max / 25.0
    if step < phase1:
        return lr_min + min(max((step + 1) / max(phase1, 1), 0.0), 1.0) * (lr_max - lr_min)
    p2 = min(max((step + 1 - phase1) / max(n - phase1, 1), 0.0), 1.0)
    return lr_min / 1e4 + (lr_max - lr_min / 1e4) / 2 * (math.cos(math.pi * p2) + 1)


def _tree(params, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(params)


def steps(params0, batches, geom: dict, loss_cfg: dict, opt: dict, precision: str = "fp32"):
    """Follow ``len(batches)`` steps from ``params0`` (not written).  Each batch
    is (clean, noisy), (B, L).  Returns (losses, first-step gradient norm of
    each leaf after clipping, each leaf's change norm after the last step)."""
    m = ref.Prec(precision)
    w0 = [t.detach().float() for _, t in leaf_paths(params0)]
    w = [t.clone() for t in w0]
    mu = [torch.zeros_like(t) for t in w]
    nu = [torch.zeros_like(t) for t in w]
    b1, b2 = opt["betas"]
    losses, g_norms = [], None
    for k, (clean, noisy) in enumerate(batches):
        leaves = [t.clone().requires_grad_() for t in w]
        y = ref.forward(_tree(params0, leaves), noisy, geom, m, grad_chunks=True)
        loss = ref.loss(y, clean.float(), loss_cfg)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        if norm >= opt["clip_grad_norm_max"]:
            grads = [g / norm * opt["clip_grad_norm_max"] for g in grads]
        if k == 0:
            g_norms = torch.stack([g.norm() for g in grads]).cpu()
        lr = learning_rate(k, opt)
        c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
        for i, g in enumerate(grads):
            g = g + opt["weight_decay"] * w[i] if opt["weight_decay"] else g
            mu[i] = b1 * mu[i] + (1 - b1) * g
            nu[i] = b2 * nu[i] + (1 - b2) * g * g
            w[i] = w[i] - lr * (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + opt["eps"])
        del leaves, y, loss, grads
    d_norms = torch.stack([(a - b).norm() for a, b in zip(w, w0)]).cpu()
    return losses, g_norms, d_norms
