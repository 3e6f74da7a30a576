"""Linear-warmup + cosine-decay LR schedule (port of
``cleanumamba_tpu/train/schedule.py``).

Phase 1 anneals linearly from ``lr_max/divider`` to ``lr_max`` over
``warmup_proportion * n_iter`` steps; phase 2 anneals cosine from ``lr_max``
down to ``lr_min / 1e4``.  The reference's counter is incremented before it
is read, so optimizer step ``i`` (0-based) uses proportion ``(i+1)/phase_len``.

Two forms of one schedule: :func:`linear_warmup_cosine_decay` on the host
(a float, for logging), and :func:`linear_warmup_cosine_decay_fp32`, the
JAX schedule's arithmetic in fp32 on the step tensor's device, which the
optimizer reads, so that an update holds no host value.
"""

from __future__ import annotations

import math

import torch


def _phases(lr_max: float, n_iter: int, divider: float, warmup_proportion: float):
    phase1 = int(n_iter * warmup_proportion)
    lr_min = lr_max / divider
    return phase1, n_iter - phase1, lr_min, lr_min / 1e4


def linear_warmup_cosine_decay(lr_max: float, n_iter: int, divider: float = 25.0,
                               warmup_proportion: float = 0.05):
    """Returns schedule(step) -> lr as a float."""
    phase1, phase2, lr_min, lr_final = _phases(lr_max, n_iter, divider, warmup_proportion)

    def schedule(step) -> float:
        step = float(step)
        if step < phase1:
            p1 = min(max((step + 1.0) / max(phase1, 1), 0.0), 1.0)
            return lr_min + p1 * (lr_max - lr_min)
        p2 = min(max((step + 1.0 - phase1) / max(phase2, 1), 0.0), 1.0)
        return lr_final + (lr_max - lr_final) / 2.0 * (math.cos(math.pi * p2) + 1.0)

    return schedule


def linear_warmup_cosine_decay_fp32(lr_max: float, n_iter: int, divider: float = 25.0,
                                    warmup_proportion: float = 0.05):
    """Returns schedule(step) -> lr as a 0-d fp32 tensor on ``step``'s
    device, ``step`` a tensor (any int or float dtype): both phases computed
    and one picked, as the JAX schedule does in ``jnp.float32``."""
    phase1, phase2, lr_min, lr_final = _phases(lr_max, n_iter, divider, warmup_proportion)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        p1 = torch.clamp((step + 1.0) / max(phase1, 1), 0.0, 1.0)
        warm = lr_min + p1 * (lr_max - lr_min)
        p2 = torch.clamp((step + 1.0 - phase1) / max(phase2, 1), 0.0, 1.0)
        decay = lr_final + (lr_max - lr_final) / 2.0 * (torch.cos(math.pi * p2) + 1.0)
        return torch.where(step < phase1, warm, decay)

    return schedule
