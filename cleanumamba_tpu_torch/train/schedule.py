"""Linear-warmup + cosine-decay LR schedule (port of
``cleanumamba_tpu/train/schedule.py``).

Phase 1 anneals linearly from ``lr_max/divider`` to ``lr_max`` over
``warmup_proportion * n_iter`` steps; phase 2 anneals cosine from ``lr_max``
down to ``lr_min / 1e4``.  The reference's counter is incremented before it
is read, so optimizer step ``i`` (0-based) uses proportion ``(i+1)/phase_len``.
"""

from __future__ import annotations

import math


def linear_warmup_cosine_decay(lr_max: float, n_iter: int, divider: float = 25.0,
                               warmup_proportion: float = 0.05):
    """Returns schedule(step) -> lr as a float."""
    phase1 = int(n_iter * warmup_proportion)
    phase2 = n_iter - phase1
    lr_min = lr_max / divider
    lr_final = lr_min / 1e4

    def schedule(step) -> float:
        step = float(step)
        if step < phase1:
            p1 = min(max((step + 1.0) / max(phase1, 1), 0.0), 1.0)
            return lr_min + p1 * (lr_max - lr_min)
        p2 = min(max((step + 1.0 - phase1) / max(phase2, 1), 0.0), 1.0)
        return lr_final + (lr_max - lr_final) / 2.0 * (math.cos(math.pi * p2) + 1.0)

    return schedule
