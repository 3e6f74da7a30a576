"""Activation telemetry accumulation for pruning importances (the port's
copy of ``cleanumamba_tpu/prune/telemetry.py``).

The reference collects per-channel mean/var/min/max through forward hooks
with count-weighted running updates (pruninggroup.py:88-158).  Here the
tap-collecting forward (models.cleanumamba.forward_with_telemetry) returns
per-batch variances (tensors on the model's device, brought to the host
here) and this accumulator keeps the running average, exposed as the
``act_var`` importance metric.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cleanumamba_tpu_torch.prune.importance import host_array


class TelemetryAccumulator:
    def __init__(self):
        self.var: Dict[str, np.ndarray] = {}
        self.count: Dict[str, int] = {}

    def update(self, taps: Dict[str, "np.ndarray"], n_samples: int = 1):
        for name, v in taps.items():
            v = host_array(v).astype(np.float64)
            if name in self.var:
                c = self.count[name]
                self.var[name] = (self.var[name] * c + v * n_samples) / (c + n_samples)
                self.count[name] = c + n_samples
            else:
                self.var[name] = v
                self.count[name] = n_samples

    def reset(self):
        self.var.clear()
        self.count.clear()

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dict(self.var)
