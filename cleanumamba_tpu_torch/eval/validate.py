"""Validation loop over a paired test set (port of
``cleanumamba_tpu/eval/validate.py``; the reference's denoise_eval.py:22-117).

Runs the offline forward on each utterance on the params' device, converts
to the int16 scale before the metrics (the reference's quirk,
denoise_eval.py:99-100: PESQ/STOI are computed on int16-scaled arrays), and
accumulates *length-weighted* metric means (:111-115).  The metrics are the
host numpy suite of ``eval/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.eval.metrics import eval_waveform
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.params import tensor_leaves


def validate(
    params,
    cfg: CleanUMambaConfig,
    dataset,
    max_items: Optional[int] = None,
    pad_to: Optional[int] = None,
    verbose: bool = False,
) -> Dict[str, float]:
    """Length-weighted mean metrics over (clean, noisy) pairs.

    pad_to: pad or crop every utterance to this length before the forward
    (the metrics see the first min(len, pad_to) samples).  It changes the
    result, through the input normalisation's statistics, as in the JAX
    package.  Metrics that are None or not finite are left out of their
    mean.  A mamba_s4 model's kernels must already cover the length
    (``prepare_for_length``): this function does not extend them.
    """
    device = tensor_leaves(params)[0].device
    totals: Dict[str, float] = {}
    weight_sum = 0.0
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    for i in range(n):
        clean, noisy = dataset[i][0], dataset[i][1]
        L = len(noisy)
        x = noisy
        if pad_to is not None:
            if L < pad_to:
                x = np.pad(noisy, (0, pad_to - L))
            else:
                x = noisy[:pad_to]
                L = pad_to
        with torch.no_grad():
            xin = torch.from_numpy(np.asarray(x[None], np.float32)).to(device)
            den = forward(params, xin, cfg).float().cpu().numpy()[0][:L]
        # int16 scaling before metrics (reference denoise_eval.py:99-100)
        c16 = np.clip(clean[:L] * 32768.0, -32768, 32767)
        d16 = np.clip(den * 32768.0, -32768, 32767)
        metrics = eval_waveform(c16, d16)
        w = float(L)
        for k, v in metrics.items():
            if v is None or not np.isfinite(v):
                continue
            totals[k] = totals.get(k, 0.0) + v * w
        weight_sum += w
        if verbose:
            print(f"[{i+1}/{n}] " + " ".join(
                f"{k}={v:.3f}" for k, v in metrics.items() if v is not None
            ))
    return {k: v / weight_sum for k, v in totals.items()}
