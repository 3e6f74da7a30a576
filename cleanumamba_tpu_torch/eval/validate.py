"""Validation loop over a paired test set (port of
``cleanumamba_tpu/eval/validate.py``; the reference's denoise_eval.py:22-117).

Runs the offline forward on each utterance on the params' device, converts
to the int16 scale before the metrics (the reference's quirk,
denoise_eval.py:99-100: PESQ/STOI are computed on int16-scaled arrays), and
accumulates *length-weighted* metric means (:111-115).  The metrics are the
host numpy suite of ``eval/metrics.py``.  On a card the forward is a CUDA
graph per utterance length (``graphs.ForwardGraphs``, the counterpart of
JAX's ``jax.jit(forward)``; with ``pad_to`` the first utterance runs
eagerly, the second is captured, the rest replay).  With a data mesh
(``parallel.make_mesh``) the forwards are spread over the ranks
(:func:`_validate_sharded`), eagerly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.eval.metrics import eval_waveform
from cleanumamba_tpu_torch.graphs import ForwardGraphs
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.parallel.mesh import Mesh
from cleanumamba_tpu_torch.params import tensor_leaves


def validate(
    params,
    cfg: CleanUMambaConfig,
    dataset,
    max_items: Optional[int] = None,
    pad_to: Optional[int] = None,
    verbose: bool = False,
    mesh: Optional[Mesh] = None,
) -> Dict[str, float]:
    """Length-weighted mean metrics over (clean, noisy) pairs.

    pad_to: pad or crop every utterance to this length before the forward
    (the metrics see the first min(len, pad_to) samples).  It changes the
    result, through the input normalisation's statistics, as in the JAX
    package.  Metrics that are None or not finite are left out of their
    mean.  A mamba_s4 model's kernels must already cover the length
    (``prepare_for_length``): this function does not extend them.
    mesh: a 1-D data mesh: the utterances are spread over its ranks
    (requires pad_to); every rank returns the same means.
    """
    if mesh is not None:
        if pad_to is None:
            raise ValueError("sharded validation needs fixed lengths (pad_to)")
        return _validate_sharded(params, cfg, dataset, max_items, pad_to, verbose, mesh)
    fwd = ForwardGraphs(lambda p, x: forward(p, x, cfg), tensor_leaves(params)[0].device)
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
        with torch.no_grad():  # the output is read before the next replay
            xin = torch.from_numpy(np.asarray(x[None], np.float32))
            den = fwd(params, xin).float().cpu().numpy()[0][:L]
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


def _validate_sharded(params, cfg, dataset, max_items, pad_to, verbose, mesh: Mesh):
    """Utterances in groups of ``world``, the last group padded by repeating
    its last item; rank r runs the forward of item s + r of each group, the
    outputs are gathered, and every rank sums the metrics on the host in
    JAX's order with JAX's length weights."""
    device = tensor_leaves(params)[0].device
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    items = []
    for i in range(n):
        clean, noisy = dataset[i][0], dataset[i][1]
        L = min(len(noisy), pad_to)
        items.append((np.pad(clean[:L], (0, pad_to - L)),
                      np.pad(noisy[:L], (0, pad_to - L)), L))
    totals: Dict[str, float] = {}
    weight_sum = 0.0
    for s in range(0, len(items), mesh.world):
        chunk = items[s: s + mesh.world]
        real = len(chunk)
        while len(chunk) < mesh.world:  # pad the final group
            chunk = chunk + [chunk[-1]]
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(chunk[mesh.rank][1][None], np.float32)).to(device)
            mine = forward(params, x, cfg).float()
            den = [torch.empty_like(mine) for _ in range(mesh.world)]
            dist.all_gather(den, mine, group=mesh.group)
        for k in range(real):
            clean, _, L = chunk[k]
            c16 = np.clip(clean[:L] * 32768.0, -32768, 32767)
            d16 = np.clip(den[k].cpu().numpy()[0][:L] * 32768.0, -32768, 32767)
            metrics = eval_waveform(c16, d16)
            for key, v in metrics.items():
                if v is None or not np.isfinite(v):
                    continue
                totals[key] = totals.get(key, 0.0) + v * float(L)
            weight_sum += float(L)
            if verbose and mesh.rank == 0:
                print(f"[{s + k + 1}/{n}] " + " ".join(
                    f"{key}={v:.3f}" for key, v in metrics.items() if v is not None))
    return {k: v / weight_sum for k, v in totals.items()}
