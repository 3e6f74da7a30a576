"""Channel importance computation + global prune-channel selection (the
port's copy of ``cleanumamba_tpu/prune/importance.py``: the same numpy
float32 arithmetic on the host; each leaf reaches numpy through
:func:`host_array`, from any device and dtype).

Parity with the reference (pruninggroup.py:160-226, :365-394;
importance.py:4-135): per-slice metrics weight/grad/taylor_* are summed over
each channel's parameters and averaged across a group's slices; a string
expression (e.g. ``"taylor_squared_individual*n_filters/n_parameters"``)
combines them; selection picks the globally least-important channels under a
count budget, an optional total-importance budget, a per-group channel floor,
and the constraint that each d_inner group is pruned in multiples of 8
(importance.py:107-120).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from cleanumamba_tpu_torch.prune.groups import PruneGroup, Slice, get_path


def host_array(x) -> np.ndarray:
    """A leaf as a numpy array on the host: a tensor (on any device, in any
    float type) as C-ordered float32, as ``np.asarray`` gives a JAX array
    (numpy's sums run in another order over other strides); anything else
    through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().contiguous().cpu().numpy()
    return np.asarray(x)


def _channel_view(leaf: np.ndarray, s: Slice, n_channels: int) -> np.ndarray:
    """(n_channels, params_per_channel) view of a slice, grouping head rows
    {offset + h*n + c} into channel c."""
    x = np.moveaxis(host_array(leaf), s.axis, 0)
    x = x[s.offset : s.offset + s.n_heads * n_channels]
    x = x.reshape(s.n_heads, n_channels, -1)
    return np.moveaxis(x, 1, 0).reshape(n_channels, -1)


def group_importances(
    params,
    group: PruneGroup,
    grads=None,
    telemetry: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, Optional[np.ndarray]]:
    """Reference metric set (pruninggroup.py:365-394)."""
    metrics = [
        "weight",
        "grad",
        "taylor_individual",
        "taylor_squared_individual",
        "taylor_group",
        "act_var",
    ]
    out: Dict[str, Optional[np.ndarray]] = {m: None for m in metrics}
    counts = {m: 0 for m in metrics}
    n_parameters = 0
    n_filters = 0

    def accumulate(metric, value):
        if out[metric] is None:
            out[metric] = value
        else:
            out[metric] = (out[metric] * counts[metric] + value) / (counts[metric] + 1)
        counts[metric] += 1

    for s in group.slices:
        if not s.importance:
            continue
        w = _channel_view(get_path(params, s.path), s, group.n_channels)
        accumulate("weight", np.sum(np.abs(w) ** 2, axis=1))
        if grads is not None:
            g = _channel_view(get_path(grads, s.path), s, group.n_channels)
            accumulate("grad", np.sum(np.abs(g) ** 2, axis=1))
            accumulate("taylor_individual", np.sum(np.abs(w * g), axis=1))
            accumulate("taylor_squared_individual", np.sum((w * g) ** 2, axis=1))
            accumulate("taylor_group", np.abs(np.sum(w * g, axis=1)))
        n_parameters += w.shape[1] * s.n_heads
        n_filters += 1
        if telemetry is not None and s.telemetry_tap in telemetry:
            var = host_array(telemetry[s.telemetry_tap])
            if len(var) == group.n_channels * s.n_heads:
                var = var.reshape(s.n_heads, group.n_channels).mean(axis=0)
            accumulate("act_var", var)

    out["n_parameters"] = n_parameters
    out["n_filters"] = n_filters
    return out


def calc_importance(importances: dict, importance_metric: str):
    """String-expression metric calculator (reference importance.py:4-37):
    supports + - * / ** over metric names and float literals."""
    m = importance_metric
    if "+" in m:
        return sum(calc_importance(importances, p) for p in m.split("+"))
    if "-" in m:
        parts = m.split("-")
        result = calc_importance(importances, parts[0])
        for p in parts[1:]:
            result = result - calc_importance(importances, p)
        return result
    if "/" in m:
        parts = m.split("/")
        result = calc_importance(importances, parts[0])
        for p in parts[1:]:
            result = result / calc_importance(importances, p)
        return result
    if "**" in m:
        base, exp = m.split("**")
        return calc_importance(importances, base) ** calc_importance(importances, exp)
    if "*" in m:
        parts = m.split("*")
        result = calc_importance(importances, parts[0])
        for p in parts[1:]:
            result = result * calc_importance(importances, p)
        return result
    try:
        return float(m)
    except ValueError:
        v = importances[m]
        if v is None:
            raise ValueError(f"metric {m!r} unavailable (missing grads/telemetry?)")
        return v


def get_prune_channels(
    groups: Sequence[PruneGroup],
    params,
    grads,
    importance_metric: str,
    n_prune_channels: Optional[int] = None,
    perc_prune_channels_per_iter: float = 0.005,
    min_channels_per_group: int = 8,
    max_prune_importance_per_iter: Optional[float] = None,
    min_prune_channels: int = 4,
    telemetry=None,
    calibration_scales: Optional[Dict[str, float]] = None,
    d_inner_multiple: int = 8,
):
    """Select {group_name: [channel indices]} to prune this iteration.

    Returns (selection dict, pruned_param_count, min_importance_per_group).
    """
    if n_prune_channels is None:
        total = sum(g.n_channels for g in groups)
        n_prune_channels = max(4, int(total * perc_prune_channels_per_iter))

    candidates = []  # (importance, group_name, channel_idx, n_parameters)
    importance_min = {}
    for g in groups:
        imps = group_importances(params, g, grads, telemetry)
        vec = np.asarray(calc_importance(imps, importance_metric), dtype=np.float64)
        if calibration_scales and g.name in calibration_scales:
            vec = vec * calibration_scales[g.name]
        importance_min[g.name] = float(vec.min())
        max_cutoff = min(n_prune_channels, g.n_channels - min_channels_per_group)
        if max_cutoff < 1:
            continue
        order = np.argsort(vec)[:max_cutoff]
        for idx in order:
            candidates.append((float(vec[idx]), g.name, int(idx), imps["n_parameters"]))

    candidates.sort(key=lambda c: c[0])

    # count budget with margin for the d_inner multiple-of-8 fixup
    margin = d_inner_multiple * 3
    keep_n = max(min_prune_channels + margin, n_prune_channels + margin)
    candidates = candidates[:keep_n]

    # importance budget
    if max_prune_importance_per_iter is not None:
        while (
            sum(c[0] for c in candidates) > max_prune_importance_per_iter
            and len(candidates) > min_prune_channels + margin
        ):
            candidates.pop()

    # d_inner groups must be pruned in multiples of `d_inner_multiple`
    # (efficiency rule from the reference)
    from collections import Counter

    counts = Counter(c[1] for c in candidates if c[1].startswith("d_inner"))
    for name, cnt in counts.items():
        drop = cnt % d_inner_multiple
        if drop:
            for i in reversed(range(len(candidates))):
                if candidates[i][1] == name:
                    candidates.pop(i)
                    drop -= 1
                    if drop == 0:
                        break

    # trim non-d_inner back down to the count budget
    i = len(candidates) - 1
    while len(candidates) > max(n_prune_channels, min_prune_channels) and i >= 0:
        if not candidates[i][1].startswith("d_inner"):
            candidates.pop(i)
        i -= 1

    selection: Dict[str, List[int]] = {}
    pruned_params = 0
    for imp, name, idx, n_par in candidates:
        selection.setdefault(name, []).append(idx)
        pruned_params += n_par
    return selection, pruned_params, importance_min
