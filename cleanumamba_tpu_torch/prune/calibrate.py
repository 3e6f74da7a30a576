"""Layer-wise loss calibration of group importances (the port's copy of
``cleanumamba_tpu/prune/calibrate.py``).

Reference: src/pruning/layerwise_calibration.py:23-151.  For each group,
prune 20% of its channels (least important by ``n_parameters*metric``) on a
*copy*, measure the loss change over a fixed batch sample, and set
``scale = loss_change / total_pruned_importance``; scales are EMA'd across
calibrations and floored at ``min_scale``.  The functional pytree design
makes the "copy" free — pruning returns a new tree, the original is untouched
(no deepcopy / hook-removal dance, layerwise_calibration.py:118-121).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from cleanumamba_tpu_torch.prune.groups import PruneGroup
from cleanumamba_tpu_torch.prune.importance import (
    calc_importance,
    get_prune_channels,
    group_importances,
)
from cleanumamba_tpu_torch.prune.pruner import apply_pruning


class Calibrator:
    def __init__(self, ema_factor: float = 1.0, min_scale: float = 1e-7,
                 default_scale: float = 36.0):
        self.scales: Dict[str, float] = {}
        self.ema_factor = ema_factor
        self.min_scale = min_scale
        self.default_scale = default_scale

    def gather(
        self,
        params,
        cfg,
        grads,
        groups: Sequence[PruneGroup],
        loss_sampler: Callable,
        importance_metric: str,
        prune_fraction: float = 0.2,
    ):
        """loss_sampler(params) -> mean loss over a fixed data sample."""
        baseline = float(loss_sampler(params))
        new_scales: Dict[str, float] = {}
        metric = f"n_parameters*{importance_metric}"
        for g in groups:
            sel, _, _ = get_prune_channels(
                [g], params, grads, metric,
                n_prune_channels=None,
                perc_prune_channels_per_iter=prune_fraction,
                min_channels_per_group=8,
            )
            idxs = sel.get(g.name, [])
            if not idxs:
                continue
            # total importance of the selected channels
            imps = group_importances(params, g, grads)
            vec = np.asarray(calc_importance(imps, metric), dtype=np.float64)
            total_importance = float(vec[idxs].sum())
            if total_importance <= 0:
                continue
            pruned, _, _ = apply_pruning(params, {g.name: idxs}, cfg)
            loss = float(loss_sampler(pruned))
            new_scales[g.name] = (loss - baseline) / total_importance
        for name, scale in new_scales.items():
            if name in self.scales:
                self.scales[name] = max(
                    self.scales[name] * (1 - self.ema_factor) + scale * self.ema_factor,
                    self.min_scale,
                )
            else:
                self.scales[name] = max(scale, self.min_scale)
        return new_scales

    def as_dict(self) -> Dict[str, float]:
        return dict(self.scales)

    def scale_for(self, name: str) -> float:
        return self.scales.get(name, self.default_scale)


# ---------------------------------------------------------------------------
# importance-vs-loss experiment harness
# (reference layerwise_calibration.py:161-276: test_importance_per_layer +
#  scatter_importance_per_layer)
# ---------------------------------------------------------------------------

def importance_loss_experiment(
    params,
    cfg,
    grads,
    groups: Sequence[PruneGroup],
    loss_sampler: Callable,
    sample_size: int = 6,
    n_remove: int = 4,
    seed: int = 42,
    sink=None,
    verbose: bool = True,
):
    """For every prune group, repeatedly prune ``n_remove`` random channels
    on a functional copy, measure the relative loss change against the
    unpruned baseline, and record it next to the mean importance metrics of
    the removed channels (reference test_importance_per_layer,
    layerwise_calibration.py:161-231 — row schema kept name-for-name).

    loss_sampler(params) -> mean loss over a fixed data sample (the caller
    fixes the sample so every probe sees identical batches, mirroring the
    reference's np.random.seed(42) re-seeding).
    sink: optional MetricsLogger — each row is appended as a
    ``calibration_experiment`` record (replaces the reference's torch.save
    pickle as the persistent artifact).
    """
    rng = np.random.default_rng(seed)
    baseline = float(loss_sampler(params))
    if verbose:
        print(f"baseline loss: {baseline:.5f}")
    results = []
    for g in groups:
        imps = group_importances(params, g, grads)
        n_params_per_ch = imps.get("n_parameters")
        for _ in range(sample_size):
            k = min(n_remove, max(1, g.n_channels - 8))
            idxs = sorted(rng.permutation(g.n_channels)[:k].tolist())
            pruned, _, _ = apply_pruning(params, {g.name: idxs}, cfg)
            loss = float(loss_sampler(pruned))

            def mean_of(metric):
                v = imps.get(metric)
                return None if v is None else float(np.mean(np.asarray(v)[idxs]))

            row = {
                "group": g.name,
                "remove_index": idxs,
                "n_channels": g.n_channels,
                "weight_imp": mean_of("weight"),
                "taylor_ind_imp": mean_of("taylor_individual"),
                "taylor_gro_imp": mean_of("taylor_group"),
                "grad_imp": mean_of("grad"),
                "act_var": mean_of("act_var"),
                "param_per_channel": (
                    None if n_params_per_ch is None else float(n_params_per_ch)
                ),
                "loss_change": (loss - baseline) / baseline,
            }
            results.append(row)
            if verbose:
                print(f"{g.name} prune {idxs}: loss {loss:.5f} "
                      f"(Δ {row['loss_change']:+.4f})")
            if sink is not None:
                sink.log(row, kind="calibration_experiment")
    return results


def scatter_importance_loss(results, metric: str = "taylor_ind_imp",
                            out_path: str = "importance_vs_loss.png"):
    """Log-log scatter of per-group importance vs loss change (reference
    scatter_importance_per_layer, layerwise_calibration.py:224-276); saves
    to ``out_path`` instead of plt.show() (headless hosts).  matplotlib is
    imported here, and only here: nothing else in the package needs it."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig = plt.figure(figsize=(12, 6))
    plt.grid()
    names = sorted({r["group"] for r in results})
    for name in names:
        xs = np.array([r[metric] for r in results
                       if r["group"] == name and r[metric] is not None])
        ys = np.array([r["loss_change"] for r in results
                       if r["group"] == name and r[metric] is not None])
        if len(xs):
            plt.scatter(np.abs(xs), np.abs(ys), label=name, s=14)
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel(metric)
    plt.ylabel("|loss change|")
    plt.title(f"{metric} vs loss change")
    plt.legend(loc="upper right", fontsize=7, ncol=2)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
