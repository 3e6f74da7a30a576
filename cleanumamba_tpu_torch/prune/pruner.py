"""Prune application: ``torch.index_select`` over every affected leaf (port
of ``cleanumamba_tpu/prune/pruner.py``).

Pure tree transforms over (params, grads, optimizer state), as in the JAX
package: each pruned leaf is a new tensor on the leaf's own device, every
other leaf (an S4 kernel's ``l_kernel`` included) passes through, and the
trees handed in are left as they were.  Because widths live in tensor
shapes, no module metadata needs patching.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from cleanumamba_tpu_torch.prune.groups import PruneGroup, Slice, build_groups, get_path, set_path


def _keep_indices(dim: int, s: Slice, n_channels: int, prune_idxs: Sequence[int]) -> np.ndarray:
    """Indices to KEEP along s.axis given pruned channel ids."""
    drop = set()
    for c in prune_idxs:
        for h in range(s.n_heads):
            drop.add(s.offset + h * n_channels + int(c))
    return np.asarray([i for i in range(dim) if i not in drop], np.int64)


def prune_tree(tree, group: PruneGroup, prune_idxs: Sequence[int]):
    """Apply one group's pruning to a tree with the same structure as
    params (params themselves, grads, or Adam moment trees)."""
    for s in group.slices:
        leaf = get_path(tree, s.path)
        keep = _keep_indices(leaf.shape[s.axis], s, group.n_channels, prune_idxs)
        leaf = torch.index_select(leaf, s.axis, torch.from_numpy(keep).to(leaf.device))
        tree = set_path(tree, s.path, leaf)
    return tree


def _map_opt_state(opt_state, fn):
    """Apply fn to the params-shaped trees of the port's Adam state
    (``train/optim.py``: ``{"count", "mu", "nu"}``): the moments are pruned,
    the count is kept, as the JAX package maps ``ScaleByAdamState``."""
    return {**opt_state, "mu": fn(opt_state["mu"]), "nu": fn(opt_state["nu"])}


def apply_pruning(
    params,
    selection: Dict[str, List[int]],
    cfg,
    grads=None,
    opt_state=None,
):
    """Prune all selected groups.  Returns (params, grads, opt_state) with
    non-provided trees returned as None.

    Groups are REBUILT from the current shapes before each group's prune:
    slices of different groups can share a leaf (x_proj carries dt_rank,
    d_state and d_inner dims), so offsets/widths captured earlier go stale
    the moment another group touches that leaf.  Channel indices in
    ``selection`` stay valid because each index is relative to its own
    group's span and no two groups prune the same span.
    """
    for name, idxs in selection.items():
        if not idxs:
            continue
        groups = {g.name: g for g in build_groups(params, cfg)}
        g = groups[name]
        params = prune_tree(params, g, idxs)
        if grads is not None:
            grads = prune_tree(grads, g, idxs)
        if opt_state is not None:
            opt_state = _map_opt_state(
                opt_state, lambda tree, g=g, idxs=idxs: prune_tree(tree, g, idxs)
            )
    return params, grads, opt_state
