"""Structured channel pruning: dependency groups over the param pytree (port
of ``cleanumamba_tpu/prune/``).

Groups are *rebuilt from parameter shapes* on demand instead of carrying
mutable channel_offset/dim state, pruning is a tree -> tree transformation
(``torch.index_select`` on every affected leaf plus the Adam moments), and
activation telemetry comes from a tap-collecting forward
(``models.cleanumamba.forward_with_telemetry``) instead of module hooks.
The group graph, importances, selection, telemetry and calibration are the
JAX package's numpy arithmetic on the host; the forward, the gradient and
the pruned tensors stay on the params' device.
"""

from cleanumamba_tpu_torch.prune.groups import Slice, PruneGroup, build_groups
from cleanumamba_tpu_torch.prune.importance import (
    calc_importance,
    group_importances,
    get_prune_channels,
)
from cleanumamba_tpu_torch.prune.pruner import prune_tree, apply_pruning

__all__ = [
    "Slice",
    "PruneGroup",
    "build_groups",
    "calc_importance",
    "group_importances",
    "get_prune_channels",
    "prune_tree",
    "apply_pruning",
]
