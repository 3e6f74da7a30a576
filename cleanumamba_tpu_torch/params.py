"""Parameter pytrees: numpy <-> torch, checkpoints, and the storage-precision view.

The JAX package's params are nested dicts/lists of arrays with channels-last
layouts (``cleanumamba_tpu/models/cleanumamba.py::init_params``).  The port
keeps exactly that tree, with torch tensors at the leaves, so a test can
build weights once and feed both packages.
"""

from __future__ import annotations

import pickle
from typing import Any, Tuple

import numpy as np
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.quant import _SENSITIVE_KEYS, dequantize_params, quantize_params


def default_device() -> torch.device:
    """The device every entry point runs on unless its caller names another:
    the first CUDA device.  Raises where there is none; nothing carries on
    on the CPU unasked (pass ``device="cpu"`` to ask)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this port runs on the GPU by default; pass device=\"cpu\" "
            "(or --device cpu) to run on the CPU")
    return torch.device("cuda:0")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tensor_leaves(tree):
    """The tensor leaves of ``tree`` in ``tree_leaves`` order: what a gradient
    or an optimizer reads.  Other leaves (an S4 kernel's ``l_kernel`` int,
    its ``mode``/``disc`` strings) are static tags, as in the JAX pytree."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure with its tensor leaves replaced by
    ``leaves`` (in ``tensor_leaves`` order); other leaves are kept."""
    it = iter(leaves)
    return tree_map(lambda x: next(it) if isinstance(x, torch.Tensor) else x, tree)


def from_numpy(tree, device, dtype=None):
    """numpy pytree (e.g. ``jax.tree.map(np.asarray, params)``) -> the same
    tree of torch tensors on ``device``.  ``dtype`` recasts floating leaves."""

    def conv(x):
        if isinstance(x, (np.ndarray, np.generic)):
            # C order: pickled leaves may be Fortran-ordered views
            t = torch.from_numpy(np.array(x, order="C", copy=True))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return t.to(device)
        # static tags of an S4 kernel (attuned length, mode) may arrive as
        # small wrapper objects around an int or a str: carry the plain value
        value = getattr(x, "value", None)
        if isinstance(value, (int, str)) and not isinstance(x, (int, str)):
            return value
        return x

    return tree_map(conv, tree)


def to_numpy(tree):
    """torch pytree -> numpy pytree (floats keep their width; bf16 -> fp32,
    which numpy cannot hold)."""

    def conv(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.numpy()
        return x

    return tree_map(conv, tree)


def to_device(tree, device):
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def payload_config(payload: dict) -> CleanUMambaConfig:
    """The CleanUMambaConfig of a checkpoint payload: its reference-JSON
    ``network_config``, with the bottleneck family spelled by ``bottleneck``
    (as ``cleanumamba_tpu/train/checkpoint.py::load_checkpoint`` reads it)."""
    if payload.get("network_config") is None:
        raise ValueError("checkpoint has no network_config")
    bottleneck = payload.get("bottleneck")
    network = "CleanUNet" if bottleneck == "mha" else "CleanUMamba"
    ncfg = dict(payload["network_config"])
    flag = {"lstm": "LSTM", "mamba_s4": "mamba_s4", "mamba2": "mamba_v2"}.get(bottleneck)
    if flag is not None:
        ncfg[flag] = True
    return CleanUMambaConfig.from_reference_json(network, ncfg)


def load_checkpoint(path: str, device=None) -> Tuple[CleanUMambaConfig, Any]:
    """Checkpoint pickle -> ``(cfg, params)``, params as torch tensors on
    ``device`` (None: :func:`default_device`).

    The pickle holds numpy leaves under ``params`` and a reference-JSON
    ``network_config`` (:func:`payload_config`).  Only load checkpoints this
    project wrote: unpickling runs code.
    """
    device = resolve_device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return payload_config(payload), from_numpy(payload["params"], device)


def prepare_weight_view(params, weights: str, dtype=torch.float32, quant_min_size: int = 4096):
    """Storage precision of the weights the streaming step reads
    (port of ``cleanumamba_tpu/streaming.py::prepare_weight_view``).

    Returns ``(stored, view)``: ``stored`` is the tree of the weights' storage
    precision, ``view(stored)`` the tree the step functions consume.  "fp32":
    ``params`` as they are.  "bf16": every fp32 leaf of ndim >= 2 whose path
    holds no sensitive key cast to bf16; 1-D leaves (biases, norms, ``D``,
    ``dt_proj_b``) and ``A_log`` stay fp32 (``bench.py`` casts every fp32
    leaf instead; the port follows this function); the view is the identity,
    and ``Streamer`` and ``SessionMultiplexer`` widen the leaves their steps
    read outside the level packs back to fp32 once, where they compute in
    fp32 (``streaming.step_weights``), so that no step casts them.  "int8":
    ``quant.quantize_params(params, quant_min_size)``, viewed as ``q *
    scale`` in ``dtype`` (the state dtype) inside each prime, step and block
    call, two launches per quantized leaf on a card.
    """
    if weights == "fp32":
        return params, _identity
    if weights == "int8":
        return (quantize_params(params, quant_min_size),
                lambda p: dequantize_params(p, dtype))
    if weights != "bf16":
        raise ValueError(f"weights={weights!r}: expected fp32|bf16|int8")

    def cast(path, x):
        if (isinstance(x, torch.Tensor) and x.dtype == torch.float32
                and x.ndim >= 2 and not set(path).intersection(_SENSITIVE_KEYS)):
            return x.to(torch.bfloat16)
        return x

    return _map_with_path(cast, params), _identity


def _identity(p):
    return p
