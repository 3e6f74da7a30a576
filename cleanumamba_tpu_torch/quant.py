"""Weight-only int8 for the streaming step (port of ``cleanumamba_tpu/quant.py``).

Big weight tensors are stored as symmetric per-channel int8 with fp32
scales; the streaming step reads them through :func:`dequantize_params`
(``params.prepare_weight_view``), and the fused level kernels (K3/K4,
``ops/cuda/stream_fused.py``) take the int8 values and scales as they are
and dequantise each staged weight inside the kernel.

A quantized leaf is the dict ``{_Q_TAG: int8 tensor, "scale": fp32 tensor}``
with the scale over the last axis, shaped to broadcast back over the leaf
(``(1, ..., 1, N)``).  Only float leaves with ndim >= 2 and at least
``min_size`` elements are quantized; biases, norms and the state-dynamics
parameters (``_SENSITIVE_KEYS``) keep their dtype.
"""

from __future__ import annotations

import torch

# Marker key: a quantized leaf is a dict {_Q_TAG: int8 values, "scale": fp32}.
_Q_TAG = "int8_values"

# Leaves never quantized (nor cast to bf16 by the bf16 view), whatever their
# size: their consumers exponentiate them or they drive the state dynamics,
# so rounding error in them is amplified.
_SENSITIVE_KEYS = ("A_log", "A_real", "A_imag", "inv_dt", "dt_proj_b")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and _Q_TAG in leaf


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree whose leaves include
    quantized dicts (taken whole)."""
    if is_quantized(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaves(tree):
    out = []
    _map(lambda _, x: out.append(x), tree)
    return out


def _quantize_leaf(w: torch.Tensor) -> dict:
    """Symmetric per-channel (last axis) int8: scale = max|w| / 127 over all
    leading axes, q = clip(round(w / scale), -127, 127), rounding half to even
    as ``jnp.round`` does."""
    absmax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {_Q_TAG: q, "scale": scale.to(torch.float32)}


def quantize_params(params, min_size: int = 4096):
    """The tree with every float leaf of ndim >= 2 and at least ``min_size``
    elements, outside ``_SENSITIVE_KEYS``, replaced by its quantized dict."""

    def q(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and leaf.ndim >= 2
                and leaf.numel() >= min_size and not set(path).intersection(_SENSITIVE_KEYS)):
            return _quantize_leaf(leaf)
        return leaf

    return _map(q, params)


def _dequantize_leaf(leaf: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """``q * scale``, both cast to ``dtype`` first (the JAX view's rounding)."""
    return leaf[_Q_TAG].to(dtype) * leaf["scale"].to(dtype)


def dequantize_params(params, dtype=torch.bfloat16):
    """The dense tree of a quantized one: each quantized leaf becomes
    :func:`_dequantize_leaf` in ``dtype``; every other leaf is returned as it is."""
    return _map(lambda _, x: _dequantize_leaf(x, dtype) if is_quantized(x) else x, params)


def count_quantized(params) -> int:
    """Number of quantized leaves in a tree."""
    return sum(is_quantized(x) for x in _leaves(params))


def quantization_error(params, qparams) -> float:
    """Largest per-tensor error of the fp32 dequantized tree, relative to the
    tensor's max|w| (a sanity diagnostic)."""
    worst = 0.0
    for a, b in zip(_leaves(params), _leaves(dequantize_params(qparams, torch.float32))):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            denom = a.abs().max().item() + 1e-12
            worst = max(worst, (a.float() - b.float()).abs().max().item() / denom)
    return worst
