"""Normalisation ops with fp32 statistics (port of ``cleanumamba_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last axis with fp32 statistics."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def gated_rms_norm(x, z, scale, eps: float = 1e-5):
    """Mamba2's gated RMSNorm: norm(x * silu(z)) with fp32 statistics."""
    xf = x.float() * torch.nn.functional.silu(z.float())
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
