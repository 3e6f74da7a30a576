"""Mamba (selective SSM) bottleneck mixer (port of
``cleanumamba_tpu/models/bottleneck_mamba.py``).

    in_proj -> split (x, z) -> causal depthwise conv(K=4) + SiLU
    -> x_proj -> (dt, B, C) -> dt_proj (+bias) -> softplus (fp32)
    -> selective scan -> y * SiLU(z) -> out_proj

Dims come from parameter shapes, so ragged channel-pruned checkpoints run
through the same code.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.ops.conv import causal_depthwise_conv
from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan_fn
from cleanumamba_tpu_torch.ops.scan import selective_scan_step


def mixer_dims(p):
    """(d_model, d_inner, d_state, dt_rank, d_conv) from param shapes."""
    dt_rank, d_inner = p["dt_proj_w"].shape
    d_state = (p["x_proj"].shape[1] - dt_rank) // 2
    return p["in_proj"].shape[0], d_inner, d_state, dt_rank, p["conv_w"].shape[0]


def ssm_inputs(p, xs):
    """Post-conv activations xs (..., d_inner) -> (dt fp32, B, C, A fp32):
    x_proj, dt_proj + bias, fp32 softplus, A = -exp(A_log) in fp32.  B and
    C are contiguous copies (the scan kernel reads them densely)."""
    _, _, d_state, dt_rank, _ = mixer_dims(p)
    dbc = xs @ p["x_proj"].to(xs.dtype)
    dt = dbc[..., :dt_rank] @ p["dt_proj_w"].to(xs.dtype) + p["dt_proj_b"].to(xs.dtype)
    dt = F.softplus(dt.float())
    Bm = dbc[..., dt_rank : dt_rank + d_state].contiguous()
    Cm = dbc[..., dt_rank + d_state :].contiguous()
    A = -torch.exp(p["A_log"].float())
    return dt, Bm, Cm, A


def mixer_forward(p, x):
    """Offline forward.  x: (B, T, d_model) -> (B, T, d_model).  The scan
    runs K1 for CUDA tensors, the plain chunked scan on the CPU; when
    autograd records the call it goes through ``SelectiveScanFn`` (backward
    K2 or the plain reverse scan).  h0 is zeros, as in the JAX package, so
    that its gradient exists."""
    _, d_inner, d_state, _, _ = mixer_dims(p)
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xs = F.silu(causal_depthwise_conv(xs, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm, A = ssm_inputs(p, xs)
    h0 = torch.zeros((xs.shape[0], d_inner, d_state), dtype=torch.float32, device=xs.device)
    y, _ = selective_scan_fn(xs, dt, A, Bm, Cm, p["D"].float(), h0)
    return (y * F.silu(z)) @ p["out_proj"].to(y.dtype)


def mixer_init_cache(p, batch_size: int, dtype=torch.float32, device="cpu"):
    """Streaming cache: the last d_conv inputs and the fp32 recurrent state."""
    _, d_inner, d_state, _, d_conv = mixer_dims(p)
    return {
        "conv_state": torch.zeros((batch_size, d_conv, d_inner), dtype=dtype, device=device),
        "ssm_state": torch.zeros((batch_size, d_inner, d_state), dtype=torch.float32,
                                 device=device),
    }


def mixer_step(p, cache, x):
    """Single-token streaming step.  x: (B, d_model) -> (cache', (B, d_model))."""
    _, d_inner, _, _, _ = mixer_dims(p)
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    conv_state = torch.cat([cache["conv_state"][:, 1:], xs[:, None, :]], dim=1)
    xs = (conv_state * p["conv_w"].to(x.dtype)).sum(dim=1) + p["conv_b"].to(x.dtype)
    xs = F.silu(xs)
    dt, Bm, Cm, A = ssm_inputs(p, xs)
    h, y = selective_scan_step(cache["ssm_state"], xs, dt, A, Bm, Cm, p["D"])
    out = (y * F.silu(z)) @ p["out_proj"].to(y.dtype)
    return {"conv_state": conv_state, "ssm_state": h}, out


def uniform(gen, shape, bound):
    """U(-bound, bound) fp32 draws from the CPU generator ``gen``."""
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def mixer_init(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
               dt_rank: int, d_conv: int = 4, dt_min: float = 0.001,
               dt_max: float = 0.1, dt_init_floor: float = 1e-4):
    """mamba-ssm's Mamba.__init__ math on the CPU generator ``gen`` (fp32):
    dt log-uniform in [dt_min, dt_max] -> inverse-softplus bias; A_log =
    log(1..d_state); torch-Linear uniform fan-in init elsewhere.  out_proj
    is zero here and set by the model-level init."""
    in_proj = uniform(gen, (d_model, 2 * d_inner), 1.0 / math.sqrt(d_model))
    x_proj = uniform(gen, (d_inner, dt_rank + 2 * d_state), 1.0 / math.sqrt(d_inner))
    conv_bound = 1.0 / math.sqrt(d_conv)
    conv_w = uniform(gen, (d_conv, d_inner), conv_bound)
    conv_b = uniform(gen, (d_inner,), conv_bound)
    dt_proj_w = uniform(gen, (dt_rank, d_inner), dt_rank ** -0.5)
    u = torch.rand((d_inner,), generator=gen, dtype=torch.float32)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_init_floor)
    inv_dt = dt + torch.log(-torch.expm1(-dt))
    A = torch.arange(1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": conv_b,
        "x_proj": x_proj,
        "dt_proj_w": dt_proj_w,
        "dt_proj_b": inv_dt,
        "A_log": torch.log(A),
        "D": torch.ones((d_inner,), dtype=torch.float32),
        "out_proj": torch.zeros((d_inner, d_model), dtype=torch.float32),
    }
