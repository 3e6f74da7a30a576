"""Mamba2 (SSD) bottleneck mixer, the step side (port of
``cleanumamba_tpu/models/bottleneck_mamba2.py``).

    in_proj: (d_model, 2*d_inner + 2*d_state + n_heads) -> (z, xBC, dt)
    causal depthwise conv over xBC = (d_inner + 2*d_state) channels + SiLU
    per-head scalar decay (A_log, dt_bias, D: (n_heads,)); gated RMSNorm; out_proj

The scalar-per-head decay is a special case of the selective scan with
``A[i, s] = a_head(i // headdim)``, so the step and the block of tokens
(``streaming._mamba2_mixer_tokens``, K1 on CUDA) share the (d_inner, d_state)
state.  The offline ``mixer_forward`` runs the SSD form (``ops/scan.py::
ssd_scan_grad``: masked matmuls, a hand-written backward), or with
``use_ssd=False`` the plain selective scan on the broadcast parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform
from cleanumamba_tpu_torch.ops.conv import causal_depthwise_conv
from cleanumamba_tpu_torch.ops.norms import gated_rms_norm
from cleanumamba_tpu_torch.ops.scan import selective_scan, selective_scan_step, ssd_scan_grad


def mixer_geometry(p):
    """(d_model, d_inner, d_state, n_heads, headdim) from param shapes."""
    n_heads = p["A_log"].shape[0]
    d_inner = p["out_proj"].shape[0]
    d_state = (p["conv_w"].shape[1] - d_inner) // 2  # ngroups = 1
    return p["in_proj"].shape[0], d_inner, d_state, n_heads, d_inner // n_heads


def split_zxbcdt(p, zxbcdt):
    _, d_inner, d_state, _, _ = mixer_geometry(p)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner : 2 * d_inner + 2 * d_state],
            zxbcdt[..., 2 * d_inner + 2 * d_state :])


def ssm_inputs(p, xBC, dt_h):
    """Post-conv activations xBC and raw per-head dt -> (xs, dt fp32, A fp32,
    B, C, D fp32) in the selective scan's per-channel form."""
    _, d_inner, d_state, _, headdim = mixer_geometry(p)
    xs = xBC[..., :d_inner].contiguous()
    Bm = xBC[..., d_inner : d_inner + d_state].contiguous()
    Cm = xBC[..., d_inner + d_state :].contiguous()
    dt_h = F.softplus(dt_h.float() + p["dt_bias"].float())
    dt = dt_h.repeat_interleave(headdim, dim=-1)
    A_head = -torch.exp(p["A_log"].float())
    A = A_head.repeat_interleave(headdim)[:, None].expand(d_inner, d_state).contiguous()
    D = p["D"].float().repeat_interleave(headdim)
    return xs, dt, A, Bm, Cm, D


def mixer_forward(p, x, chunk: int = 32, use_ssd: bool = True):
    """Offline forward.  x: (B, T, d_model) -> (B, T, d_model).

    ``use_ssd``: the SSD scan over heads at chunk ``min(2 * chunk, 64)``,
    whose gradient is the hand-written backward (autograd through the
    chunked form would save every (B, T, T, H) decay mask); otherwise the
    plain selective scan at ``chunk`` on per-channel dt, A and D."""
    _, d_inner, d_state, n_heads, headdim = mixer_geometry(p)
    z, xBC, dt_h = split_zxbcdt(p, x @ p["in_proj"].to(x.dtype))
    xBC = F.silu(causal_depthwise_conv(xBC, p["conv_w"], p["conv_b"]))
    if use_ssd:
        Bsz, T, _ = xBC.shape
        xh = xBC[..., :d_inner].reshape(Bsz, T, n_heads, headdim)
        Bm, Cm = xBC[..., d_inner : d_inner + d_state], xBC[..., d_inner + d_state :]
        dt_h = F.softplus(dt_h.float() + p["dt_bias"].float())
        A_head = -torch.exp(p["A_log"].float())
        y, _ = ssd_scan_grad(xh, dt_h, A_head, Bm, Cm, p["D"], None, min(chunk * 2, 64))
        y = y.reshape(Bsz, T, d_inner)
    else:
        xs, dt, A, Bm, Cm, D = ssm_inputs(p, xBC, dt_h)
        y, _ = selective_scan(xs, dt, A, Bm, Cm, D, chunk=chunk)
    y = gated_rms_norm(y, z, p["norm_w"])
    return y @ p["out_proj"].to(y.dtype)


def mixer_init_cache(p, batch_size: int, dtype=torch.float32, device="cpu"):
    _, d_inner, d_state, _, _ = mixer_geometry(p)
    d_conv = p["conv_w"].shape[0]
    return {
        "conv_state": torch.zeros((batch_size, d_conv, d_inner + 2 * d_state), dtype=dtype,
                                  device=device),
        "ssm_state": torch.zeros((batch_size, d_inner, d_state), dtype=torch.float32,
                                 device=device),
    }


def mixer_step(p, cache, x):
    """Single-token streaming step.  x: (B, d_model) -> (cache', (B, d_model))."""
    z, xBC, dt_h = split_zxbcdt(p, x @ p["in_proj"].to(x.dtype))
    conv_state = torch.cat([cache["conv_state"][:, 1:], xBC[:, None, :]], dim=1)
    xBC = F.silu((conv_state * p["conv_w"].to(x.dtype)).sum(dim=1) + p["conv_b"].to(x.dtype))
    xs, dt, A, Bm, Cm, D = ssm_inputs(p, xBC, dt_h)
    h, y = selective_scan_step(cache["ssm_state"], xs, dt, A, Bm, Cm, D)
    y = gated_rms_norm(y, z, p["norm_w"])
    return {"conv_state": conv_state, "ssm_state": h}, y @ p["out_proj"].to(y.dtype)


def mixer_init(gen: torch.Generator, cfg, dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4,
               A_init_range=(1, 16)):
    """mamba-ssm's Mamba2.__init__ math: per-head A ~ U[1, 16] (log-stored),
    dt bias the inverse softplus of a log-uniform dt, torch defaults elsewhere."""
    d_model, d_inner, d_state, d_conv = cfg.tsfm_d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    n_heads = d_inner // (d_model // cfg.tsfm_n_head)
    conv_dim = d_inner + 2 * d_state
    conv_bound = 1.0 / math.sqrt(d_conv)
    in_proj = uniform(gen, (d_model, 2 * d_inner + 2 * d_state + n_heads),
                      1.0 / math.sqrt(d_model))
    conv_w = uniform(gen, (d_conv, conv_dim), conv_bound)
    conv_b = uniform(gen, (conv_dim,), conv_bound)
    u = torch.rand((n_heads,), generator=gen, dtype=torch.float32)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_init_floor)
    A = torch.rand((n_heads,), generator=gen) * (A_init_range[1] - A_init_range[0]) \
        + A_init_range[0]
    out = uniform(gen, (d_inner, d_model), 1.0 / math.sqrt(d_inner)) / math.sqrt(cfg.tsfm_n_layers)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": conv_b,
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(A),
        "D": torch.ones((n_heads,)),
        "norm_w": torch.ones((d_inner,)),
        "out_proj": out,
    }
