"""Mamba-S4 bottleneck mixer, the step side (port of
``cleanumamba_tpu/models/bottleneck_s4.py``).

    in_proj -> split (x, z) -> causal depthwise conv(K=4) + SiLU
    -> S4 block: input_linear (d_inner -> H), the state-space model with a
       D skip and exact (erf) GELU, output_linear (H -> 2*d_inner) -> GLU
    -> * SiLU(z) -> out_proj

Streaming carries the SSM as its discrete system ``s' = dA s + dB u,
y = Re(dC s')`` per head, with the complex state as (re, im) pairs.  For
the DPLR kernel (params hold ``P``) dA is the dense bilinear discretisation
of diag(A) - P P* over the conjugate-extended 2N modes and dC undoes the
kernel's attunement ``C~ = C (I - dA^l_kernel)``; for the diagonal (S4D)
kernels dA is diagonal and the conjugate doubling is folded into dC.  The
system is computed once, in complex64 on the host, and moved to the cache's
device.  Kernel params store complex tensors as (..., 2) real pairs and two
static tags as plain Python values: ``l_kernel`` (int) and, for the
diagonal kernels, ``mode``/``disc`` (str).

The offline forward (kernel generation + FFT long convolution) is not
ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform


def _r2c(x):
    return torch.complex(x[..., 0].float(), x[..., 1].float())


def _c2r(x):
    return torch.view_as_real(x.to(torch.complex64)).contiguous()


def _np_c2r(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _conj_extend(x):
    return torch.cat([x, x.conj()], dim=-1)


def _kernel_views(kp):
    """Complex views of the kernel params on the host:
    dt (H, 1), A (H, N), B (1, H, N), C~ (C, H, N), P (R, H, N) or None."""
    kp = {k: v.detach().cpu() for k, v in kp.items() if isinstance(v, torch.Tensor)}
    dt = torch.exp(kp["inv_dt"].float())
    A = torch.complex(-torch.exp(kp["A_real"].float()), -kp["A_imag"].float())
    P = _r2c(kp["P"]) if "P" in kp else None
    return dt, A, _r2c(kp["B"]), _r2c(kp["C"]), P


def _dense_discrete(kp):
    """dA (H, 2N, 2N), dB (H, 2N): bilinear discretisation of the full DPLR
    matrix A_full = diag(A) - P P* (rank 1) over the conjugate-extended modes."""
    dt, A, B, _, P = _kernel_views(kp)
    Bc, Pc, Ac = _conj_extend(B)[0], _conj_extend(P)[0], _conj_extend(A)
    N2 = Ac.shape[1]
    eye = torch.eye(N2, dtype=torch.complex64)[None]
    A_full = Ac[:, :, None] * eye - Pc[:, :, None] * Pc.conj()[:, None, :]
    dth = dt[:, :1, None].to(torch.complex64)  # (H, 1, 1)
    M = torch.linalg.inv(eye - dth / 2.0 * A_full)
    dA = M @ (eye + dth / 2.0 * A_full)
    dB = torch.einsum("hmn,hn->hm", M, dth[:, 0] * Bc)
    return dA, dB


def _dC_from_Ctilde(kp, dA):
    """Undo the kernel attunement: solve (I - dA^l)^T dC = C~ per (c, h)."""
    l_ker = int(kp["l_kernel"])
    Cc = _conj_extend(_kernel_views(kp)[3])  # (C, H, 2N)
    if l_ker == 0:
        return Cc
    M = torch.eye(dA.shape[-1], dtype=torch.complex64)[None] \
        - torch.linalg.matrix_power(dA, l_ker).transpose(-1, -2)
    return torch.linalg.solve(M, Cc.movedim(0, -1)).movedim(-1, 0)


def s4_diag_discrete(kp, disc: str = "zoh"):
    """Diagonal discretised system: dA, dB (H, N) complex and dC (C, H, N)
    with the conjugate-pair doubling folded in (y = Re(sum dC s))."""
    dt, A, B, C, _ = _kernel_views(kp)
    dtA = dt * A
    if disc == "zoh":
        dA = torch.exp(dtA)
        dB = B[0] * (torch.exp(dtA) - 1.0) / A
    elif disc == "bilinear":
        dA = (1.0 + dtA / 2.0) / (1.0 - dtA / 2.0)
        dB = B[0] * (1.0 / (1.0 - dtA / 2.0)) * dt
    else:
        raise ValueError(f"disc={disc!r} has no step form (zoh|bilinear)")
    return dA, dB, 2.0 * C


def sp_discrete_system(p):
    """The mixer's constant discrete SSM exactly as the streaming step
    carries it, as real-pair fp32 tensors on the host:
    ``{"dA": (H, N, N, 2), "dB": (H, N, 2), "dC": (C, H, N, 2)}``."""
    kp = p["kernel"]
    if "P" in kp:
        dA, dB = _dense_discrete(kp)
        dC = _dC_from_Ctilde(kp, dA)
    else:
        dAd, dB, dC = s4_diag_discrete(kp, str(kp.get("disc", "zoh")))
        dA = dAd[:, :, None] * torch.eye(dAd.shape[-1], dtype=torch.complex64)[None]
    return {"dA": _c2r(dA), "dB": _c2r(dB), "dC": _c2r(dC)}


def mixer_init_cache(p, batch_size: int, dtype=torch.float32, device="cpu"):
    d_conv, d_inner = p["conv_w"].shape
    sysm = {k: v.to(device) for k, v in sp_discrete_system(p).items()}
    H, N2 = sysm["dB"].shape[:2]
    return {
        "conv_state": torch.zeros((batch_size, d_conv, d_inner), dtype=dtype, device=device),
        "s4_state": torch.zeros((batch_size, H, N2, 2), dtype=torch.float32, device=device),
        # the discretised system rides in the cache (derived, not params)
        **sysm,
    }


def mixer_step(p, cache, x):
    """Single-token streaming step.  x: (B, d_model) -> (cache', (B, d_model))."""
    d_inner = p["conv_w"].shape[1]
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    conv_state = torch.cat([cache["conv_state"][:, 1:], xs[:, None, :]], dim=1)
    xs = F.silu((conv_state * p["conv_w"].to(x.dtype)).sum(dim=1) + p["conv_b"].to(x.dtype))
    u = xs @ p["input_linear_w"].to(xs.dtype) + p["input_linear_b"].to(xs.dtype)  # (B, H)
    dA, dB, dC = _r2c(cache["dA"]), _r2c(cache["dB"]), _r2c(cache["dC"])
    s = torch.einsum("hmn,bhn->bhm", dA, _r2c(cache["s4_state"])) \
        + dB[None] * u[..., None].to(torch.complex64)
    y = torch.einsum("chn,bhn->bch", dC, s).real  # (B, C=1, H)
    y = y + u[:, None].float() * p["ssm_D"].float()[None]
    y = F.gelu(y[:, 0].to(x.dtype))  # exact (erf) form
    y = y @ p["output_linear_w"].to(x.dtype) + p["output_linear_b"].to(x.dtype)
    half = y.shape[-1] // 2
    y = y[..., :half] * torch.sigmoid(y[..., half:]) * F.silu(z)
    out = y @ p["out_proj"].to(y.dtype)
    return {**cache, "conv_state": conv_state, "s4_state": _c2r(s)}, out


def _hippo_legs_nplr(N: int):
    """HiPPO-LegS NPLR decomposition: complex (w, P, B), each (N/2,), the
    conjugate half with negative imaginary part."""
    q = np.arange(N, dtype=np.float64)
    col, row = np.meshgrid(q, q, indexing="ij")
    r = np.sqrt(2 * q + 1)
    A = -np.where(col > row, r[:, None] * r[None, :], 0.0) - np.diag(q + 1)
    B = np.sqrt(2 * q + 1)
    P = np.sqrt(q + 0.5)
    S = A + P[:, None] * P[None, :]
    w_re = np.mean(np.diag(S))  # = -0.5
    w_im, V = np.linalg.eigh(S * -1j)
    w = w_re + 1j * w_im
    idx = np.argsort(w.imag)
    w = w[idx][: N // 2]
    V_inv = V[:, idx][:, : N // 2].conj().T
    return w, V_inv @ P.astype(np.complex128), V_inv @ B.astype(np.complex128)


def mixer_init(gen: torch.Generator, cfg, d_state_s4: int = 16, n_modes: int = 64,
               dt_min: float = 0.001, dt_max: float = 0.1):
    """MambaS4 init with the DPLR kernel: torch Linear defaults for the
    projections, HiPPO-LegS NPLR for the kernel, dt log-uniform, C ~ complex
    randn, not attuned yet (``l_kernel`` 0)."""
    d_model, d_inner, d_conv, H = cfg.tsfm_d_model, cfg.d_inner, cfg.d_conv, d_state_s4

    def lin(fan_in, shape):
        return uniform(gen, shape, 1.0 / math.sqrt(fan_in))

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).numpy()

    conv_bound = 1.0 / math.sqrt(d_conv)
    w, P_c, B_c = _hippo_legs_nplr(n_modes)
    N = n_modes // 2
    C = (randn(1, H, N) + 1j * randn(1, H, N)) / math.sqrt(2)
    u = torch.rand((H, 1), generator=gen, dtype=torch.float64).numpy()
    inv_dt = u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)
    A_tiled = np.tile(w[None, :], (H, 1))
    t = torch.from_numpy
    kernel = {
        "A_real": t(np.log(-A_tiled.real).astype(np.float32)),
        "A_imag": t((-A_tiled.imag).astype(np.float32)),
        "B": t(_np_c2r(np.tile(B_c[None, None, :], (1, H, 1)))),
        "C": t(_np_c2r(C)),
        "P": t(_np_c2r(np.tile(P_c[None, None, :], (1, H, 1)))),
        "inv_dt": t(inv_dt.astype(np.float32)),
        "l_kernel": 0,
    }
    out = uniform(gen, (d_inner, d_model), 1.0 / math.sqrt(d_inner)) / math.sqrt(cfg.tsfm_n_layers)
    return {
        "in_proj": lin(d_model, (d_model, 2 * d_inner)),
        "conv_w": uniform(gen, (d_conv, d_inner), conv_bound),
        "conv_b": uniform(gen, (d_inner,), conv_bound),
        "input_linear_w": lin(d_inner, (d_inner, H)),
        "input_linear_b": lin(d_inner, (H,)),
        "kernel": kernel,
        "ssm_D": t(randn(1, H).astype(np.float32)),
        "output_linear_w": lin(H, (H, 2 * d_inner)),
        "output_linear_b": lin(H, (2 * d_inner,)),
        "out_proj": out,
    }
