"""Mamba-S4 bottleneck mixer (port of ``cleanumamba_tpu/models/bottleneck_s4.py``).

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

The offline forward computes the length-L convolution kernel from the
params on their device (differentiable: the complex views are built with
``torch.complex`` from the stored pairs) and applies it as an FFT long
convolution padded to 2L.  The DPLR kernel (bilinear, rank-1 Woodbury
correction, naive Cauchy sums over conjugate pairs at the FFT nodes)
needs ``L <= l_kernel``: ``extend_kernel_length`` (host numpy, complex128)
attunes ``C~`` to a longer kernel first.  The S4D kernels (zoh, bilinear,
dss) are log-Vandermonde sums valid at any L.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform
from cleanumamba_tpu_torch.ops.conv import causal_depthwise_conv


def _r2c(x):
    return torch.complex(x[..., 0].float(), x[..., 1].float())


def _c2r(x):
    return torch.view_as_real(x.to(torch.complex64)).contiguous()


def _np_c2r(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _conj_extend(x):
    return torch.cat([x, x.conj()], dim=-1)


def _views(kp):
    """Complex views of the kernel params where they are, differentiable:
    dt (H, 1), A (H, N), B (1, H, N), C~ (C, H, N), P (R, H, N) or None."""
    dt = torch.exp(kp["inv_dt"].float())
    A = torch.complex(-torch.exp(kp["A_real"].float()), -kp["A_imag"].float())
    P = _r2c(kp["P"]) if "P" in kp else None
    return dt, A, _r2c(kp["B"]), _r2c(kp["C"]), P


def _kernel_views(kp):
    """:func:`_views` of a detached copy on the host (the streaming system)."""
    return _views({k: v.detach().cpu() for k, v in kp.items() if isinstance(v, torch.Tensor)})


def _tag(kp, key: str, default: str) -> str:
    v = kp.get(key)
    return default if v is None else str(v)


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
        dAd, dB, dC = s4_diag_discrete(kp, _tag(kp, "disc", "zoh"))
        dA = dAd[:, :, None] * torch.eye(dAd.shape[-1], dtype=torch.complex64)[None]
    return {"dA": _c2r(dA), "dB": _c2r(dB), "dC": _c2r(dC)}


# --------------------------------------------------------------------------
# offline: the convolution kernel and the FFT long convolution
# --------------------------------------------------------------------------

def s4_dplr_kernel(kp, L: int):
    """Length-L convolution kernel K (C, H, L), real, of the DPLR system
    (bilinear discretisation, rank-1 Woodbury correction, naive Cauchy sums
    over conjugate pairs at the l_kernel-point FFT nodes).  Raises when L
    exceeds the attuned ``l_kernel``: extend it first."""
    l_ker = int(kp["l_kernel"])
    if not L <= l_ker:
        raise ValueError(f"kernel length {L} > attuned l_kernel {l_ker}; call "
                         "extend_kernel_length() on the params first")
    dt, A, B, C, P = _views(kp)
    n_nodes = l_ker // 2 + 1
    angle = torch.arange(n_nodes, dtype=torch.float64, device=dt.device) * (-2.0 * math.pi / l_ker)
    omega = torch.polar(torch.ones_like(angle), angle).to(torch.complex64)
    z = 2.0 * (1.0 - omega) / (1.0 + omega)

    w = A * dt  # (H, N)
    v = torch.cat([B, P], dim=0)[:, None] * torch.cat([C, P.conj()], dim=0)[None]
    v = v * dt  # (2, C+1, H, N); dt (H, 1) broadcasts over N

    # r = sum_n v / (z - w) + conj(v) / (z - conj(w))   -> (2, C+1, H, n_nodes)
    zz = z[None, None, None, None, :]
    r = (v[..., None] / (zz - w[None, None, :, :, None])).sum(dim=-2) \
        + (v.conj()[..., None] / (zz - w.conj()[None, None, :, :, None])).sum(dim=-2)
    k_f = r[:-1, :-1] - r[:-1, -1:] * r[-1:, :-1] / (1.0 + r[-1:, -1:])
    k_f = k_f * 2.0 / (1.0 + omega)
    k = torch.fft.irfft(k_f, n=l_ker, dim=-1)  # (1, C, H, l_ker), 1/n normalised
    return k[0, :, :, :L]


def _diag_views(kp):
    """dt (H, 1), A (H, N), BC (C, H, N) = B * C of a diagonal kernel."""
    dt, A, B, C, _ = _views(kp)
    return dt, A, B * C


def _log_vandermonde(v, x, L):
    """2 Re(sum_n v_n exp(x_n l)) for l in [0, L): (C, H, L)."""
    ls = torch.arange(L, dtype=torch.float32, device=x.device)
    vm = torch.exp(x[..., None] * ls)  # (H, N, L)
    return 2.0 * torch.einsum("chn,hnl->chl", v, vm).real


def s4_diag_kernel(kp, L: int, disc: str = "zoh"):
    """Length-L S4D convolution kernel K (C, H, L), real, for disc in
    {"zoh", "bilinear", "dss"}."""
    dt, A, BC = _diag_views(kp)
    dtA = dt * A  # (H, N)
    if disc == "zoh":
        return _log_vandermonde(BC * (torch.exp(dtA) - 1.0) / A, dtA, L)
    if disc == "bilinear":
        v = BC * (1.0 / (1.0 - dtA / 2.0)) * dt
        return _log_vandermonde(v, torch.log((1.0 + dtA / 2.0) / (1.0 - dtA / 2.0)), L)
    if disc == "dss":
        # DSS normalisation, guarding eigenvalues with a positive real part
        ls = torch.arange(L, dtype=torch.float32, device=dtA.device)
        gt0 = (A.real > 0).float()
        S = torch.exp(dtA[..., None] * ls - (dtA * (gt0 * (L - 1)))[..., None])  # (H, N, L)
        dtA_neg = dtA * (1 - 2 * gt0)
        x = (torch.exp(dtA_neg * L) - 1.0) * A
        v = BC * (torch.exp(dtA_neg) - 1.0) * (x.conj() / (x * x.conj() + 1e-7))
        return torch.einsum("chn,hnl->chl", v, S).real
    raise ValueError(f"disc={disc!r} not supported (zoh|bilinear|dss)")


# name -> (kernel params, L) -> (C, H, L); the diag entries read their
# discretisation from the params' "disc" tag
kernel_registry = {
    "s4d": lambda kp, L: s4_diag_kernel(kp, L, disc=_tag(kp, "disc", "zoh")),
    "diag": lambda kp, L: s4_diag_kernel(kp, L, disc=_tag(kp, "disc", "zoh")),
    "dss": lambda kp, L: s4_diag_kernel(kp, L, disc="dss"),
    "s4": s4_dplr_kernel,
    "nplr": s4_dplr_kernel,
    "dplr": s4_dplr_kernel,
}


def s4_kernel(kp, L: int):
    """Dispatch on the kernel params' ``mode`` tag (default "dplr", the mode
    of every released checkpoint)."""
    return kernel_registry[_tag(kp, "mode", "dplr")](kp, L)


def s4d_init_kernel(H: int, N: int = 64, disc: str = "zoh", dt_min: float = 0.001,
                    dt_max: float = 0.1, seed: int = 0):
    """S4D kernel params on the host: the HiPPO-LegS diagonal (its low-rank
    part dropped) over the conjugate half N // 2, C complex normal, dt
    log-uniform; numpy draws from ``seed`` (the JAX package's values)."""
    w, _, B_c = _hippo_legs_nplr(N)
    rng = np.random.default_rng(seed)
    n = N // 2
    C = (rng.normal(size=(1, H, n)) + 1j * rng.normal(size=(1, H, n))) / math.sqrt(2)
    inv_dt = rng.uniform(math.log(dt_min), math.log(dt_max), size=(H, 1))
    A = np.tile(w[None, :], (H, 1))
    t = torch.from_numpy
    return {
        "A_real": t(np.log(np.maximum(-A.real, 1e-4)).astype(np.float32)),
        "A_imag": t((-A.imag).astype(np.float32)),
        "B": t(_np_c2r(np.tile(B_c[None, None, :], (1, H, 1)))),
        "C": t(_np_c2r(C)),
        "inv_dt": t(inv_dt.astype(np.float32)),
        "mode": disc if disc == "dss" else "s4d",
        "disc": disc,
    }


def _np_conj_extend(x):
    return np.concatenate([x, np.conj(x)], axis=-1)


def extend_kernel_length(kp, L: int):
    """Kernel params valid for kernels of length L: a new dict whose ``C~``
    is attuned to ``l_kernel`` >= L.  The first attunement sets
    C~ = C (I - dA^L); after that the length doubles, C~' = C~ (I + dA^l),
    until it covers L.  Host numpy in complex128 from the complex64 dense
    system; a diagonal kernel (no ``l_kernel``) is returned as it is."""
    kp = dict(kp)
    if "l_kernel" not in kp:
        return kp
    l_ker = int(kp["l_kernel"])
    if 0 < l_ker and L <= l_ker:
        return kp
    dA = _dense_discrete(kp)[0].numpy().astype(np.complex128)
    C = kp["C"].detach().cpu().double().numpy()
    Cc = _np_conj_extend(C[..., 0] + 1j * C[..., 1])  # (C, H, 2N)
    N = C.shape[-2]
    if l_ker == 0:
        steps, l_new = [(L, -1.0)], L
    else:
        steps, l_new = [], l_ker
        while L > l_new:
            steps.append((l_new, 1.0))
            l_new *= 2
    for power, sign in steps:
        for h in range(dA.shape[0]):
            dA_l = np.linalg.matrix_power(dA[h], power)
            for c in range(Cc.shape[0]):
                Cc[c, h] = Cc[c, h] + sign * (dA_l.T @ Cc[c, h])
    kp["C"] = torch.from_numpy(_np_c2r(Cc[..., :N].astype(np.complex64))).to(kp["C"].device)
    kp["l_kernel"] = l_new
    return kp


def fft_long_conv(p, u):
    """The S4 long convolution on (B, L, H): the length-L kernel of the
    mode-dispatched registry, an FFT convolution padded to 2L (causal), the
    D skip, the C = 1 channel flattened, exact (erf) GELU."""
    _, L, _ = u.shape
    k = s4_kernel(p["kernel"], L)  # (C, H, L)
    n = 2 * L
    uf = torch.fft.rfft(u.float(), n=n, dim=1)  # (B, F, H)
    kf = torch.fft.rfft(k.float(), n=n, dim=-1)  # (C, H, F)
    y = torch.fft.irfft(uf[:, None] * kf.movedim(-1, 1)[None], n=n, dim=2)[:, :, :L, :]
    y = y + u.float()[:, None] * p["ssm_D"].float()[None, :, None, :]  # (B, C, L, H)
    return F.gelu(y[:, 0].to(u.dtype))


def _s4block_forward(p, x):
    """S4 block around the long convolution: (B, L, d_inner) -> (B, L, d_inner)."""
    u = x @ p["input_linear_w"].to(x.dtype) + p["input_linear_b"].to(x.dtype)
    y = fft_long_conv(p, u)
    y = y @ p["output_linear_w"].to(x.dtype) + p["output_linear_b"].to(x.dtype)
    half = y.shape[-1] // 2
    return y[..., :half] * torch.sigmoid(y[..., half:])


def mixer_forward(p, x, chunk: int = 32):
    """Offline forward.  x: (B, T, d_model) -> (B, T, d_model); ``chunk`` is
    unused (the mixers share one signature).  T must not exceed an attuned
    DPLR kernel's ``l_kernel`` (``models/cleanumamba.py::prepare_for_length``)."""
    d_inner = p["conv_w"].shape[1]
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xs = F.silu(causal_depthwise_conv(xs, p["conv_w"], p["conv_b"]))
    y = _s4block_forward(p, xs) * F.silu(z)
    return y @ p["out_proj"].to(y.dtype)


# --------------------------------------------------------------------------
# streaming: the discrete system
# --------------------------------------------------------------------------


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
