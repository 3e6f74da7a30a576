"""Selective state-space scan, plain PyTorch (port of ``cleanumamba_tpu/ops/scan.py``).

With diagonal ``A`` (d_inner, d_state) and fp32 state h (B, d_inner, d_state):

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = <h_t, C_t> + D * u_t

Contract of every scan here: ``y, h_last = scan(u, dt, A, B, C, D, h0)``
with u, dt (B, L, d_inner); B, C (B, L, d_state); D (d_inner,) or None;
h0 (B, d_inner, d_state) or None.  The state math is fp32 whatever the
input dtype; y comes back in u's dtype and h_last in fp32.

These are the plain versions: the CPU path, and the references the CUDA
kernel (``ops/cuda/selective_scan.py``) is held against on the card.
"""

from __future__ import annotations

import torch


def _coeffs(u, dt, A, B):
    """Per-step transition and input coefficients, (B, T, d_inner, d_state) fp32."""
    dt = dt.float()
    a = torch.exp(dt[..., None] * A.float())
    b = (dt * u.float())[..., None] * B.float()[:, :, None, :]
    return a, b


def _h0(h0, u, d_state):
    if h0 is None:
        return u.new_zeros((u.shape[0], u.shape[2], d_state), dtype=torch.float32)
    return h0.float()


def _finish(y, u, D):
    if D is not None:
        y = y + u.float() * D.float()
    return y.to(u.dtype)


def selective_scan_ref(u, dt, A, B, C, D=None, h0=None):
    """Per-timestep loop: the exact recurrence, the test oracle."""
    h = _h0(h0, u, A.shape[1])
    a, b = _coeffs(u, dt, A, B)
    Cf = C.float()
    ys = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bis,bs->bi", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else u.new_zeros(u.shape, dtype=torch.float32)
    return _finish(y, u, D), h


def _inclusive_scan(a, b):
    """Hillis-Steele inclusive scan of (a, b) -> (a2*a1, a2*b1 + b2) along dim 1."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def selective_scan(u, dt, A, B, C, D=None, h0=None, chunk: int = 32):
    """Chunked scan: sequential over time chunks carrying the fp32 state,
    a parallel (Hillis-Steele) scan inside each chunk.  Peak memory is
    O(chunk * B * d_inner * d_state)."""
    h = _h0(h0, u, A.shape[1])
    Cf = C.float()
    ys = []
    for t0 in range(0, u.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        a, b = _coeffs(u[:, sl], dt[:, sl], A, B[:, sl])
        a_cum, b_cum = _inclusive_scan(a, b)
        h_t = a_cum * h[:, None] + b_cum  # (B, T, d_inner, d_state)
        ys.append(torch.einsum("btis,bts->bti", h_t, Cf[:, sl]))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1) if ys else u.new_zeros(u.shape, dtype=torch.float32)
    return _finish(y, u, D), h


def selective_scan_step(h, u, dt, A, B, C, D=None):
    """Single-timestep update for streaming.

    h: (B, d_inner, d_state) fp32; u, dt: (B, d_inner); B, C: (B, d_state).
    Returns (h', y) with y in u's dtype.
    """
    dtf, uf = dt.float(), u.float()
    a = torch.exp(dtf[..., None] * A.float())
    h = a * h.float() + (dtf * uf)[..., None] * B.float()[:, None, :]
    y = torch.einsum("bis,bs->bi", h, C.float())
    if D is not None:
        y = y + uf * D.float()
    return h, y.to(u.dtype)
