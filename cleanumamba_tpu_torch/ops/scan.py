"""Selective state-space scan, plain PyTorch (port of ``cleanumamba_tpu/ops/scan.py``).

With diagonal ``A`` (d_inner, d_state) and fp32 state h (B, d_inner, d_state):

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = <h_t, C_t> + D * u_t

Contract of every scan here: ``y, h_last = scan(u, dt, A, B, C, D, h0)``
with u, dt (B, L, d_inner); B, C (B, L, d_state); D (d_inner,) or None;
h0 (B, d_inner, d_state) or None.  The state math is fp32 whatever the
input dtype; y comes back in u's dtype and h_last in fp32.

These are the plain versions: the CPU path, and the references the CUDA
kernels (``ops/cuda/selective_scan.py``: K1 forward, K2 backward) are held
against on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def selective_scan(u, dt, A, B, C, D=None, h0=None, chunk: int = 32,
                   return_starts: bool = False):
    """Chunked scan: sequential over time chunks carrying the fp32 state,
    a parallel (Hillis-Steele) scan inside each chunk.  Peak memory is
    O(chunk * B * d_inner * d_state).

    With ``return_starts`` it also returns the state entering each chunk,
    h_starts (B, n_chunks, d_inner, d_state) fp32: what
    :func:`selective_scan_bwd` recomputes each chunk from."""
    h = _h0(h0, u, A.shape[1])
    Cf = C.float()
    ys, starts = [], []
    for t0 in range(0, u.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        starts.append(h)
        a, b = _coeffs(u[:, sl], dt[:, sl], A, B[:, sl])
        a_cum, b_cum = _inclusive_scan(a, b)
        h_t = a_cum * h[:, None] + b_cum  # (B, T, d_inner, d_state)
        ys.append(torch.einsum("btis,bts->bti", h_t, Cf[:, sl]))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1) if ys else u.new_zeros(u.shape, dtype=torch.float32)
    if not return_starts:
        return _finish(y, u, D), h
    h_starts = torch.stack(starts, dim=1) if starts else h.new_zeros((h.shape[0], 0, *h.shape[1:]))
    return _finish(y, u, D), h, h_starts


def selective_scan_bwd(u, dt, A, B, C, D, h_starts, gy, gh_last, chunk: int = 32):
    """VJP of :func:`selective_scan` (port of ``cleanumamba_tpu/ops/scan.py::
    _ssg_bwd``): (gu, gdt, gA, gB, gC, gD, gh0) from the output cotangents
    gy (B, L, d_inner) and gh_last (B, d_inner, d_state), given the chunk
    states ``h_starts`` that the forward saved at the SAME ``chunk``.

    Chunks are walked right to left.  In each, h is recomputed from its
    incoming state, and the adjoint lambda_t = gy_t (x) C_t + a_{t+1} lambda_{t+1}
    runs as the same pair scan in reversed time, seeded with the carry from
    the chunk on the right (gh_last at the end).  a_{t+1} comes from dt
    shifted left one step, with dt = 0 (a = 1) past the end.  gu, gB, gC come
    back in the dtype of u, B, C; gdt, gA, gD, gh0 in fp32; gD is None when
    D is.  Peak memory: a few (B, chunk, d_inner, d_state) fp32 tensors.
    """
    Bsz, L, _ = u.shape
    n_chunks = h_starts.shape[1]
    pad = n_chunks * chunk - L
    Af = A.float()
    uf, dtf, Bf, Cf, gyf = (x.float() for x in (u, dt, B, C, gy))
    u_p, dt_p, B_p, C_p, gy_p = (F.pad(x, (0, 0, 0, pad)) if pad else x
                                 for x in (uf, dtf, Bf, Cf, gyf))
    dt_next = torch.cat([dt_p[:, 1:], torch.zeros_like(dt_p[:, :1])], dim=1)

    lam_next = gh_last.float()  # lambda at the step after the chunk
    gA = torch.zeros_like(Af)
    parts = []
    for c in reversed(range(n_chunks)):
        sl = slice(c * chunk, (c + 1) * chunk)
        uc, dtc, Bc, Cc, gyc = (x[:, sl] for x in (u_p, dt_p, B_p, C_p, gy_p))
        a, b = _coeffs(uc, dtc, Af, Bc)
        h_start = h_starts[:, c].float()
        a_cum, b_cum = _inclusive_scan(a, b)
        h = a_cum * h_start[:, None] + b_cum  # (B, T, d_inner, d_state)
        h_prev = torch.cat([h_start[:, None], h[:, :-1]], dim=1)
        a_next = torch.exp(dt_next[:, sl, :, None] * Af)
        q = gyc[..., None] * Cc[:, :, None, :]
        acum, qcum = _inclusive_scan(a_next.flip(1), q.flip(1))
        lam = (acum * lam_next[:, None] + qcum).flip(1)  # lambda_t
        lha = lam * h_prev * a
        lamB = torch.einsum("btis,bts->bti", lam, Bc)
        gdt = torch.einsum("btis,is->bti", lha, Af) + lamB * uc
        parts.append((dtc * lamB, gdt,
                      torch.einsum("btis,bti->bts", lam, dtc * uc),
                      torch.einsum("btis,bti->bts", h, gyc)))
        gA += torch.einsum("btis,bti->is", lha, dtc)
        lam_next = lam[:, 0]

    gu, gdt, gB, gC = (torch.cat(list(x[::-1]), dim=1)[:, :L] for x in zip(*parts))
    gD = None
    if D is not None:
        gu = gu + gyf * D.float()
        gD = torch.einsum("bti,bti->i", gyf, uf)
    gh0 = torch.exp(dtf[:, 0, :, None] * Af) * lam_next  # a_0 * lambda_0
    return gu.to(u.dtype), gdt, gA, gB.to(B.dtype), gC.to(C.dtype), gD, gh0


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
