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
against on the card.  The Mamba2 SSD form (``ssd_scan``, ``ssd_scan_grad``:
one scalar decay per head, chunked masked matmuls) has no kernel in either
package and runs as plain torch on both devices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch's CPU kernels for exp (and the other vectorised transcendentals)
# split a call of more than this many elements over the threads
_PARALLEL_GRAIN = 32768


def _warm_transcendentals() -> None:
    """Run torch's fp32 exp, log, tanh and sigmoid each once on the calling
    thread and once over every thread, so that no scan, softplus, gate or
    loss is the process's first of its kind.  It runs at import, not at a
    scan's first call: the model modules import this one (through the K1
    wrapper), so the transcendentals of the model code (``A =
    -exp(A_log)``, the softplus, the LSTM gates, the loss's log-magnitude)
    come after it too.

    The first multi-threaded fp32 ``torch.exp`` of a CPU process can come
    out wrong: with eight fresh processes at once on an 8-core host, the
    plain scan at (B 2, L 37, d_inner 200, d_state 8) as a process's first
    computation had ~3,500 of the 102,400 exponentials of its first chunk
    ~1e-4 off (y up to 5e-5 of its max) in 7 of 320 processes, and every
    later call right; after importing this module, 0 of 320
    (``scripts/torch_first_exp_probe.py``, whose other variants find none
    wrong after one exp or sin beforehand, with one thread, or with exp in
    float64).  log, tanh and sigmoid go through the same vectorised,
    thread-split kernels, and are warmed the same way.
    """
    small = torch.ones(8)
    large = torch.ones(_PARALLEL_GRAIN * max(torch.get_num_threads(), 1))
    for fn in (torch.exp, torch.log, torch.tanh, torch.sigmoid):
        fn(small)
        fn(large)


_warm_transcendentals()


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


# --------------------------------------------------------------------------
# Mamba2 SSD: the chunked masked-matmul form of a scan whose decay is one
# scalar per head and step (a_t = exp(dt_t * A_h)).  Plain torch (einsum on
# cuBLAS); the JAX package computes it outside any Pallas kernel too.
# --------------------------------------------------------------------------

def _ssd_pad_chunks(chunk, *tensors):
    """Zero-pad dim 1 to a multiple of ``chunk`` and split it into
    (n_chunks, B, chunk, ...) views, fp32."""
    L = tensors[0].shape[1]
    pad = -L % chunk
    out = []
    for t in tensors:
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        out.append(t.reshape(t.shape[0], -1, chunk, *t.shape[2:]).transpose(0, 1))
    return out


def _ssd_chunk_parts(xc, dtc, Bc, Cc, Ah, chunk):
    """Per-chunk quantities shared by the SSD forward and backward:
    (s, M, G, dx, decay_to_end) with
      s: (B, T, H) in-chunk cumsum of dt * A_h,
      M: (B, T, T, H) causal decay mask exp(s_t - s_tau), zero above the diagonal,
      G: (B, T, T) C B^T,
      dx: (B, T, H, P) dt-scaled inputs,
      decay_to_end: (B, T, H) exp(s_T - s_t).
    The mask is applied before the exponential (-inf above the diagonal),
    so no inf is formed there; the values equal exp-then-mask."""
    s = torch.cumsum(dtc * Ah, dim=1)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=s.device).tril()
    diff = s[:, :, None, :] - s[:, None, :, :]
    M = torch.exp(diff.masked_fill(~causal[None, :, :, None], float("-inf")))
    G = torch.einsum("btn,bsn->bts", Cc, Bc)
    dx = dtc[..., None] * xc
    decay_to_end = torch.exp(s[:, -1:, :] - s)
    return s, M, G, dx, decay_to_end


def _ssd_forward(x, dt, A_head, B, C, D_head, h0, chunk, keep_starts):
    Bsz, L, H, P = x.shape
    h = (x.new_zeros((Bsz, H, P, B.shape[-1]), dtype=torch.float32) if h0 is None
         else h0.float())
    Ah = A_head.float()
    ys, starts = [], []
    for xc, dtc, Bc, Cc in zip(*_ssd_pad_chunks(chunk, x, dt, B, C)):
        s, M, G, dx, decay_to_end = _ssd_chunk_parts(xc, dtc, Bc, Cc, Ah, chunk)
        y = torch.einsum("btsh,bshp->bthp", G[..., None] * M, dx)
        y = y + torch.exp(s)[..., None] * torch.einsum("btn,bhpn->bthp", Cc, h)
        if keep_starts:
            starts.append(h)  # the chunk's INCOMING state
        h = torch.exp(s[:, -1, :])[:, :, None, None] * h + torch.einsum(
            "bth,bthp,btn->bhpn", decay_to_end, dx, Bc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L] if ys else x.new_zeros(x.shape, dtype=torch.float32)
    if D_head is not None:
        y = y + x.float() * D_head.float()[None, None, :, None]
    return y.to(x.dtype), h, starts


def ssd_scan(x, dt, A_head, B, C, D_head=None, h0=None, chunk: int = 64):
    """Mamba2 SSD chunked scan (Dao & Gu 2024, "state-space duality").

    With s_t = cumsum(dt * A_h) inside a chunk:

        Y_intra = (M o (C B^T)) (dt . X),   M[t, tau] = exp(s_t - s_tau), tau <= t
        Y_state[t] = exp(s_t) . C_t h_in
        h_out = exp(s_T) h_in + sum_tau exp(s_T - s_tau) B_tau (x) (dt_tau x_tau)

    Chunks are walked in order carrying the fp32 state.

    x: (B, L, H, P); dt: (B, L, H) softplus'd; A_head: (H,) negative;
    B, C: (B, L, N) shared by the heads; D_head: (H,) or None; h0:
    (B, H, P, N) or None.  Returns (y (B, L, H, P) in x's dtype,
    h_last (B, H, P, N) fp32).  Autograd through this function saves every
    chunk's (B, T, T, H) mask: train through :func:`ssd_scan_grad`.
    """
    y, h, _ = _ssd_forward(x, dt, A_head, B, C, D_head, h0, chunk, keep_starts=False)
    return y, h


class SSDScanFn(torch.autograd.Function):
    """:func:`ssd_scan` with the hand-derived backward of the JAX package's
    ``ssd_scan_grad``: the forward saves only each chunk's incoming state,
    the backward recomputes the chunk's internals and runs the transposed
    masked matmuls right to left:

        gdx   = W^T gy + decay_to_end * (gH B)
        gG    = sum_hp M * (gy dx^T)          -> gC += gG B, gB += gG^T C
        gs    = collected from every exp(s ...) factor; gdt / gA from its
                reverse cumsum (s = cumsum(dt * A_h))
        gh_in = sum_t exp(s_t) C_t (x) gy_t + exp(s_T) gH   (the reverse carry)
    """

    @staticmethod
    def forward(ctx, x, dt, A_head, B, C, D_head, h0, chunk):
        y, h_last, starts = _ssd_forward(x, dt, A_head, B, C, D_head, h0, chunk,
                                         keep_starts=True)
        ctx.chunk = chunk
        ctx.has_D, ctx.has_h0 = D_head is not None, h0 is not None
        ctx.save_for_backward(x, dt, A_head, B, C, D_head, h0, torch.stack(starts))
        return y, h_last

    @staticmethod
    def backward(ctx, gy, gh_last):
        x, dt, A_head, B, C, D_head, h0, h_starts = ctx.saved_tensors
        chunk = ctx.chunk
        Bsz, L, H, P = x.shape
        if gy is None:
            gy = torch.zeros_like(x)
        gH = (torch.zeros_like(h_starts[0]) if gh_last is None else gh_last.float())
        Ah = A_head.float()
        gA = torch.zeros_like(Ah)
        chunks = list(zip(*_ssd_pad_chunks(chunk, x, dt, B, C, gy)))
        parts = []
        for c in reversed(range(len(chunks))):
            xc, dtc, Bc, Cc, gyc = chunks[c]
            h_in = h_starts[c]
            s, M, G, dx, decay_to_end = _ssd_chunk_parts(xc, dtc, Bc, Cc, Ah, chunk)
            es = torch.exp(s)  # (B, T, H)
            eT = es[:, -1, :]  # (B, H) = exp(s_T)

            # dx adjoint: W^T gy + decay_to_end * (gH B)
            W = G[..., None] * M
            gdx = torch.einsum("btsh,bthp->bshp", W, gyc)
            gdx = gdx + decay_to_end[..., None] * torch.einsum("bhpn,btn->bthp", gH, Bc)

            # G adjoint (contracting heads and headdim), then the B / C adjoints
            E = torch.einsum("bthp,bshp->btsh", gyc, dx)  # gy_t . dx_tau
            gG = torch.einsum("btsh,btsh->bts", E, M)
            gC = torch.einsum("bts,bsn->btn", gG, Bc)
            gB = torch.einsum("bts,btn->bsn", gG, Cc)
            gC = gC + torch.einsum("bth,bthp,bhpn->btn", es, gyc, h_in)
            gB = gB + torch.einsum("bth,bthp,bhpn->btn", decay_to_end, dx, gH)

            # s adjoint from every exp(s ...) factor
            gMM = E * G[..., None] * M
            gs = gMM.sum(dim=2) - gMM.sum(dim=1)  # + at t, - at tau
            gs = gs + es * torch.einsum("bthp,btn,bhpn->bth", gyc, Cc, h_in)
            w_state = decay_to_end * torch.einsum("bthp,btn,bhpn->bth", dx, Bc, gH)
            gs = gs - w_state
            gs[:, -1, :] += w_state.sum(dim=1) + eT * torch.einsum("bhpn,bhpn->bh", gH, h_in)

            # dt / A adjoints: s = cumsum(dt * A_h) -> gv = reverse cumsum of gs
            gv = gs.flip(1).cumsum(1).flip(1)
            gdt = Ah * gv + torch.einsum("bthp,bthp->bth", gdx, xc)
            gA = gA + torch.einsum("bth,bth->h", dtc, gv)
            parts.append((dtc[..., None] * gdx, gdt, gB, gC))

            # reverse state carry: the adjoint of this chunk's incoming state
            gH = torch.einsum("bth,btn,bthp->bhpn", es, Cc, gyc) + eT[:, :, None, None] * gH

        gx, gdt, gB, gC = (torch.cat(list(t[::-1]), dim=1)[:, :L] for t in zip(*parts))
        gD = None
        if ctx.has_D:
            gyf = gy.float()
            gx = gx + gyf * D_head.float()[None, None, :, None]
            gD = torch.einsum("bthp,bthp->h", gyf, x.float()).to(D_head.dtype)
        gh0 = gH.to(h0.dtype) if ctx.has_h0 else None
        return (gx.to(x.dtype), gdt.to(dt.dtype), gA.to(A_head.dtype), gB.to(B.dtype),
                gC.to(C.dtype), gD, gh0, None)


def ssd_scan_grad(x, dt, A_head, B, C, D_head=None, h0=None, chunk: int = 64):
    """:func:`ssd_scan` whose gradient is the memory-bounded hand-written
    backward of :class:`SSDScanFn` (the JAX package's ``ssd_scan_grad``)."""
    return SSDScanFn.apply(x, dt, A_head, B, C, D_head, h0, chunk)
