"""Exact sequence parallelism: one long waveform denoised across ranks (port
of ``cleanumamba_tpu/parallel/sequence.py``).

The time axis of an utterance is split over the mesh's ranks, and the
result is the single-device streaming output (zero-primed, below) to float
tolerance.  How each piece of sequential state crosses a segment boundary:

- **Raw context** (the encoder's receptive field and the bottleneck conv's
  warm-up): one send to the next rank of the last raw samples; every rank
  recomputes its boundary context from them.
- **SSM state**: closed-form segment composition.  Over a segment
  ``prod_t exp(dt_t A) = exp(A sum dt)``, so each rank publishes its
  segment transition and zero-state response (one all-gather a layer),
  folds the prefix to get its incoming state h0, and adds h0's response to
  its local scan.  The local scans are K1 on CUDA (``ops/cuda/
  selective_scan.py::selective_scan``, with its ``h_last``).
- **Decoder overlap-add tails**: absorbed.  Each rank decodes its 3 warm
  tokens too and drops their output samples, which hold every sample a
  missing boundary tail touches.
- **Input normalisation**: each rank computes its frames' stds, one
  all-gather builds the global EMA table, level 0 is recomputed per frame
  under its own EMA, and outputs rescale per frame.

The output equals streaming ``[zeros(ctx) | x]`` through ``stream_prime`` and
``stream_step_block`` on one device (``ctx = frame_length + 2 *
total_stride``: the stream warms up on silence), aligned back to x.  It
covers mamba, mamba2 (its per-head decay broadcast to the same composition)
and mamba_s4 (a constant transition: the dense matrix power ``dA^T`` of the
streaming step's own discrete system).  MHA (its sliding KV window spans
segments) and LSTM (a nonlinear recurrence) are refused.

Where JAX runs one program over ``shard_map``, each rank here is a process
of ``parallel.make_mesh``: a Python rank and an ``if`` take the place of the
traced ``axis_index`` and ``where``.  ``mesh=None`` runs one segment with no
collective (JAX's ``n_dev=1``).  Inference only: it runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models.bottleneck_mamba import mixer_dims
from cleanumamba_tpu_torch.models.bottleneck_mamba2 import mixer_geometry, split_zxbcdt
from cleanumamba_tpu_torch.models.bottleneck_s4 import _r2c, sp_discrete_system
from cleanumamba_tpu_torch.models.cleanumamba import decoder_level, encoder_level
from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan
from cleanumamba_tpu_torch.ops.norms import gated_rms_norm, layer_norm, rms_norm
from cleanumamba_tpu_torch.parallel.mesh import Mesh, all_gather, send_right
from cleanumamba_tpu_torch.params import resolve_device, tree_map
from cleanumamba_tpu_torch.streaming import _ema_stds, _level_lengths, _level_strides

_WARM = 3  # bottleneck conv warm-up tokens carried across the boundary (d_conv - 1)


class _Axis:
    """The ranks' segment axis: (group, size, index); one segment for None."""

    def __init__(self, mesh: Mesh | None):
        self.group, self.size, self.index = ((None, 1, 0) if mesh is None
                                             else (mesh.group, mesh.world, mesh.rank))

    def gather(self, x):
        return all_gather(x, self.group, self.size, self.index)

    def right(self, x):
        return send_right(x, self.group, self.size, self.index)


def _h0_response(dt_mine, C_mine, A, h0, chunk: int = 32):
    """y_corr[t] = sum_s C[t,s] exp(A[:,s] cd_t) h0[:,s] (cd the inclusive
    cumsum of dt).  dt (B,T,d_inner) fp32, C (B,T,d_state), A
    (d_inner,d_state), h0 (B,d_inner,d_state) -> (B,T,d_inner) fp32, in
    chunks of ``chunk`` steps so that the exponentials stay small."""
    cd = torch.cumsum(dt_mine.float(), dim=1)
    At = A.float().T  # (d_state, d_inner)
    h0_t = h0.float().transpose(-1, -2)  # (B, d_state, d_inner)
    Cf = C_mine.float()
    ys = []
    for t0 in range(0, cd.shape[1], chunk):
        cdc = cd[:, t0:t0 + chunk]
        e = torch.exp(cdc[:, :, None, :] * At[None, None])  # (B, c, s, i)
        ys.append(torch.einsum("bcsi,bcs->bci", e * h0_t[:, None], Cf[:, t0:t0 + chunk]))
    return torch.cat(ys, dim=1)


def _zero_padded_conv(xs_e, conv_w, conv_b):
    """Causal depthwise conv + SiLU over the extended tokens (zero left pad:
    the zero conv_state a fresh stream starts with)."""
    K = conv_w.shape[0]
    ctx = F.pad(xs_e, (0, 0, K - 1, 0))
    acc = torch.zeros_like(xs_e)
    for k in range(K):
        acc = acc + ctx[:, k: k + xs_e.shape[1], :] * conv_w[k].to(xs_e.dtype)
    return F.silu(acc + conv_b.to(xs_e.dtype))


def _scan(u, dt, A, B, C, D):
    """The zero-state selective scan of contiguous copies: K1 on CUDA."""
    return selective_scan(u.contiguous(), dt.contiguous(), A, B.contiguous(), C.contiguous(), D)


def _sp_scan_core(xs_e, dt_e, B_e, C_e, A, D, axis: _Axis, chunk):
    """Cross-rank selective scan over [warm | mine] tokens (mamba, and
    mamba2 with its decay broadcast to (d_inner, d_state)).  Returns
    (y_mine, y_warm) fp32, y_mine with the incoming state's response.  Rank
    0's published segment includes its zero-region warm tokens."""
    w = _WARM
    y0, h_loc = _scan(xs_e[:, w:], dt_e[:, w:], A, B_e[:, w:], C_e[:, w:], D)
    y_w, h_pre = _scan(xs_e[:, :w], dt_e[:, :w], A, B_e[:, :w], C_e[:, :w], D)
    dt_m = dt_e[:, w:]

    def seg_A(dt_part):
        return torch.exp(A[None] * dt_part.sum(dim=1)[..., None])

    A_m = seg_A(dt_m)
    first = axis.index == 0
    pub_A = seg_A(dt_e[:, :w]) * A_m if first else A_m
    pub_h = A_m * h_pre + h_loc if first else h_loc
    segs_A, segs_h = axis.gather(pub_A), axis.gather(pub_h)  # (n, B, i, s)
    h0 = torch.zeros_like(h_loc)
    for k in range(axis.index):
        h0 = segs_A[k] * h0 + segs_h[k]
    h0_mine = h_pre if first else h0
    y = y0.float() + _h0_response(dt_m, C_e[:, w:], A, h0_mine, chunk)
    return y, y_w.float()


def _s4_scan(dA, dB, dC, u, s0):
    """The streaming step's constant-coefficient recurrence
    (``models/bottleneck_s4.py::mixer_step``): ``s_t = dA s_{t-1} + dB u_t``,
    ``y_t = Re(dC s_t)``.  u (B,T,H) fp32, s0 (B,H,N) complex64.  Returns
    (y (B,T,H) fp32, s_T)."""
    s, ys = s0, []
    for t in range(u.shape[1]):
        s = torch.einsum("hmn,bhn->bhm", dA, s) + dB[None] * u[:, t, :, None].to(torch.complex64)
        ys.append(torch.einsum("chn,bhn->bch", dC, s).real[:, 0])
    return torch.stack(ys, dim=1), s


def _s4_mat_power(dA, T: int):
    """dA^T per feature, by repeated squaring."""
    out = torch.eye(dA.shape[-1], dtype=dA.dtype, device=dA.device).expand(dA.shape)
    base = dA
    while T:
        if T & 1:
            out = torch.einsum("hmn,hnk->hmk", base, out)
        base = torch.einsum("hmn,hnk->hmk", base, base)
        T >>= 1
    return out


def _sp_s4_core(u_e, sys, axis: _Axis):
    """Cross-rank constant-coefficient SSM over [warm | mine] inputs (B,
    WARM+T, H).  Returns (y_mine, y_warm) fp32 = Re(dC s), without the D
    skip.  The composition of :func:`_sp_scan_core` with the dense
    transition ``dA^T`` (``dA^{W+T}`` on rank 0), kept dense as
    ``sp_discrete_system`` explains."""
    w = _WARM
    dA, dB, dC = _r2c(sys["dA"]), _r2c(sys["dB"]), _r2c(sys["dC"])
    u_w, u_m = u_e[:, :w].float(), u_e[:, w:].float()
    Bz, T, H = u_m.shape
    s0 = torch.zeros((Bz, H, dA.shape[-1]), dtype=torch.complex64, device=u_e.device)
    y0_w, h_pre = _s4_scan(dA, dB, dC, u_w, s0)
    _, h_loc = _s4_scan(dA, dB, dC, u_m, s0)
    AT = _s4_mat_power(dA, T)
    first = axis.index == 0
    pub_A = torch.einsum("hmn,hnk->hmk", AT, _s4_mat_power(dA, w)) if first else AT
    pub_h = torch.einsum("hmn,bhn->bhm", AT, h_pre) + h_loc if first else h_loc
    segs_A, segs_h = axis.gather(pub_A), axis.gather(pub_h)
    h0 = torch.zeros_like(h_loc)
    for k in range(axis.index):
        h0 = torch.einsum("hmn,bhn->bhm", segs_A[k], h0) + segs_h[k]
    y_m, _ = _s4_scan(dA, dB, dC, u_m, h_pre if first else h0)
    return y_m, y0_w


def _sp_mixer_s4(p, hidden_ext, axis: _Axis, sys):
    """One MambaS4 mixer over [warm | mine] tokens (``mixer_step``'s math);
    only the linear SSM crosses the boundary."""
    d_inner = p["conv_w"].shape[1]
    x = hidden_ext
    xz = x @ p["in_proj"].to(x.dtype)
    xs_e, z_e = xz[..., :d_inner], xz[..., d_inner:]
    xs_e = _zero_padded_conv(xs_e, p["conv_w"], p["conv_b"])
    u_e = xs_e @ p["input_linear_w"].to(xs_e.dtype) + p["input_linear_b"].to(xs_e.dtype)
    w = _WARM
    y_m, y_w = _sp_s4_core(u_e, sys, axis)
    D = p["ssm_D"].float()[0]  # (H,), C = 1

    def tail(y_lin, u_part, z_part):
        y = y_lin + u_part.float() * D[None, None]
        y = F.gelu(y.to(x.dtype))  # exact (erf) form, as the step
        y = y @ p["output_linear_w"].to(x.dtype) + p["output_linear_b"].to(x.dtype)
        half = y.shape[-1] // 2
        y = y[..., :half] * torch.sigmoid(y[..., half:]) * F.silu(z_part)
        return y @ p["out_proj"].to(y.dtype)

    return tail(y_m, u_e[:, w:], z_e[:, w:]), tail(y_w, u_e[:, :w], z_e[:, :w])


def _sp_mixer(p, hidden_ext, axis: _Axis, chunk):
    """One Mamba mixer over [warm | mine] tokens (B, WARM + N, d_model).
    Returns (out_mine (B, N, d_model), the warm tokens' outputs)."""
    _, d_inner, d_state, dt_rank, _ = mixer_dims(p)
    x = hidden_ext
    xz = x @ p["in_proj"].to(x.dtype)
    xs_e, z_e = xz[..., :d_inner], xz[..., d_inner:]
    xs_e = _zero_padded_conv(xs_e, p["conv_w"], p["conv_b"])
    dbc = xs_e @ p["x_proj"].to(xs_e.dtype)
    dt_e = dbc[..., :dt_rank] @ p["dt_proj_w"].to(x.dtype) + p["dt_proj_b"].to(x.dtype)
    dt_e = F.softplus(dt_e.float())
    B_e, C_e = dbc[..., dt_rank: dt_rank + d_state], dbc[..., dt_rank + d_state:]
    A = -torch.exp(p["A_log"].float())
    w = _WARM
    y, y_w = _sp_scan_core(xs_e, dt_e, B_e, C_e, A, p["D"].float(), axis, chunk)
    out_mine = (y.to(x.dtype) * F.silu(z_e[:, w:])) @ p["out_proj"].to(x.dtype)
    warm = (y_w.to(x.dtype) * F.silu(z_e[:, :w])) @ p["out_proj"].to(x.dtype)
    return out_mine, warm


def _sp_mixer2(p, hidden_ext, axis: _Axis, chunk):
    """The Mamba2 (SSD) mixer over [warm | mine] tokens: the per-head decay
    broadcast to (d_inner, d_state), as ``mixer_step`` does, composes like
    mamba's."""
    _, d_inner, d_state, _, headdim = mixer_geometry(p)
    x = hidden_ext
    z_e, xBC, dt_h = split_zxbcdt(p, x @ p["in_proj"].to(x.dtype))
    xBC = _zero_padded_conv(xBC, p["conv_w"], p["conv_b"])
    xs_e = xBC[..., :d_inner]
    B_e = xBC[..., d_inner: d_inner + d_state]
    C_e = xBC[..., d_inner + d_state:]
    dt_h = F.softplus(dt_h.float() + p["dt_bias"].float())
    dt_e = dt_h.repeat_interleave(headdim, dim=-1)  # (B, T, d_inner)
    A_head = -torch.exp(p["A_log"].float())
    A = A_head.repeat_interleave(headdim)[:, None].expand(d_inner, d_state).contiguous()
    D = p["D"].float().repeat_interleave(headdim)
    w = _WARM
    y, y_w = _sp_scan_core(xs_e, dt_e, B_e, C_e, A, D, axis, chunk)
    out_mine = gated_rms_norm(y.to(x.dtype), z_e[:, w:], p["norm_w"]) @ p["out_proj"].to(x.dtype)
    warm = gated_rms_norm(y_w.to(x.dtype), z_e[:, :w], p["norm_w"]) @ p["out_proj"].to(x.dtype)
    return out_mine, warm


def _ema_table(window, cfg, axis: _Axis, N, off):
    """The global per-frame normalisation EMA, alike on every rank: each
    rank's N frames' stds (full windows: the halo covers the look-back),
    the stream's 3 zero-region warm frames at exactly 1e-3, one all-gather
    of (B, N) scalars, then the EMA fold (``streaming._ema_stds``) from the
    stream's start.  Returns (B, 3 + n*N)."""
    ts, fl = cfg.total_stride, cfg.frame_length
    # the window leads the padded stream by `off` samples; my frames are
    # u = WARM..WARM+N-1 in window coordinates
    idx = ((torch.arange(N)[:, None] + _WARM) * ts + off + torch.arange(fl)[None, :]).to(
        window.device)
    stds = window.float()[:, idx].std(dim=2, correction=0) + 1e-3  # jnp.std: population
    B = stds.shape[0]
    flat = axis.gather(stds).movedim(0, 1).reshape(B, -1)  # (B, n*N)
    warm0 = torch.full((B, _WARM), 1e-3, dtype=torch.float32, device=window.device)
    all_f = torch.cat([warm0, flat], dim=1)
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=window.device)
    return _ema_stds(all_f[..., None], zeros, zeros)


def _level0_normalized(params, cfg, window, ema, index, N, dtype, off):
    """The level-0 buffer under per-frame normalisation, stream-exact: each
    frame contributes strides[0] outputs from its end-aligned slice divided
    by its own EMA (``stream_step_block``'s normalised branch), with 2
    history frames.  Rank 0's history predates the stream, whose frame 0
    was primed (the whole first frame under std_0): that variant is built
    on rank 0 alone."""
    K, S = cfg.kernel_size, cfg.stride
    ts, fl = cfg.total_stride, cfg.frame_length
    s0 = S ** (cfg.encoder_n_layers - 1)
    lens0 = (fl - K) // S + 1
    pfl = K + S * (s0 - 1)  # per-frame slice length
    B = window.shape[0]
    n_fr = N + _WARM + 2  # history (2) + warm (3) + mine (N)
    need = lens0 + (N + _WARM - 1) * s0
    # the EMAs of my n_fr frames: global frames index*N - 2 + [0, n_fr); two
    # leading entries stand for rank 0's phantom history
    table = torch.cat([torch.ones((B, 2), dtype=torch.float32, device=window.device), ema], 1)
    e_hist = table[:, index * N: index * N + n_fr]
    starts = torch.arange(-2, N + _WARM)[:, None] * ts + fl - pfl + off
    slices = window[:, (starts + torch.arange(pfl)[None, :]).to(window.device)]
    slices = (slices / e_hist[..., None]).to(dtype)
    out = encoder_level(params["encoder"][0], slices.reshape(B * n_fr, pfl, 1), cfg, 0)
    if index != 0:
        return out.reshape(B, n_fr * s0, -1)[:, -need:]
    # rank 0: frame 0 primed (global frame 0 is the zero-region prime)
    frame0 = window[:, off: off + fl] / ema[:, :1]
    prime0 = encoder_level(params["encoder"][0], frame0[..., None].to(dtype), cfg, 0)
    steps0 = out.reshape(B, n_fr, s0, -1)[:, 3:]  # frames u = 1 .. N + WARM - 1
    buf = torch.cat([prime0, steps0.reshape(B, (n_fr - 3) * s0, -1)], dim=1)
    assert buf.shape[1] == need, (buf.shape, need)
    return buf


def _norm(p, x, cfg):
    if cfg.rms_norm:
        return rms_norm(x, p["scale"], cfg.norm_epsilon)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_epsilon)


def _sp_shard(params, cfg: CleanUMambaConfig, x_local, axis: _Axis, dtype, chunk, extras=()):
    """One rank's program.  x_local: (B, N*ts) raw samples of its segment.
    extras: each layer's replicated discrete system (mamba_s4, from
    ``sp_discrete_system``; empty otherwise)."""
    K, S, D = cfg.kernel_size, cfg.stride, cfg.encoder_n_layers
    ts, fl = cfg.total_stride, cfg.frame_length
    N = x_local.shape[1] // ts
    # halo: the encoder's receptive field and the bottleneck warm-up, plus
    # enough raw samples that the 2 history frames' level-0 slices fit
    pfl = K + S * (S ** (D - 1) - 1)
    extra = max(0, 2 * ts + pfl - fl)
    ctx_len = fl + (_WARM - 1) * ts + extra
    window = torch.cat([axis.right(x_local[:, -ctx_len:].contiguous()), x_local], dim=1)

    # encoder: level i yields the stream's [cache | new] buffer for a
    # (N + WARM)-frame block, sliced from the end
    lens, strides = _level_lengths(cfg), _level_strides(cfg)
    skips = []
    if cfg.normalize_input:
        ema = _ema_table(window, cfg, axis, N, extra)
        xx = _level0_normalized(params, cfg, window, ema, axis.index, N, dtype, extra)
        skips.append(xx)
        start = 1
    else:
        xx = window[..., None].to(dtype)
        start = 0
    for i, ep in list(enumerate(params["encoder"]))[start:]:
        xx = encoder_level(ep, xx, cfg, i)[:, -(lens[i] + (N + _WARM - 1) * strides[i]):]
        skips.append(xx)
    tokens_ext = skips[-1]  # (B, N + WARM, C_last)
    assert tokens_ext.shape[1] == N + _WARM, tokens_ext.shape
    z_ext = tokens_ext @ params["tsfm_conv1"]["w"][0].to(dtype) \
        + params["tsfm_conv1"]["b"].to(dtype)

    # bottleneck: the residual stream over [warm | mine]; the warm context is
    # the previous rank's corrected last tokens, sent right each layer
    # (rank 0 keeps its own zero-region values)
    bp = params["bottleneck"]
    w = _WARM
    first = axis.index == 0
    hid_m, res_m = z_ext[:, w:], torch.zeros(z_ext[:, w:].shape, device=z_ext.device)
    hid_w, res_w = z_ext[:, :w], torch.zeros(z_ext[:, :w].shape, device=z_ext.device)
    for li, lp in enumerate(bp["layers"]):
        res_ext = torch.cat([res_w, res_m], 1) + torch.cat([hid_w, hid_m], 1).float()
        hidden_ext = _norm(lp["norm"], res_ext, cfg).to(dtype)
        if cfg.bottleneck == "mamba_s4":
            out_m, warm_local = _sp_mixer_s4(lp["mixer"], hidden_ext, axis, extras[li])
        else:
            mixer = _sp_mixer2 if cfg.bottleneck == "mamba2" else _sp_mixer
            out_m, warm_local = mixer(lp["mixer"], hidden_ext, axis, chunk)
        res_m = res_ext[:, w:]
        res_w_next = axis.right(res_m[:, -w:].contiguous())
        hid_w_next = axis.right(out_m[:, -w:].contiguous())
        res_w = res_ext[:, :w] if first else res_w_next
        hid_w = warm_local if first else hid_w_next
        hid_m = out_m
    res_ext = torch.cat([res_w, res_m], 1) + torch.cat([hid_w, hid_m], 1).float()
    tokens_out = _norm(bp["norm_f"], res_ext, cfg).to(dtype)

    # decoder over all N + WARM tokens; the dropped warm region absorbs the
    # missing cross-boundary overlap-add tails (< 2*ts < WARM*ts samples)
    xx = tokens_out @ params["tsfm_conv2"]["w"][0].to(dtype) + params["tsfm_conv2"]["b"].to(dtype)
    rev_skips = skips[::-1]
    for j, dp in enumerate(params["decoder"]):
        xx = xx + rev_skips[j][:, : xx.shape[1], :]
        xx = decoder_level(dp, xx, cfg, D - 1 - j, relu=False)[:, :-S, :]
        if j != D - 1:
            xx = torch.relu(xx)
    out = xx[:, w * ts: (N + w) * ts, 0]
    if cfg.normalize_input:
        e_mine = ema[:, _WARM + axis.index * N: _WARM + (axis.index + 1) * N]
        out = (out.reshape(out.shape[0], N, ts) * e_mine[..., None].to(out.dtype)).reshape(
            out.shape[0], N * ts)
    return out


def sp_stream_denoise(params, cfg: CleanUMambaConfig, x, mesh: Mesh | None = None,
                      device=None, dtype=torch.float32, chunk: int = 32):
    """Denoise (B, L) waveforms with the time axis split over the mesh's
    ranks (each rank is one segment); ``mesh=None``: one segment, no
    collective.  Every rank passes the whole ``x`` (numpy or tensor) and
    gets the whole output, a tensor on ``device`` (None: the mesh's device,
    or ``params.default_device()`` without a mesh).  It matches
    single-device zero-primed streaming of the same signal, aligned to x;
    the tail shorter than the model's look-ahead is zero-padded internally
    as ``Streamer.flush`` does.  ``params`` are moved to ``device``.
    """
    if cfg.bottleneck not in ("mamba", "mamba2", "mamba_s4"):
        raise NotImplementedError(
            "sequence parallelism: mamba/mamba2/mamba_s4 bottlenecks only "
            "(MHA's sliding KV window can span many segments and LSTM's "
            "nonlinear recurrence has no closed-form segment transition)")
    for lp in params["bottleneck"]["layers"]:
        d_conv = lp["mixer"]["conv_w"].shape[0]
        if d_conv - 1 > _WARM:
            raise NotImplementedError(
                f"d_conv={d_conv} needs {d_conv - 1} warm tokens; "
                f"sequence parallelism carries {_WARM}"
            )
    device = mesh.device if device is None and mesh is not None else resolve_device(device)
    params = tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, params)
    extras = ()
    if cfg.bottleneck == "mamba_s4":
        # once a call, on the host: each layer's constant discrete system
        extras = []
        for lp in params["bottleneck"]["layers"]:
            sys = sp_discrete_system(lp["mixer"])
            if sys["dC"].shape[0] != 1:
                raise NotImplementedError(
                    f"sequence parallelism assumes n_ssm_channels == 1, got {sys['dC'].shape[0]}")
            extras.append({k: v.to(device) for k, v in sys.items()})
    axis = _Axis(mesh)
    ts, fl = cfg.total_stride, cfg.frame_length
    K, S, D = cfg.kernel_size, cfg.stride, cfg.encoder_n_layers
    x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x)
    B, L = x.shape
    # right-pad so that every output position of x is covered (look-ahead
    # fl - ts) and the padded length splits evenly into n * k * ts
    n = axis.size
    total = -(-(L + fl - ts) // (n * ts)) * (n * ts)
    # each segment must cover the halo it sends right: a short input pads up
    pfl = K + S * (S ** (D - 1) - 1)
    ctx_len = fl + (_WARM - 1) * ts + max(0, 2 * ts + pfl - fl)
    min_per_dev = max(-(-ctx_len // ts) * ts, _WARM * ts)
    if total // n < min_per_dev:
        total = n * min_per_dev
    xp = F.pad(x.to(device=device, dtype=torch.float32), (0, total - L))
    seg = total // n
    with torch.inference_mode():
        y = _sp_shard(params, cfg, xp[:, axis.index * seg: (axis.index + 1) * seg], axis,
                      dtype, chunk, extras)
        y = axis.gather(y.contiguous()).movedim(0, 1).reshape(B, total)
    # positions [w*ts, w*ts + total) of the padded stream; x's outputs sit
    # fl - ts later than the block start (the zero-prime offset)
    return y[:, fl - ts: fl - ts + L]
