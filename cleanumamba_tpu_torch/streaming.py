"""Constant-memory streaming inference (port of ``cleanumamba_tpu/streaming.py``),
all five bottleneck families.

Per frame of ``frame_length`` samples the model emits ``total_stride``
output samples.  The carried state is a dict:

- ``input_tail``: the last (frame_length - total_stride) raw input samples;
- ``input_std`` (B, 1) / ``frames`` (B, 1) int32: the per-session running
  normalisation EMA and frame counter;
- ``enc[i]``: the cached suffix of encoder level i's frame output;
- ``dec[j]``: decoder overlap-add tails, stored *minus the ConvTranspose
  bias* so the bias is not added twice when the next frame lands on them;
- ``bottleneck``: per-layer mixer caches (conv_state and fp32 ssm_state for
  mamba and mamba2, h and fp32 c for lstm, conv_state, the complex s4_state
  as (re, im) pairs and its discrete system for mamba_s4) or, for mha, the
  ring KV caches of every layer and one shared position.

At level i each frame produces ``S^(D-1-i)`` new outputs from the last
``K + S*(S^(D-1-i) - 1)`` samples of the previous level's frame output.

Kernels on this path: the block step's mamba and mamba2 bottlenecks run the
selective-scan kernel (K1) for CUDA tensors; the single-frame step of a
model that packs whole (``pack_mega``: the small released geometry) is one
launch of the whole-frame kernel (K5, ``stream_step_mega``); otherwise it
runs every packed encoder/decoder level through the fused level kernels
(K3/K4) when given ``packs``.  ``Streamer`` chooses (``fused``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import bottleneck_lstm, bottleneck_mamba2, bottleneck_mha
from cleanumamba_tpu_torch.models.bottleneck_mamba import mixer_dims, ssm_inputs
from cleanumamba_tpu_torch.models.cleanumamba import (
    STEP_MIXERS,
    decoder_level,
    encoder_level,
    pointwise,
    residual_stack,
)
from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan
from cleanumamba_tpu_torch.ops.cuda.stream_fused import (
    encoder_windows,
    fused_decoder_level,
    fused_encoder_level,
    pack_stream_params,
)
from cleanumamba_tpu_torch.ops.cuda.stream_mega import level_lengths as _level_lengths
from cleanumamba_tpu_torch.ops.cuda.stream_mega import mega_stream_frame, pack_mega
from cleanumamba_tpu_torch.ops.norms import gated_rms_norm
from cleanumamba_tpu_torch.params import (
    prepare_weight_view,
    resolve_device,
    to_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _level_strides(cfg: CleanUMambaConfig) -> List[int]:
    """New outputs per frame at each level = S^(D-1-i)."""
    D, S = cfg.encoder_n_layers, cfg.stride
    return [S ** (D - 1 - i) for i in range(D)]


# --------------------------------------------------------------------------
# Bottleneck
# --------------------------------------------------------------------------

def _bottleneck_init_cache(params, cfg: CleanUMambaConfig, batch: int, dtype, device):
    bp = params["bottleneck"]
    if cfg.bottleneck == "lstm":
        return bottleneck_lstm.init_cache(bp["layers"], batch, dtype, device)
    if cfg.bottleneck == "mha":
        return bottleneck_mha.init_cache(bp, cfg, batch, bottleneck_mha.mha_max_len(cfg), dtype,
                                         device)
    mixer = STEP_MIXERS[cfg.bottleneck]
    return [mixer.mixer_init_cache(lp["mixer"], batch, dtype, device) for lp in bp["layers"]]


def _bottleneck_step(params, cfg: CleanUMambaConfig, cache, x):
    """x: (B, d_model) single bottleneck token -> (cache', y)."""
    bp = params["bottleneck"]
    if cfg.bottleneck == "lstm":
        return bottleneck_lstm.step(bp["layers"], cache, x)
    if cfg.bottleneck == "mha":
        return bottleneck_mha.step(bp, cfg, cache, x)
    mixer_step = STEP_MIXERS[cfg.bottleneck].mixer_step
    new_cache = []

    def mixer(l, mp, h):
        nc, out = mixer_step(mp, cache[l], h)
        new_cache.append(nc)
        return out

    return new_cache, residual_stack(params["bottleneck"], x, cfg, mixer)


def _rolling_depthwise_conv(conv_state, xs, conv_w, conv_b, N):
    """Causal depthwise conv over N tokens with the carried conv_state (the
    last d_conv inputs).  Returns (pre-activation (B, N, C), new conv_state)."""
    ctx = torch.cat([conv_state[:, 1:, :].to(xs.dtype), xs], dim=1)
    w = conv_w.to(xs.dtype)
    acc = torch.zeros_like(xs)
    for k in range(w.shape[0]):
        acc = acc + ctx[:, k : k + N, :] * w[k]
    return acc + conv_b.to(xs.dtype), ctx[:, -conv_state.shape[1]:, :]


def _mamba_mixer_tokens(p, lc, hidden):
    """N Mamba mixer tokens as one selective scan from the carried state."""
    _, d_inner, _, _, _ = mixer_dims(p)
    xz = hidden @ p["in_proj"].to(hidden.dtype)
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    pre, new_conv_state = _rolling_depthwise_conv(
        lc["conv_state"], xs, p["conv_w"], p["conv_b"], hidden.shape[1])
    xs = torch.nn.functional.silu(pre)
    dt, Bm, Cm, A = ssm_inputs(p, xs)
    y, h_last = selective_scan(xs, dt, A, Bm, Cm, p["D"].float(), lc["ssm_state"])
    hidden = (y * torch.nn.functional.silu(z)) @ p["out_proj"].to(y.dtype)
    return {"conv_state": new_conv_state, "ssm_state": h_last}, hidden


def _mamba2_mixer_tokens(p, lc, hidden):
    """N Mamba-2 (SSD) mixer tokens as one selective scan from the carried
    state: the scalar-per-head decay broadcast to A[i, s] = a_head(i // headdim),
    the same form as ``bottleneck_mamba2.mixer_step``, so a block equals N steps."""
    z, xBC, dt_h = bottleneck_mamba2.split_zxbcdt(p, hidden @ p["in_proj"].to(hidden.dtype))
    pre, new_conv_state = _rolling_depthwise_conv(
        lc["conv_state"], xBC, p["conv_w"], p["conv_b"], hidden.shape[1])
    xs, dt, A, Bm, Cm, D = bottleneck_mamba2.ssm_inputs(
        p, torch.nn.functional.silu(pre), dt_h)
    y, h_last = selective_scan(xs, dt, A, Bm, Cm, D, lc["ssm_state"])
    hidden = gated_rms_norm(y, z, p["norm_w"]) @ p["out_proj"].to(y.dtype)
    return {"conv_state": new_conv_state, "ssm_state": h_last}, hidden


def _bottleneck_tokens(params, cfg: CleanUMambaConfig, cache, x):
    """N bottleneck tokens (B, N, d_model) with carried state.  mamba and
    mamba2 with N > 1: one selective scan per layer with h0 = the carried
    state (K1 on CUDA).  Otherwise (lstm, mha, mamba_s4, or one token) a loop
    of single-token steps."""
    N = x.shape[1]
    if cfg.bottleneck in ("mamba", "mamba2") and N > 1:
        mixer_tokens = (_mamba_mixer_tokens if cfg.bottleneck == "mamba"
                        else _mamba2_mixer_tokens)
        new_cache = []

        def mixer(l, mp, h):
            nc, out = mixer_tokens(mp, cache[l], h)
            new_cache.append(nc)
            return out

        return new_cache, residual_stack(params["bottleneck"], x, cfg, mixer)
    ys = []
    for t in range(N):
        cache, y = _bottleneck_step(params, cfg, cache, x[:, t])
        ys.append(y)
    return cache, torch.stack(ys, dim=1)


# --------------------------------------------------------------------------
# Decoder, shared by prime, step and block step
# --------------------------------------------------------------------------

def _overlap_decoder_level(dp, cfg, j, x, skip, prev):
    """Decoder level j on the new tokens x: skip-add, mix + GLU + convT, then
    the overlap-add of the carried tail ``prev`` (or None) and the ReLU (not
    at the last level).  Returns (out, next tail stored minus the convT bias)."""
    D, S = cfg.encoder_n_layers, cfg.stride
    x = decoder_level(dp, x + skip[:, : x.shape[1], :], cfg, D - 1 - j, relu=False)
    tail = x[:, -S:, :] - dp["convt_b"].to(x.dtype)
    x = x[:, :-S, :]
    if prev is not None:
        x = torch.cat([x[:, :S, :] + prev, x[:, S:, :]], dim=1)
    return (torch.relu(x) if j != D - 1 else x), tail


def _decode_frame(params, cfg, skips, bott_cache, dec_caches, dtype, packs=None):
    """From one frame's level-wise skips to total_stride samples.

    skips[i]: (B, len_i, C_i) frame output of encoder level i.  Returns
    (bott_cache', dec_caches', out (B, total_stride, 1)).  Levels packed in
    ``packs`` (see ``pack_stream_params``) run as the fused decoder kernel
    (K4 on CUDA); the dec cache layout (B, S, Cout) is shared by both paths.
    """
    D, S = cfg.encoder_n_layers, cfg.stride
    x = pointwise(params["tsfm_conv1"], skips[-1])
    bott_cache, y = _bottleneck_step(params, cfg, bott_cache, x[:, 0, :])
    x = pointwise(params["tsfm_conv2"], y[:, None, :])

    new_dec = []
    rev_skips = skips[::-1]
    for j, dp in enumerate(params["decoder"]):
        pk = packs[1]["dec"][j] if packs is not None else None
        prev = dec_caches[j] if dec_caches is not None else None
        if pk is None:
            x, tail = _overlap_decoder_level(dp, cfg, j, x, rev_skips[j], prev)
            new_dec.append(tail)
            continue
        B, T, Cout = x.shape[0], x.shape[1], pk["Cout"]
        prev_g = prev.reshape(B, 1, S * Cout) if prev is not None else None
        out_g, tail_g = fused_decoder_level(
            x.contiguous(), rev_skips[j][:, :T, :].contiguous(), prev_g,
            packs[0]["dec"][j], pk, relu=j != D - 1)
        new_dec.append(tail_g.reshape(B, S, Cout).to(dtype))
        x = out_g.reshape(B, T * S, Cout).to(dtype)
    return bott_cache, new_dec, x


# --------------------------------------------------------------------------
# Prime (first frame), single-frame step, block step
# --------------------------------------------------------------------------

def _std(x, dim):
    """Population std (jnp.std) + 1e-3, fp32."""
    return x.float().std(dim=dim, keepdim=True, correction=0) + 1e-3


def stream_prime(params, cfg: CleanUMambaConfig, frame, dtype=torch.float32):
    """Process the first frame (B, frame_length).  Returns (state, out (B, total_stride))."""
    B = frame.shape[0]
    if frame.shape[1] != cfg.frame_length:
        raise ValueError(f"stream_prime needs {cfg.frame_length} samples, got {frame.shape[1]}")
    strides = _level_strides(cfg)
    x = frame[..., None].to(dtype)
    if cfg.normalize_input:
        std = _std(frame, 1)
        x = x / std[..., None].to(dtype)
    else:
        std = torch.ones((B, 1), dtype=torch.float32, device=frame.device)

    skips, enc_caches = [], []
    for i, ep in enumerate(params["encoder"]):
        x = encoder_level(ep, x, cfg, i)
        skips.append(x)
        enc_caches.append(x[:, strides[i]:, :])

    bott_cache = _bottleneck_init_cache(params, cfg, B, dtype, frame.device)
    bott_cache, dec_caches, out = _decode_frame(params, cfg, skips, bott_cache, None, dtype)
    out = out[:, : cfg.total_stride, 0]
    if cfg.normalize_input:
        out = out * std.to(out.dtype)
    state = {
        "input_tail": frame[:, cfg.total_stride:],
        "input_std": std,
        # per-session counter: the EMA weight 1/n restarts for each session
        "frames": torch.ones((B, 1), dtype=torch.int32, device=frame.device),
        "enc": enc_caches,
        "dec": dec_caches,
        "bottleneck": bott_cache,
    }
    return state, out


def stream_step(params, cfg: CleanUMambaConfig, state, new_samples,
                dtype=torch.float32, packs=None):
    """Consume total_stride new samples (B, total_stride), emit as many.

    packs: ``pack_stream_params`` output; packed encoder levels run window
    GEMM + ReLU + mix + GLU as the fused encoder kernel (K3 on CUDA), packed
    decoder levels the fused decoder kernel (K4).
    """
    K, S = cfg.kernel_size, cfg.stride
    strides = _level_strides(cfg)
    frame = torch.cat([state["input_tail"], new_samples], dim=1)
    frames = state["frames"] + 1
    if cfg.normalize_input:
        inv_n = 1.0 / frames.float()
        input_std = _std(frame, 1) * inv_n + (1.0 - inv_n) * state["input_std"]
        x_prev_full = (frame[..., None] / input_std[..., None]).to(dtype)
    else:
        input_std = state["input_std"]
        x_prev_full = frame[..., None].to(dtype)

    skips, enc_caches = [], []
    for i, ep in enumerate(params["encoder"]):
        suffix = x_prev_full[:, -(K + S * (strides[i] - 1)):, :]
        pk = packs[1]["enc"][i] if packs is not None else None
        if pk is not None:
            new_out = fused_encoder_level(encoder_windows(suffix, K, S),
                                          packs[0]["enc"][i], pk).to(dtype)
        else:
            new_out = encoder_level(ep, suffix, cfg, i)
        x_full = torch.cat([state["enc"][i], new_out], dim=1)
        skips.append(x_full)
        enc_caches.append(x_full[:, strides[i]:, :])
        x_prev_full = x_full

    bott_cache, dec_caches, out = _decode_frame(
        params, cfg, skips, state["bottleneck"], state["dec"], dtype, packs=packs)
    out = out[:, : cfg.total_stride, 0]
    if cfg.normalize_input:
        out = out * input_std.to(out.dtype)
    new_state = {
        "input_tail": frame[:, cfg.total_stride:],
        "input_std": input_std,
        "frames": frames,
        "enc": enc_caches,
        "dec": dec_caches,
        "bottleneck": bott_cache,
    }
    return new_state, out


def stream_step_mega(cfg: CleanUMambaConfig, state, new_samples, mega):
    """The single-frame step through the whole-frame kernel: the same function
    as :func:`stream_step` in fp32, the normalisation EMA before and the
    rescale after included.  On CUDA one launch of K5; on the CPU its plain
    version.  ``mega``: ``(arrays, meta)`` from ``pack_mega``.

    K5 reads and writes an fp32 state.  A state of another dtype (a bf16
    ``Streamer``) is cast to fp32 before the launch and each new leaf back to
    its old leaf's dtype after it, as the JAX step stores the kernel's new
    caches in the state's dtype: two more launches a leaf.
    """
    # a state left by stream_prime or stream_step holds slices of larger tensors
    # (the kernel takes the tail and the new samples with any row stride)
    cast = any(t.is_floating_point() and t.dtype != torch.float32 for t in tree_leaves(state))
    state32 = {k: (v if k == "input_tail" else tree_map(
        lambda t: (t.float() if cast and t.is_floating_point() else t).contiguous(), v))
        for k, v in state.items()}
    new_state, out = mega_stream_frame(state32, new_samples, *mega,
                                       normalize=cfg.normalize_input)
    if cast:
        new_state = {k: tree_unflatten(v, [t.to(old.dtype) for t, old in zip(
            tree_leaves(v), tree_leaves(state[k]))]) for k, v in new_state.items()}
    return new_state, out


def _stack_strided_frames(window, starts, length):
    """(B, len(starts), length) from per-frame slices of window (B, L)."""
    return torch.stack([window[:, s : s + length] for s in starts], dim=1)


def _blockwise_frame_stds(window, fl, ts, N):
    """std of window[:, t*ts : t*ts + fl] for each of the block's N frames,
    (B, N, 1) fp32."""
    return _std(_stack_strided_frames(window.float(), [t * ts for t in range(N)], fl), 2)


def _ema_stds(std_now, std0, frames0):
    """Per-frame EMA equal to N ``stream_step`` updates:
    s_t = std_t / n_t + (1 - 1/n_t) * s_{t-1}, n_t = frames0 + t + 1.

    Closed form anchored at frame 0: with w_t = prod_{1<=j<=t}(1 - 1/n_j),
    s_t = w_t * (s_0 + sum_{1<=j<=t} (std_j / n_j) / w_j).
    std_now (B, N, 1); std0 (B, 1); frames0 (B, 1) per-session counters.
    Returns (B, N).
    """
    N = std_now.shape[1]
    f0 = frames0.float().reshape(-1, 1)
    n_t = f0 + 1.0 + torch.arange(N, dtype=torch.float32, device=std_now.device)
    coef = 1.0 - 1.0 / n_t  # coef_0 == 0 iff the stream is fresh
    s_first = std_now[:, 0, 0] / n_t[:, 0] + coef[:, 0] * std0[:, 0]
    if N == 1:
        return s_first[:, None]
    w = torch.cumprod(coef[:, 1:], dim=1)
    terms = (std_now[:, 1:, 0] / n_t[:, 1:]) / w
    rest = w * (s_first[:, None] + torch.cumsum(terms, dim=1))
    return torch.cat([s_first[:, None], rest], dim=1)


def stream_step_block(params, cfg: CleanUMambaConfig, state, new_samples,
                      dtype=torch.float32):
    """Block streaming: consume N*total_stride new samples, emit as many.

    Math-identical to N successive ``stream_step`` calls, normalisation
    included (the std EMA advances per frame; each frame's level-0 slice is
    scaled by its own EMA value, and so is its output).  The encoder and
    decoder work of all N frames runs at once; only the bottleneck's SSM
    state is sequential, carried through one selective scan (K1 on CUDA).
    """
    K, S, D = cfg.kernel_size, cfg.stride, cfg.encoder_n_layers
    ts, fl = cfg.total_stride, cfg.frame_length
    N = new_samples.shape[1] // ts
    if new_samples.shape[1] != N * ts:
        raise ValueError(f"stream_step_block needs a multiple of {ts} samples")
    strides = _level_strides(cfg)
    window = torch.cat([state["input_tail"], new_samples], dim=1)
    frames = state["frames"] + N
    if cfg.normalize_input:
        ema = _ema_stds(_blockwise_frame_stds(window, fl, ts, N),
                        state["input_std"], state["frames"])  # (B, N)
        input_std = ema[:, -1:]
    else:
        input_std = state["input_std"]

    skips, enc_caches = [], []
    if cfg.normalize_input:
        # level 0: per-frame suffix slices, each under its own EMA std
        B = window.shape[0]
        per_frame_len = K + S * (strides[0] - 1)
        slices = _stack_strided_frames(
            window, [fl + t * ts - per_frame_len for t in range(N)], per_frame_len)
        slices = (slices / ema[..., None]).to(dtype)
        out0 = encoder_level(params["encoder"][0],
                             slices.reshape(B * N, per_frame_len, 1), cfg, 0)
        x_full = torch.cat([state["enc"][0], out0.reshape(B, N * strides[0], -1)], dim=1)
        skips.append(x_full)
        enc_caches.append(x_full[:, N * strides[0]:, :])
        x_prev_full = x_full
        level_start = 1
    else:
        x_prev_full = window[..., None].to(dtype)
        level_start = 0

    for i in range(level_start, D):
        n_new = N * strides[i]
        suffix = x_prev_full[:, -(K + S * (n_new - 1)):, :]
        new_out = encoder_level(params["encoder"][i], suffix, cfg, i)
        x_full = torch.cat([state["enc"][i], new_out], dim=1)
        skips.append(x_full)
        enc_caches.append(x_full[:, n_new:, :])
        x_prev_full = x_full

    # the deepest level's cache is empty: skips[-1] holds the N new tokens
    z = pointwise(params["tsfm_conv1"], skips[-1])
    bott_cache, y = _bottleneck_tokens(params, cfg, state["bottleneck"], z)
    x = pointwise(params["tsfm_conv2"], y)

    new_dec = []
    rev_skips = skips[::-1]
    for j, dp in enumerate(params["decoder"]):
        x, tail = _overlap_decoder_level(dp, cfg, j, x, rev_skips[j], state["dec"][j])
        new_dec.append(tail)

    out = x[:, : N * ts, 0]
    if cfg.normalize_input:
        B = out.shape[0]
        out = (out.reshape(B, N, ts) * ema[..., None].to(out.dtype)).reshape(B, N * ts)
    new_state = {
        "input_tail": window[:, N * ts:],
        "input_std": input_std,
        "frames": frames,
        "enc": enc_caches,
        "dec": new_dec,
        "bottleneck": bott_cache,
    }
    return new_state, out


def stream_many(params, cfg: CleanUMambaConfig, state, blocks, dtype=torch.float32,
                packs=None):
    """``stream_step`` over (n_frames, B, total_stride) blocks.
    Returns (state', (B, n_frames * total_stride))."""
    outs = []
    for blk in blocks:
        state, out = stream_step(params, cfg, state, blk, dtype, packs=packs)
        outs.append(out)
    return state, torch.cat(outs, dim=1)


class Streamer:
    """Host-side feed/flush wrapper: accepts chunks of any length, returns
    denoised audio as it becomes available.

    A feed that completes one new frame runs the single-frame step; a feed
    that completes several runs them as one ``stream_step_block`` (K1 in the
    mamba and mamba2 bottlenecks on CUDA).

    fused: "auto" | "mega" | True | False, which single-frame step runs.
    "mega": the whole frame as one launch (``stream_step_mega``, K5 on CUDA),
    packed from the dense view of the weights; raises if the model does not
    pack (``pack_mega``).  True: every U-Net level that packs through the
    fused level kernels (K3/K4 on CUDA), packed from the stored weights (int8
    packs for ``weights="int8"``).  False: plain ``stream_step``.  "auto" (the
    policy is by model, the dispatch by device): mega where the model packs,
    else the per-level packs on a CUDA device, else plain; with int8 weights
    plain, as the JAX package's "auto" keeps int8 on its per-op path.
    ``fused_mode`` says what was resolved: "mega" | "fused" | "plain".  On a
    CPU device the packed paths run their kernels' plain versions.

    device: where the model runs; None means ``params.default_device()``
    (the first CUDA device; raises where there is none).

    weights: "fp32" | "bf16" | "int8", the storage precision of the weight
    matrices (``prepare_weight_view``; int8 quantizes the leaves of at least
    ``quant_min_size`` elements).  bf16 and int8 make the packs' compute
    dtype bf16.  The view is applied inside every prime, step and block
    call, so the resident weights stay int8.  State and activation math run
    in ``dtype``.
    """

    def __init__(self, params, cfg: CleanUMambaConfig, device=None, batch: int = 1,
                 dtype=torch.float32, weights: str = "fp32", quant_min_size: int = 4096,
                 fused="auto"):
        self.device = resolve_device(device)
        self.params, self.view = prepare_weight_view(
            to_device(params, self.device), weights, dtype, quant_min_size)
        self.cfg = cfg
        self.dtype = dtype
        self.batch = batch
        self.packs = self.mega = None
        cdt = torch.float32 if weights == "fp32" else torch.bfloat16
        if fused not in ("auto", "mega", True, False):
            raise ValueError(f"fused={fused!r}: expected 'auto', 'mega', True or False")
        if fused == "auto" and weights == "int8":
            fused = False
        if fused in ("mega", "auto"):
            self.mega = pack_mega(self.view(self.params), cfg, cdt)
            if self.mega is None and fused == "mega":
                raise ValueError("fused='mega': the model does not meet the whole-frame "
                                 "kernel's constraints (see pack_mega)")
        if self.mega is None and (fused is True or (fused == "auto"
                                                    and self.device.type == "cuda")):
            arrays, meta = pack_stream_params(self.params, cfg, cdt)
            if meta is not None:
                self.packs = (arrays, meta)
        # what the single-frame step reads: a packed level's weights are in its
        # pack, so the view need not dequantize them at every step
        self._step_params = self.params
        if self.packs is not None:
            meta = self.packs[1]
            self._step_params = dict(self.params, **{
                name: [None if m is not None else lp
                       for lp, m in zip(self.params[name], meta[side])]
                for side, name in (("enc", "encoder"), ("dec", "decoder"))})
        self.fused_mode = ("mega" if self.mega is not None
                           else "fused" if self.packs is not None else "plain")
        self.state = None
        self.pending = np.zeros((batch, 0), np.float32)
        self.fed = 0
        self.emitted = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """chunk: (B, n) raw samples.  Returns (B, m) denoised samples."""
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        self.fed += chunk.shape[1]
        self.pending = np.concatenate([self.pending, np.asarray(chunk, np.float32)], axis=1)
        outs = []
        fl, ts = self.cfg.frame_length, self.cfg.total_stride
        if self.state is None and self.pending.shape[1] >= fl:
            self.state, out = stream_prime(self.view(self.params), self.cfg,
                                           self._tensor(self.pending[:, :fl]), self.dtype)
            outs.append(out)
            self.pending = self.pending[:, ts:]
        if self.state is not None and self.pending.shape[1] >= fl:
            # pending holds fl - ts already-seen samples plus the new ones
            n_frames = (self.pending.shape[1] - fl) // ts + 1
            new = self._tensor(self.pending[:, fl - ts : fl + (n_frames - 1) * ts])
            if n_frames == 1 and self.mega is not None:
                self.state, out = stream_step_mega(self.cfg, self.state, new, self.mega)
            elif n_frames == 1:
                self.state, out = stream_step(self.view(self._step_params), self.cfg,
                                              self.state, new, self.dtype, packs=self.packs)
            else:
                self.state, out = stream_step_block(self.view(self.params), self.cfg,
                                                    self.state, new, self.dtype)
            outs.append(out)
            self.pending = self.pending[:, n_frames * ts:]
        if not outs:
            return np.zeros((self.batch, 0), np.float32)
        out = torch.cat(outs, dim=1).float().cpu().numpy()
        self.emitted += out.shape[1]
        return out

    def flush(self) -> np.ndarray:
        """Zero-pad and emit the remaining tail (the enc/dec caches are kept)."""
        remaining = self.fed - self.emitted
        if remaining <= 0:
            return np.zeros((self.batch, 0), np.float32)
        out = self.feed(np.zeros((self.batch, self.cfg.frame_length), np.float32))
        self.emitted = self.fed
        return out[:, :remaining]
