"""K3 and K4: the fused encoder and decoder levels of the block-1 streaming step.

Port of ``cleanumamba_tpu/ops/pallas/stream_fused.py``: the weight packing
(``pack_*``, ``encoder_windows``) and the two level kernels.  The wrappers
``fused_encoder_level``/``fused_decoder_level`` launch ``csrc/stream_fused.cu``
for CUDA tensors and the plain PyTorch versions below for CPU tensors.

A pack is ``(arrays, meta)``: ``arrays`` a dict of contiguous tensors in the
pack's compute dtype (biases fp32), ``meta`` the static shapes, the GLU
activation and the compute dtype ``cdt``.  The decoder's grouped layout
``(B, T, S*Cout)`` with column order ``k*Cout + cout`` is the JAX package's,
so ``prev`` and the tail interchange with the per-op path.  The TPU's VMEM
budget does not apply here: every level that meets the static constraints
packs.  int8 packs come with the ``quant.py`` port.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cleanumamba_tpu_torch.ops.conv import ACTIVATIONS
from cleanumamba_tpu_torch.ops.cuda.build import (
    check,
    dtype_code,
    load_library,
    ptr,
    require_cuda,
    stream_ptr,
)

# activation codes of csrc/stream_fused.cu
_ACT_CODES = {"Sigmoid": 0, "ReLU": 1, "SiLU": 2, "GELU": 3}

_INT8_TODO = "int8 packs come with the quant.py port (ROADMAP Queue 1 item 6)"


def _dense(w):
    if isinstance(w, dict):  # quant.py's {int8_values, scale} leaf
        raise NotImplementedError(_INT8_TODO)
    return w


# --------------------------------------------------------------------------
# Weight packing (once, at Streamer init)
# --------------------------------------------------------------------------

def _pack_glu(arrays, mix_w, mix_b, C2, cdt):
    """Split the 1x1 GLU mix (..., C2) into value and gate halves."""
    nAB = C2 // 2
    mw = _dense(mix_w).reshape(-1, C2)
    arrays["mwa"] = mw[:, :nAB].to(cdt).contiguous()
    arrays["mwb"] = mw[:, nAB:].to(cdt).contiguous()
    mb = mix_b.reshape(1, C2).float()
    arrays["mba"] = mb[:, :nAB].contiguous()
    arrays["mbb"] = mb[:, nAB:].contiguous()


def pack_encoder_level(ep, cfg, i, compute_dtype=torch.bfloat16):
    """Pack encoder level ``i`` for :func:`fused_encoder_level`; None when the
    level does not meet the static constraints (bypass 0, K == 2S, groups 1)."""
    K, S = cfg.kernel_size, cfg.stride
    if cfg.bypass_of_layer(i) != 0 or K != 2 * S or cfg.group_of_layer(i) != 1:
        return None
    cw = _dense(ep["conv_w"])
    Kw, Cin, C = cw.shape
    C2 = _dense(ep["mix_w"]).shape[-1]
    arrays = {"cw": cw.reshape(Kw * Cin, C).to(compute_dtype).contiguous(),
              "cb": ep["conv_b"].reshape(1, C).float().contiguous()}
    _pack_glu(arrays, ep["mix_w"], ep["mix_b"], C2, compute_dtype)
    meta = {"K": K, "S": S, "Cin": Cin, "C": C, "C2": C2,
            "act": cfg.glu_activation, "cdt": compute_dtype}
    return arrays, meta


def pack_decoder_level(dp, cfg, enc_i, compute_dtype=torch.bfloat16):
    """Pack the decoder level mirroring encoder level ``enc_i``.

    The ConvTranspose weight (K, C, Cout), K == 2S, splits into the lo taps
    (k < S, samples inside the current token's stride) and the hi taps
    (k >= S, samples that overlap-add into the next token), each laid out
    (C, S*Cout) with columns ``k*Cout + cout``.  None when static
    constraints fail.
    """
    K, S = cfg.kernel_size, cfg.stride
    if cfg.bypass_of_layer(enc_i) != 0 or K != 2 * S:
        return None
    ctw = _dense(dp["convt_w"])
    Kw, C, Cout = ctw.shape
    C2 = _dense(dp["mix_w"]).shape[-1]
    arrays = {}
    _pack_glu(arrays, dp["mix_w"], dp["mix_b"], C2, compute_dtype)
    full = ctw.permute(1, 0, 2).reshape(C, Kw * Cout)
    half = S * Cout
    arrays["cwlo"] = full[:, :half].to(compute_dtype).contiguous()
    arrays["cwhi"] = full[:, half:].to(compute_dtype).contiguous()
    arrays["cb_tiled"] = dp["convt_b"].reshape(1, Cout).float().repeat(1, S).contiguous()
    meta = {"K": K, "S": S, "C": C, "C2": C2, "Cout": Cout,
            "act": cfg.glu_activation, "cdt": compute_dtype}
    return arrays, meta


def pack_stream_params(params, cfg, compute_dtype=torch.bfloat16):
    """Pack every level that meets the static constraints.  Returns parallel
    ``(arrays, meta)`` trees ``{"enc": [...], "dec": [...]}`` with None at
    levels that stay on the per-op path, or ``(None, None)`` if none packs."""
    D = cfg.encoder_n_layers
    enc = [pack_encoder_level(ep, cfg, i, compute_dtype)
           for i, ep in enumerate(params["encoder"])]
    dec = [pack_decoder_level(dp, cfg, D - 1 - j, compute_dtype)
           for j, dp in enumerate(params["decoder"])]
    if all(p is None for p in enc + dec):
        return None, None
    arrays = {"enc": [p[0] if p else None for p in enc],
              "dec": [p[0] if p else None for p in dec]}
    meta = {"enc": [p[1] if p else None for p in enc],
            "dec": [p[1] if p else None for p in dec]}
    return arrays, meta


def encoder_windows(x, K: int, S: int):
    """(B, L, C) -> (B, T, K*C) strided conv windows (K == 2S): window t is
    the input samples [S*t, S*t + K), sample-major then channel."""
    B, L, C = x.shape
    T = (L - K) // S + 1
    xg = x[:, : (T + 1) * S, :].reshape(B, T + 1, S * C)
    return torch.cat([xg[:, :-1, :], xg[:, 1:, :]], dim=-1)


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the references on the card)
# --------------------------------------------------------------------------

def _dot(x, w):
    """fp32-accumulated product of compute-dtype operands (exact products)."""
    return x.float() @ w.float()


def _glu(x, arrays, act):
    a = _dot(x, arrays["mwa"]) + arrays["mba"]
    b = _dot(x, arrays["mwb"]) + arrays["mbb"]
    return a * ACTIVATIONS[act](b)


def fused_encoder_level_plain(win, arrays, meta):
    """win (B, T, K*Cin) -> (B, T, C2/2) in the compute dtype."""
    cdt = meta["cdt"]
    B, T, KC = win.shape
    x = win.reshape(B * T, KC).to(cdt)
    h = torch.relu(_dot(x, arrays["cw"]) + arrays["cb"]).to(cdt)
    return _glu(h, arrays, meta["act"]).to(cdt).reshape(B, T, meta["C2"] // 2)


def fused_decoder_level_plain(x, skip, prev, arrays, meta, relu: bool):
    """x, skip (B, T, C); prev (B, 1, S*Cout) or None -> (out (B, T, S*Cout),
    tail (B, 1, S*Cout)), both in the compute dtype."""
    cdt = meta["cdt"]
    B, T, C = x.shape
    SC = meta["S"] * meta["Cout"]
    if T == 0:
        return _no_tokens(x, prev, SC, cdt)
    xin = (x.float() + skip.float()).to(cdt).reshape(B * T, C)
    g = _glu(xin, arrays, meta["act"]).to(cdt)
    lo = _dot(g, arrays["cwlo"]).reshape(B, T, SC)
    hi = _dot(g, arrays["cwhi"]).reshape(B, T, SC)
    cb = arrays["cb_tiled"]
    first = lo[:, :1] + cb
    if prev is not None:
        first = first + prev.float()
    out = torch.cat([first, lo[:, 1:] + hi[:, :-1] + cb], dim=1)
    if relu:
        out = torch.relu(out)
    return out.to(cdt), hi[:, -1:].to(cdt)


def _no_tokens(x, prev, SC, cdt):
    """No new tokens: empty output; the pending tail is carried as it is."""
    B = x.shape[0]
    out = x.new_empty((B, 0, SC), dtype=cdt)
    tail = prev.to(cdt) if prev is not None else x.new_zeros((B, 1, SC), dtype=cdt)
    return out, tail


# --------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors launch csrc/stream_fused.cu
# --------------------------------------------------------------------------

@functools.cache
def _kernels():
    lib = load_library("stream_fused")
    enc = lib.fused_encoder_level
    enc.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    enc.restype = ctypes.c_int
    dec = lib.fused_decoder_level
    dec.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    dec.restype = ctypes.c_int
    return enc, dec


def _check_pack(what, arrays, cdt, device, names):
    for name in names:
        t = arrays[name]
        want = torch.float32 if name in ("cb", "mba", "mbb", "cb_tiled") else cdt
        if t.dtype != want:
            raise TypeError(f"{what}: pack entry {name} is {t.dtype}, expected {want}")
    require_cuda(what, device, **{n: arrays[n] for n in names})


def fused_encoder_level(win, arrays, meta):
    """K3.  win (B, T, K*Cin) gathered windows -> (B, T, C2/2) in the pack's
    compute dtype: relu(win @ cw + cb) -> (h @ mwa + mba) * act(h @ mwb + mbb).

    The kernel for CUDA tensors, the plain version for CPU tensors.
    """
    if win.device.type == "cpu":
        return fused_encoder_level_plain(win, arrays, meta)
    if win.device.type != "cuda":
        raise ValueError(f"fused_encoder_level: no kernel for device {win.device}")
    what = "fused_encoder_level"
    cdt, C, N2 = meta["cdt"], meta["C"], meta["C2"] // 2
    B, T, KC = win.shape
    if KC != arrays["cw"].shape[0]:
        raise ValueError(f"{what}: windows have {KC} features, pack expects {arrays['cw'].shape[0]}")
    tx, tw = dtype_code(win, what), dtype_code(arrays["cw"], what)
    require_cuda(what, win.device, win=win)
    _check_pack(what, arrays, cdt, win.device, ("cw", "cb", "mwa", "mwb", "mba", "mbb"))
    M = B * T
    out = torch.empty((B, T, N2), dtype=cdt, device=win.device)
    if M == 0:
        return out
    h = torch.empty((M, C), dtype=cdt, device=win.device)
    status = _kernels()[0](
        tx, tw, ptr(win), ptr(arrays["cw"]), ptr(arrays["cb"]), ptr(arrays["mwa"]),
        ptr(arrays["mwb"]), ptr(arrays["mba"]), ptr(arrays["mbb"]), _ACT_CODES[meta["act"]],
        ptr(h), ptr(out), M, KC, C, N2, stream_ptr(win.device))
    check(status, what)
    fused_encoder_level.launches += 1
    return out


fused_encoder_level.launches = 0


def fused_decoder_level(x, skip, prev, arrays, meta, relu: bool):
    """K4.  One decoder level on T tokens in the grouped layout.

    x, skip (B, T, C); prev (B, 1, S*Cout) overlap tail without the
    ConvTranspose bias, or None.  Returns (out (B, T, S*Cout), tail
    (B, 1, S*Cout)) in the pack's compute dtype: ``out.reshape(B, T*S, Cout)``
    is the level output after overlap-add (and ReLU), ``tail`` the next
    frame's carry (no bias).  The kernel for CUDA tensors, the plain version
    for CPU tensors.
    """
    if x.device.type == "cpu":
        return fused_decoder_level_plain(x, skip, prev, arrays, meta, relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decoder_level: no kernel for device {x.device}")
    what = "fused_decoder_level"
    cdt, C, Cout, S = meta["cdt"], meta["C"], meta["Cout"], meta["S"]
    SC = S * Cout
    B, T, Cx = x.shape
    if tuple(skip.shape) != (B, T, Cx) or skip.dtype != x.dtype:
        raise ValueError(f"{what}: skip {tuple(skip.shape)} {skip.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if prev is not None and (tuple(prev.shape) != (B, 1, SC) or prev.dtype != x.dtype):
        raise ValueError(f"{what}: prev {tuple(prev.shape)} {prev.dtype} must be "
                         f"{(B, 1, SC)} {x.dtype}")
    if Cx != arrays["mwa"].shape[0]:
        raise ValueError(f"{what}: x has {Cx} channels, pack expects {arrays['mwa'].shape[0]}")
    tx, tw = dtype_code(x, what), dtype_code(arrays["mwa"], what)
    require_cuda(what, x.device, x=x, skip=skip, prev=prev)
    _check_pack(what, arrays, cdt, x.device,
                ("mwa", "mwb", "mba", "mbb", "cwlo", "cwhi", "cb_tiled"))
    if B == 0 or T == 0:
        return _no_tokens(x, prev, SC, cdt)
    out = torch.empty((B, T, SC), dtype=cdt, device=x.device)
    tail = torch.empty((B, 1, SC), dtype=cdt, device=x.device)
    g = torch.empty((B * T, C), dtype=cdt, device=x.device)
    status = _kernels()[1](
        tx, tw, ptr(x), ptr(skip), ptr(arrays["mwa"]), ptr(arrays["mwb"]),
        ptr(arrays["mba"]), ptr(arrays["mbb"]), _ACT_CODES[meta["act"]], ptr(g),
        ptr(arrays["cwlo"]), ptr(arrays["cwhi"]), ptr(arrays["cb_tiled"]), ptr(prev),
        int(relu), ptr(out), ptr(tail), B, T, Cx, C, SC, stream_ptr(x.device))
    check(status, what)
    fused_decoder_level.launches += 1
    return out, tail


fused_decoder_level.launches = 0
