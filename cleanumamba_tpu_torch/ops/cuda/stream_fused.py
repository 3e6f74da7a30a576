"""K3 and K4: the fused encoder and decoder levels of the block-1 streaming step.

Port of ``cleanumamba_tpu/ops/pallas/stream_fused.py``: the weight packing
(``pack_*``, ``encoder_windows``) and the two level kernels.  The wrappers
``fused_encoder_level``/``fused_decoder_level`` launch ``csrc/stream_fused.cu``
for CUDA tensors and the plain PyTorch versions below for CPU tensors.

A pack is ``(arrays, meta)``: ``arrays`` a dict of contiguous tensors,
``meta`` the static shapes, the GLU activation and the compute dtype ``cdt``.
The weight matrices are stored once, tiled for the kernels (``_tile``: per
tile of ``TILE`` output columns all contraction rows, a GLU's value and gate
or a ConvTranspose's lo and hi taps interleaved per row, zero padded at the
ragged edge), in the compute dtype or, for a ``quant.py`` leaf, as its int8
values with the per-column fp32 scales tiled the same way (``<name>_scale``:
per tile the NW x ``TILE`` scales); the biases fp32 in the JAX package's
shapes; beside them the ``scratch`` that holds a level's first product, sized
at pack time.  The weight type is per product: at ``min_size=4096`` a level's
small conv may stay dense while its mix is int8.  An int8 weight computes in
bf16, as the JAX package's ``_deq`` does: ``bf16(float(q) * scale)`` before
the product.  ``unpack_level`` gives back
the logical ``(K, N)`` matrices under the JAX pack's names (an int8 weight
dequantised so): the plain versions read the weights through it, so the CPU
tests hold the layout and the values the kernels read.  The decoder's grouped
layout ``(B, T, S*Cout)`` with column order ``k*Cout + cout`` is the JAX
package's, so ``prev`` and the tail interchange with the per-op path.  The
TPU's VMEM budget does not apply here: every level that meets the static
constraints packs.  A pack serves one CUDA stream at a time: its scratch is
shared by every call made with it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cleanumamba_tpu_torch.ops.conv import ACTIVATIONS
from cleanumamba_tpu_torch.ops.cuda.build import (
    DTYPE_CODES,
    check,
    dtype_code,
    load_library,
    ptr,
    require_cuda,
    stream_ptr,
)
from cleanumamba_tpu_torch.quant import _Q_TAG, is_quantized

# activation codes of csrc/stream_fused.cu
_ACT_CODES = {"Sigmoid": 0, "ReLU": 1, "SiLU": 2, "GELU": 3}
# stored weight types of csrc/stream_fused.cu (kF32, kBF16, kI8 of common.cuh)
_WEIGHT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# --------------------------------------------------------------------------
# Weight packing (once, at Streamer init)
# --------------------------------------------------------------------------

TILE = 64  # kTile of csrc/stream_fused.cu: output columns per thread block

# the kernels' limits (csrc/stream_fused.cu) and the planner's targets
_WARPS = 8
_MAX_SPLITS = 8           # blocks of a thread block cluster
_SLAB_MAX = 96 * 1024     # bytes of staged weights per block
_SLAB_WHOLE = 32 * 1024   # a contraction whose tile fits this is not split
_SMEM_LIMIT = 200 * 1024
_MIN_RANGE = 32           # contraction rows below which a range is not halved
_N_SM = 132               # H100
_GROUP_ROWS = 32          # most rows a block takes (its sums wait in shared memory)
_PACK_BATCH = 8  # streams the scratch is sized for at pack time (a larger call grows it)
_ROW_TILES = (2, 4, 8)
_BIASES = ("cb", "mba", "mbb", "cb_tiled")
_WEIGHTS = ("cw", "mw", "ctw")  # each level's (first, second) product: cw, mw or mw, ctw
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def _cdiv(a, b):
    return -(-a // b)


def _tile(mats, cdt):
    """NW matrices (K, N) -> (ceil(N / TILE), K, NW, TILE) in ``cdt``,
    contiguous, columns past N zero: each (column tile, contraction range) is
    one contiguous slab whose rows hold the NW matrices side by side."""
    K, N = mats[0].shape
    nt = _cdiv(N, TILE)
    w = torch.stack([m.to(cdt) for m in mats], dim=1)  # (K, NW, N)
    w = torch.nn.functional.pad(w, (0, nt * TILE - N))
    return w.reshape(K, len(mats), nt, TILE).permute(2, 0, 1, 3).contiguous()


def _tile_scales(scales):
    """NW per-column scales (N,) -> (ceil(N / TILE), NW, TILE) fp32, zero
    padded: per tile the scales of the slab's NW x TILE columns."""
    N = scales[0].shape[0]
    nt = _cdiv(N, TILE)
    s = torch.nn.functional.pad(torch.stack([x.float() for x in scales]), (0, nt * TILE - N))
    return s.reshape(len(scales), nt, TILE).permute(1, 0, 2).contiguous()


def _untile(t, N):
    """The NW logical (K, N) matrices of a tiled weight (views)."""
    nt, K, NW, _ = t.shape
    w = t.permute(1, 2, 0, 3).reshape(K, NW, nt * TILE)
    return [w[:, j, :N] for j in range(NW)]


def _unpack_weight(arrays, name, N, cdt):
    """The NW logical matrices of tiled weight ``name``; an int8 weight
    dequantised as the kernels decode it: ``cdt(float(q) * scale)``."""
    mats = _untile(arrays[name], N)
    if name + "_scale" not in arrays:
        return mats
    nt, NW, _ = arrays[name + "_scale"].shape
    scales = arrays[name + "_scale"].permute(1, 0, 2).reshape(NW, nt * TILE)[:, :N]
    return [(q.float() * s).to(cdt) for q, s in zip(mats, scales)]


def unpack_level(arrays, meta):
    """The logical matrices and biases of a level pack under the JAX pack's
    names (``cw, cb, mwa, mwb, mba, mbb`` or ``mwa, mwb, mba, mbb, cwlo, cwhi,
    cb_tiled``): what the tiled pack was built from, int8 weights dequantised."""
    half, cdt = meta["C2"] // 2, meta["cdt"]
    out = {k: arrays[k] for k in _BIASES if k in arrays}
    out["mwa"], out["mwb"] = _unpack_weight(arrays, "mw", half, cdt)
    if "cw" in arrays:
        (out["cw"],) = _unpack_weight(arrays, "cw", meta["C"], cdt)
    else:
        out["cwlo"], out["cwhi"] = _unpack_weight(arrays, "ctw", meta["S"] * meta["Cout"], cdt)
    return out


@functools.lru_cache(maxsize=None)
def _plan(rows, K, N, NW, NI, esize):
    """How one product (rows, K) @ NW x (K, N) is cut into thread blocks:
    ``(splits, groups, kblk, rpb, R)``, or None if a tile's weights do not fit
    the shared memory of one cluster.

    A block owns one of ``ceil(N / TILE)`` column tiles, one of ``splits``
    contraction ranges of ``kblk`` rows (the blocks of a cluster: 1, 2, 4 or
    8) and one of ``groups`` row groups of ``rpb`` rows, taken ``R`` at a time.
    ``esize``: bytes of a stored weight (1: int8, whose NW x TILE fp32 scales
    are staged beside the slab).
    A contraction whose whole tile is small (in bf16 bytes) stays in one
    block; otherwise it is halved while a range keeps ``_MIN_RANGE`` rows and
    the grid is short of two blocks an SM.  Rows are split while the grid is
    short of one block an SM, and down to ``_GROUP_ROWS`` a block.
    """
    nt = _cdiv(N, TILE)
    row_bytes = TILE * NW * esize
    # splitting buys blocks in flight, so an int8 product splits as its bf16
    # counterpart does (split by its own bytes, E8's K3 level 2 and K4 level 5
    # took 1.6-1.9x their bf16 time on an H100 in 1/8 of the blocks)
    split_bytes = K * TILE * NW * max(esize, 2)
    kcap = _SLAB_MAX // row_bytes // 8 * 8
    least = next((s for s in (1, 2, 4, 8) if _cdiv(_cdiv(K, s), 8) * 8 <= kcap), None)
    if least is None:
        return None
    G = 1
    while True:
        rpb = _cdiv(rows, G)
        R = next(r for r in _ROW_TILES if r >= min(rpb, _ROW_TILES[-1]))
        rpb = _cdiv(rpb, R) * R
        groups = _cdiv(rows, rpb)
        splits = least
        if split_bytes > _SLAB_WHOLE:
            while (splits < _MAX_SPLITS and nt * groups * splits < 2 * _N_SM
                   and _cdiv(K, 2 * splits) >= _MIN_RANGE):
                splits *= 2
        kblk = _cdiv(_cdiv(K, splits), 8) * 8
        if rpb <= _GROUP_ROWS and (nt * groups * splits >= _N_SM or rpb <= _ROW_TILES[-1]):
            break
        G *= 2
    scales = NW * TILE * 4 if esize == 1 else 0
    smem = (128 + kblk * row_bytes + scales
            + (NI * R * kblk + (_WARPS * R + rpb) * NW * TILE) * 4)
    assert smem <= _SMEM_LIMIT, (rows, K, N, NW, NI, esize)
    return splits, groups, kblk, rpb, R


def _products(kind, B, T, dims):
    """(rows, K, N, NW, NI) of a level's two products."""
    if kind == "enc":
        KC, C, N2 = dims
        return (B * T, KC, C, 1, 1), (B * T, C, N2, 2, 1)
    Cx, C, SC = dims
    return (B * T, Cx, C, 2, 1), (B * (T + 1), C, SC, 2, 2)


@functools.lru_cache(maxsize=None)
def _level_plan(kind, B, T, dims, esizes):
    """Both products' plans of a level call as the kernels take them (10
    ints), and the elements of scratch (the first product's result) it needs;
    None if a product does not fit (the level then does not pack).
    ``esizes``: the bytes of each product's stored weight."""
    plans = [_plan(*p, e) for p, e in zip(_products(kind, B, T, dims), esizes)]
    if None in plans:
        return None
    return (ctypes.c_int * 10)(*plans[0], *plans[1]), B * T * dims[1]


def _level_dims(meta):
    """(kind, the three widths of a level's two products)."""
    half = meta["C2"] // 2
    if "Cin" in meta:
        return "enc", (meta["K"] * meta["Cin"], meta["C"], half)
    return "dec", (meta["Cx"], half, meta["S"] * meta["Cout"])


def _level_weights(arrays):
    """The stored weights of a level's two products, in order."""
    return [arrays[k] for k in _WEIGHTS if k in arrays]


def _finish_pack(arrays, meta, device):
    """Allocate the scratch for up to ``_PACK_BATCH`` streams of the level's
    block-1 token count and check the pack once (the wrappers check only the
    activations).  None if the kernels cannot take the level's widths."""
    if meta["cdt"] not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {meta['cdt']} not supported (float32 or bfloat16)")
    kind, dims = _level_dims(meta)
    esizes = tuple(_ESIZE[w.dtype] for w in _level_weights(arrays))
    plans = [_level_plan(kind, B, meta["T"], dims, esizes)
             for B in range(1, _PACK_BATCH + 1)]
    if None in plans:
        return None
    arrays["scratch"] = torch.empty(max(p[1] for p in plans), dtype=meta["cdt"], device=device)
    check_pack(arrays, meta)
    return arrays, meta


def check_pack(arrays, meta):
    """Every entry of a level pack has its dtype, is contiguous and lies on
    one device.  Run once when the pack is made, not per call."""
    device = arrays["scratch"].device
    for name, t in arrays.items():
        if name in _BIASES or name.endswith("_scale"):
            want = torch.float32
        elif name + "_scale" in arrays:
            want = torch.int8
        else:
            want = meta["cdt"]
        if t.dtype != want:
            raise TypeError(f"pack entry {name} is {t.dtype}, expected {want}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"pack entry {name} must be contiguous on {device}")


def _matrix(w, K, N):
    """A weight leaf as a (K, N) matrix: a tensor, or a quant.py leaf as
    ``(int8 values (K, N), per-column scale (N,))``."""
    if is_quantized(w):
        return w[_Q_TAG].reshape(K, N), w["scale"].reshape(N)
    return w.reshape(K, N)


def _cols(m, lo, hi):
    """Columns [lo, hi) of a :func:`_matrix`."""
    if isinstance(m, tuple):
        return m[0][:, lo:hi], m[1][lo:hi]
    return m[:, lo:hi]


def _store(arrays, name, mats, cdt):
    """Tile the NW matrices of one product under ``name``: dense in ``cdt``, or
    int8 values with their scales under ``name + "_scale"`` (which compute in
    bf16: an int8 pack's compute dtype is bf16, as ``Streamer`` makes it)."""
    if not isinstance(mats[0], tuple):
        arrays[name] = _tile(mats, cdt)
        return
    if cdt != torch.bfloat16:
        raise TypeError(f"int8 weight {name}: an int8 pack computes in bfloat16, not {cdt}")
    arrays[name] = _tile([q for q, _ in mats], torch.int8)
    arrays[name + "_scale"] = _tile_scales([s for _, s in mats])


def _weight_shape(w):
    return w[_Q_TAG].shape if is_quantized(w) else w.shape


def _pack_glu(arrays, mix_w, mix_b, C2, cdt):
    """Split the 1x1 GLU mix (..., C2) into value and gate halves."""
    nAB = C2 // 2
    mw = _matrix(mix_w, _weight_shape(mix_w).numel() // C2, C2)
    _store(arrays, "mw", [_cols(mw, 0, nAB), _cols(mw, nAB, C2)], cdt)
    mb = mix_b.reshape(1, C2).float()
    arrays["mba"] = mb[:, :nAB].contiguous()
    arrays["mbb"] = mb[:, nAB:].contiguous()


def pack_encoder_level(ep, cfg, i, compute_dtype=torch.bfloat16):
    """Pack encoder level ``i`` for :func:`fused_encoder_level`; None when the
    level does not meet the static constraints (bypass 0, K == 2S, groups 1)
    or is too wide for the kernels (a 64-column tile of a weight matrix over
    768 KB).  Either weight may be a ``quant.py`` int8 leaf."""
    K, S = cfg.kernel_size, cfg.stride
    if cfg.bypass_of_layer(i) != 0 or K != 2 * S or cfg.group_of_layer(i) != 1:
        return None
    Kw, Cin, C = _weight_shape(ep["conv_w"])
    C2 = _weight_shape(ep["mix_w"])[-1]
    arrays = {"cb": ep["conv_b"].reshape(1, C).float().contiguous()}
    _store(arrays, "cw", [_matrix(ep["conv_w"], Kw * Cin, C)], compute_dtype)
    _pack_glu(arrays, ep["mix_w"], ep["mix_b"], C2, compute_dtype)
    meta = {"K": K, "S": S, "Cin": Cin, "C": C, "C2": C2,
            "act": cfg.glu_activation, "cdt": compute_dtype,
            "T": S ** (cfg.encoder_n_layers - 1 - i)}
    return _finish_pack(arrays, meta, arrays["cb"].device)


def pack_decoder_level(dp, cfg, enc_i, compute_dtype=torch.bfloat16):
    """Pack the decoder level mirroring encoder level ``enc_i``.

    The ConvTranspose weight (K, C, Cout), K == 2S, splits into the lo taps
    (k < S, samples inside the current token's stride) and the hi taps
    (k >= S, samples that overlap-add into the next token), each (C, S*Cout)
    with columns ``k*Cout + cout``, tiled side by side; an int8 weight's
    per-Cout scale repeats K times to match (the JAX package's tiling).  None
    when static constraints fail or the level is too wide for the kernels.
    """
    K, S = cfg.kernel_size, cfg.stride
    if cfg.bypass_of_layer(enc_i) != 0 or K != 2 * S:
        return None
    ctw = dp["convt_w"]
    Kw, C, Cout = _weight_shape(ctw)
    C2 = _weight_shape(dp["mix_w"])[-1]
    arrays = {}
    _pack_glu(arrays, dp["mix_w"], dp["mix_b"], C2, compute_dtype)
    if is_quantized(ctw):  # (K, C, Cout) -> (C, K*Cout), columns k*Cout + cout
        full = (ctw[_Q_TAG].permute(1, 0, 2).reshape(C, Kw * Cout),
                ctw["scale"].reshape(Cout).repeat(Kw))
    else:
        full = ctw.permute(1, 0, 2).reshape(C, Kw * Cout)
    half = S * Cout
    _store(arrays, "ctw", [_cols(full, 0, half), _cols(full, half, 2 * half)], compute_dtype)
    arrays["cb_tiled"] = dp["convt_b"].reshape(1, Cout).float().repeat(1, S).contiguous()
    meta = {"K": K, "S": S, "C": C, "C2": C2, "Cout": Cout,
            "Cx": _weight_shape(dp["mix_w"]).numel() // C2,
            "act": cfg.glu_activation, "cdt": compute_dtype,
            "T": S ** (cfg.encoder_n_layers - 1 - enc_i)}
    return _finish_pack(arrays, meta, arrays["cb_tiled"].device)


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


def _glu(x, w, act):
    a = _dot(x, w["mwa"]) + w["mba"]
    b = _dot(x, w["mwb"]) + w["mbb"]
    return a * ACTIVATIONS[act](b)


def fused_encoder_level_plain(win, arrays, meta):
    """win (B, T, K*Cin) -> (B, T, C2/2) in the compute dtype."""
    cdt = meta["cdt"]
    B, T, KC = win.shape
    w = unpack_level(arrays, meta)
    x = win.reshape(B * T, KC).to(cdt)
    h = torch.relu(_dot(x, w["cw"]) + w["cb"]).to(cdt)
    return _glu(h, w, meta["act"]).to(cdt).reshape(B, T, meta["C2"] // 2)


def fused_decoder_level_plain(x, skip, prev, arrays, meta, relu: bool):
    """x, skip (B, T, C); prev (B, 1, S*Cout) or None -> (out (B, T, S*Cout),
    tail (B, 1, S*Cout)), both in the compute dtype."""
    cdt = meta["cdt"]
    B, T, C = x.shape
    SC = meta["S"] * meta["Cout"]
    if T == 0:
        return _no_tokens(x, prev, SC, cdt)
    w = unpack_level(arrays, meta)
    xin = (x.float() + skip.float()).to(cdt).reshape(B * T, C)
    g = _glu(xin, w, meta["act"]).to(cdt)
    lo = _dot(g, w["cwlo"]).reshape(B, T, SC)
    hi = _dot(g, w["cwhi"]).reshape(B, T, SC)
    cb = w["cb_tiled"]
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
    plan_t = ctypes.POINTER(ctypes.c_int)
    enc = lib.fused_encoder_level
    enc.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 8 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [plan_t, ctypes.c_void_p])
    enc.restype = ctypes.c_int
    dec = lib.fused_decoder_level
    dec.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 5 + [plan_t, ctypes.c_void_p])
    dec.restype = ctypes.c_int
    empty = lib.empty_launches
    empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return enc, dec, empty


def _plan_for(what, arrays, meta, B, T, device):
    """The level call's plan; the pack's scratch grown if the call is larger
    than the pack was sized for.  The pack itself was checked when it was made
    (``check_pack``); here only that it lies where the activations do."""
    scratch = arrays["scratch"]
    if scratch.device != device:
        raise ValueError(f"{what}: the pack is on {scratch.device}, the activations on {device}")
    kind, dims = _level_dims(meta)
    weights = _level_weights(arrays)
    plan, need = _level_plan(kind, B, T, dims, tuple(_ESIZE[w.dtype] for w in weights))
    if need > scratch.numel():
        arrays["scratch"] = torch.empty(need, dtype=meta["cdt"], device=device)
    return plan, [_WEIGHT_CODES[w.dtype] for w in weights]


def empty_launches(n: int, device) -> None:
    """Launch ``n`` empty kernels on ``device``'s current stream: the floor
    that a chain of launches sets, for ``chip_smoke.py`` to read."""
    check(_kernels()[2](n, stream_ptr(torch.device(device))), "empty_launches")


def fused_encoder_level(win, arrays, meta):
    """K3.  win (B, T, K*Cin) gathered windows -> (B, T, C2/2) in the pack's
    compute dtype: relu(win @ cw + cb) -> (h @ mwa + mba) * act(h @ mwb + mbb).

    The kernel for CUDA tensors, the plain version for CPU tensors.  A call
    counts in ``launches``, or in ``int8_launches`` if the pack holds an int8
    weight.
    """
    if win.device.type == "cpu":
        return fused_encoder_level_plain(win, arrays, meta)
    if win.device.type != "cuda":
        raise ValueError(f"fused_encoder_level: no kernel for device {win.device}")
    what = "fused_encoder_level"
    cdt, C, N2 = meta["cdt"], meta["C"], meta["C2"] // 2
    B, T, KC = win.shape
    if KC != meta["K"] * meta["Cin"]:
        raise ValueError(f"{what}: windows have {KC} features, pack expects "
                         f"{meta['K'] * meta['Cin']}")
    tx = dtype_code(win, what)
    require_cuda(what, win.device, win=win)
    M = B * T
    out = torch.empty((B, T, N2), dtype=cdt, device=win.device)
    if M == 0:
        return out
    plan, wcodes = _plan_for(what, arrays, meta, B, T, win.device)
    status = _kernels()[0](
        tx, DTYPE_CODES[cdt], *wcodes, ptr(win), ptr(arrays["cw"]), ptr(arrays.get("cw_scale")),
        ptr(arrays["cb"]), ptr(arrays["mw"]), ptr(arrays.get("mw_scale")), ptr(arrays["mba"]),
        ptr(arrays["mbb"]), _ACT_CODES[meta["act"]], ptr(arrays["scratch"]), ptr(out), M, KC, C,
        N2, plan, stream_ptr(win.device))
    check(status, what)
    if _WEIGHT_CODES[torch.int8] in wcodes:
        fused_encoder_level.int8_launches += 1
    else:
        fused_encoder_level.launches += 1
    return out


# launches with dense (fp32 or bf16) packs, and with an int8 weight in the pack
fused_encoder_level.launches = 0
fused_encoder_level.int8_launches = 0


def fused_decoder_level(x, skip, prev, arrays, meta, relu: bool):
    """K4.  One decoder level on T tokens in the grouped layout.

    x, skip (B, T, C); prev (B, 1, S*Cout) overlap tail without the
    ConvTranspose bias, or None.  Returns (out (B, T, S*Cout), tail
    (B, 1, S*Cout)) in the pack's compute dtype: ``out.reshape(B, T*S, Cout)``
    is the level output after overlap-add (and ReLU), ``tail`` the next
    frame's carry (no bias).  The kernel for CUDA tensors, the plain version
    for CPU tensors.  Counted as :func:`fused_encoder_level` is.
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
    if Cx != meta["Cx"]:
        raise ValueError(f"{what}: x has {Cx} channels, pack expects {meta['Cx']}")
    tx = dtype_code(x, what)
    require_cuda(what, x.device, x=x, skip=skip, prev=prev)
    if B == 0 or T == 0:
        return _no_tokens(x, prev, SC, cdt)
    plan, wcodes = _plan_for(what, arrays, meta, B, T, x.device)
    out = torch.empty((B, T, SC), dtype=cdt, device=x.device)
    tail = torch.empty((B, 1, SC), dtype=cdt, device=x.device)
    status = _kernels()[1](
        tx, DTYPE_CODES[cdt], *wcodes, ptr(x), ptr(skip), ptr(arrays["mw"]),
        ptr(arrays.get("mw_scale")), ptr(arrays["mba"]), ptr(arrays["mbb"]),
        _ACT_CODES[meta["act"]], ptr(arrays["scratch"]), ptr(arrays["ctw"]),
        ptr(arrays.get("ctw_scale")), ptr(arrays["cb_tiled"]), ptr(prev), int(relu), ptr(out),
        ptr(tail), B, T, Cx, C, SC, plan, stream_ptr(x.device))
    check(status, what)
    if _WEIGHT_CODES[torch.int8] in wcodes:
        fused_decoder_level.int8_launches += 1
    else:
        fused_decoder_level.launches += 1
    return out, tail


fused_decoder_level.launches = 0
fused_decoder_level.int8_launches = 0
