"""K5: one whole block-1 streaming frame as ONE kernel launch (small models).

Port of ``cleanumamba_tpu/ops/pallas/stream_mega.py``: ``pack_mega`` lays the
whole model out for the kernel, ``mega_stream_step`` runs one frame (all
encoder levels, conv1, the bottleneck stack of one of the five families,
conv2, all decoder levels and every cache update) and returns the new
state leaves beside the output.  It launches ``csrc/stream_mega.cu`` for CUDA
tensors and runs :func:`mega_stream_step_ref`, the same function in plain
PyTorch on the same pack and state, for CPU tensors.

The pack is the port's own layout, not the TPU's: one contiguous 1-D buffer
in the compute dtype (``w``: every weight matrix, row-major ``(in, out)``),
one in fp32 (``f``: biases, norm scales, A, D and the S4 discrete system),
and an int32 ``table`` of offsets and dimensions that the kernel reads,
because widths are per layer in a pruned model.  The one-hot selection
matrices, the 128-lane padding and the pre-split weights of the TPU pack
have no counterpart here: the strided window, the channel splits and the
ungrouping are index arithmetic in the kernel.

State layouts are exactly those of ``streaming.stream_step`` (encoder caches
``(B, len_i - T_i, C_i)``, decoder tails ``(B, S, Cout)`` stored without the
ConvTranspose bias, the per-family bottleneck caches), so mega and plain
steps interleave on one state.  Values are rounded to the compute dtype
where the TPU kernel rounds them (after each product); transcendentals and
all state math are fp32.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.models import bottleneck_mamba2, bottleneck_s4
from cleanumamba_tpu_torch.models.bottleneck_mamba import mixer_dims
from cleanumamba_tpu_torch.models.bottleneck_mha import mha_max_len, ring_mask
from cleanumamba_tpu_torch.ops.conv import ACTIVATIONS
from cleanumamba_tpu_torch.ops.cuda.build import (
    DTYPE_CODES,
    check,
    load_library,
    require_cuda,
    stream_ptr,
)
from cleanumamba_tpu_torch.ops.cuda.stream_fused import _ACT_CODES, encoder_windows

KINDS = {"mamba": 0, "mamba2": 1, "lstm": 2, "mamba_s4": 3, "mha": 4}

# Layout of the int32 table, shared with csrc/stream_mega.cu.
_HDR, _MAX_D, _MAX_L, _REC, _BREC = 32, 12, 8, 16, 24
_ENC_BASE = _HDR
_DEC_BASE = _ENC_BASE + _MAX_D * _REC
_BOTT_BASE = _DEC_BASE + _MAX_D * _REC
_TABLE_LEN = _BOTT_BASE + _MAX_L * _BREC
_N_VEC = 10        # bottleneck vector slots in shared memory
_MAX_PTRS = 128    # state pointers the kernel takes by value
_THREADS = 512

# The pack must stay resident in the card's 50 MB L2 from frame to frame,
# beside the skip caches and (mha) the KV rings of the streams being served:
# one SM re-reads all of it every frame.  A third of the L2 holds every
# released small model several times over (0.2-2 M parameters: at most 8 MB
# in fp32); a model beyond it is better served level by level (K3/K4), where
# each product spreads over many SMs.
_PACK_BUDGET = 16 * 1024 * 1024
# Dynamic shared memory one block may take on sm_90 is 227 KB; the kernel's
# three activation buffers and its bottleneck vectors must fit with headroom.
_SMEM_BUDGET = 200 * 1024


class _Flat:
    """Accumulates tensors into one 1-D buffer of ``dtype``; records
    ``name -> (offset, shape)``.  Offsets are multiples of 16 elements."""

    def __init__(self, dtype, device):
        self.dtype = dtype
        self.device = device
        self.parts = []
        self.slices = {}
        self.off = 0

    def add(self, name, t):
        t = t.detach().to(device=self.device, dtype=self.dtype).contiguous()
        self.slices[name] = (self.off, tuple(t.shape))
        pad = -t.numel() % 16
        self.parts.append(t.reshape(-1))
        if pad:
            self.parts.append(t.new_zeros(pad))
        self.off += t.numel() + pad

    def finalize(self):
        return torch.cat(self.parts)


def level_lengths(cfg):
    """Frame-output length at each encoder level (E8: 382, 190, ..., 4, 1)."""
    lens, l = [], cfg.frame_length
    for _ in range(cfg.encoder_n_layers):
        l = (l - cfg.kernel_size) // cfg.stride + 1
        lens.append(l)
    return lens


def pack_mega(params, cfg, compute_dtype=torch.bfloat16):
    """Pack the whole model for :func:`mega_stream_step`.

    Returns ``(arrays, meta)`` (``arrays``: ``{"w", "f", "table"}`` on the
    params' device; ``meta``: the static dims and the named slices of the two
    buffers), or None when the model does not meet the kernel's constraints:
    one of the five families, ``K == 2S``, no bypass, groups 1, a deepest
    level of length 1 (the conditions of the TPU pack), every skip row of a
    frame in the old cache, at most 12 levels and 8 bottleneck layers, the
    pack within ``_PACK_BUDGET`` and the kernel's shared memory within
    ``_SMEM_BUDGET``.  Callers then keep the per-level or plain paths.
    """
    K, S, D = cfg.kernel_size, cfg.stride, cfg.encoder_n_layers
    kind = cfg.bottleneck
    if (kind not in KINDS or K != 2 * S or D > _MAX_D
            or any(cfg.bypass_of_layer(i) != 0 for i in range(D))
            or any(cfg.group_of_layer(i) != 1 for i in range(D))):
        return None
    lens = level_lengths(cfg)
    strides = [S ** (D - 1 - i) for i in range(D)]
    if lens[-1] != 1:
        return None
    layers = params["bottleneck"]["layers"]
    if len(layers) > _MAX_L or any(isinstance(e["conv_w"], dict) for e in params["encoder"]):
        return None  # quantised leaves ({int8_values, scale}) are not packed
    device = params["tsfm_conv1"]["w"].device
    cdt = compute_dtype
    W, Fl = _Flat(cdt, device), _Flat(torch.float32, device)
    table = [0] * _TABLE_LEN

    def rec(base, values):
        table[base: base + len(values)] = values

    buf = S * (strides[0] + 1)  # level 0's input window
    enc_meta = []
    for i, ep in enumerate(params["encoder"]):
        Kw, Cin, C = ep["conv_w"].shape
        C2 = ep["mix_w"].shape[-1]
        T, cache = strides[i], lens[i] - strides[i]
        if (Kw != K or (i < D - 1 and cache < max(T, S)) or (i == D - 1 and cache != 0)
                or (i > 0 and Cin != enc_meta[-1]["C2"] // 2)):
            return None
        W.add(f"e{i}cw", ep["conv_w"].reshape(Kw * Cin, C))
        Fl.add(f"e{i}cb", ep["conv_b"])
        W.add(f"e{i}mw", ep["mix_w"].reshape(-1, C2))
        Fl.add(f"e{i}mb", ep["mix_b"])
        rec(_ENC_BASE + i * _REC, [T, Cin, C, C2 // 2, cache, W.slices[f"e{i}cw"][0],
                                   Fl.slices[f"e{i}cb"][0], W.slices[f"e{i}mw"][0],
                                   Fl.slices[f"e{i}mb"][0]])
        buf = max(buf, S * (T + 1) * Cin, T * C, (S + T) * (C2 // 2))
        enc_meta.append(dict(T=T, Cin=Cin, C=C, C2=C2, cache=cache))

    for name in ("c1", "c2"):
        W.add(f"{name}w", params[f"tsfm_conv{name[1]}"]["w"][0])
        Fl.add(f"{name}b", params[f"tsfm_conv{name[1]}"]["b"])
    C_last, d_model = W.slices["c1w"][1]
    vec = max(C_last, d_model, W.slices["c2w"][1][0])

    bott_meta = []
    for li, lp in enumerate(layers):
        p = lp.get("mixer", lp)
        base = _BOTT_BASE + li * _BREC
        o = lambda flat, name: flat.slices[f"m{li}{name}"][0]  # noqa: E731
        if kind == "lstm":
            In, H4 = p["w_ih"].shape
            H = p["w_hh"].shape[0]
            # one (In + H, 4H) matrix for [x ; h], gate columns in torch's i, f, g, o order
            W.add(f"m{li}wx", torch.cat([p["w_ih"], p["w_hh"]], dim=0))
            Fl.add(f"m{li}b", p["b_ih"].float() + p["b_hh"].float())
            rec(base, [H, In, 0, 0, o(W, "wx"), 0, o(Fl, "b")])
            vec = max(vec, H4, In + H)
            bott_meta.append(dict(H=H))
            continue
        if kind == "mha":
            d, dff = p["ffn_w1"].shape
            for name, key in (("wq", "w_qs"), ("wk", "w_ks"), ("wv", "w_vs"), ("fc", "fc"),
                              ("f1", "ffn_w1"), ("f2", "ffn_w2")):
                W.add(f"m{li}{name}", p[key])
            for name, t in (("ans", p["attn_norm"]["scale"]), ("anb", p["attn_norm"]["bias"]),
                            ("f1b", p["ffn_b1"]), ("f2b", p["ffn_b2"]),
                            ("fns", p["ffn_norm"]["scale"]), ("fnb", p["ffn_norm"]["bias"])):
                Fl.add(f"m{li}{name}", t)
            rec(base, [d, dff, 0, 0, o(W, "wq"), o(W, "wk"), o(W, "wv"), o(W, "fc"),
                       o(Fl, "ans"), o(Fl, "anb"), o(W, "f1"), o(Fl, "f1b"), o(W, "f2"),
                       o(Fl, "f2b"), o(Fl, "fns"), o(Fl, "fnb")])
            vec = max(vec, dff)
            # the attention's logits (max_len, n_head), then the partial sums of
            # its value product, lie across the three activation buffers
            buf = max(buf, -(-(mha_max_len(cfg) * cfg.tsfm_n_head + _THREADS) // 3))
            bott_meta.append(dict(d=d))
            continue
        W.add(f"m{li}in", p["in_proj"])
        W.add(f"m{li}cw", p["conv_w"])
        Fl.add(f"m{li}cb", p["conv_b"])
        W.add(f"m{li}out", p["out_proj"])
        Fl.add(f"m{li}ns", lp["norm"]["scale"])
        if not cfg.rms_norm:
            Fl.add(f"m{li}nb", lp["norm"]["bias"])
        nb = -1 if cfg.rms_norm else o(Fl, "nb")
        d_conv = p["conv_w"].shape[0]
        if kind == "mamba":
            _, d_inner, d_state, dt_rank, _ = mixer_dims(p)
            W.add(f"m{li}xp", p["x_proj"])
            W.add(f"m{li}dtw", p["dt_proj_w"])
            Fl.add(f"m{li}dtb", p["dt_proj_b"])
            Fl.add(f"m{li}A", -torch.exp(p["A_log"].float()))
            Fl.add(f"m{li}D", p["D"])
            rec(base, [d_inner, d_state, dt_rank, d_conv, o(W, "in"), o(W, "cw"), o(Fl, "cb"),
                       o(W, "xp"), o(W, "dtw"), o(Fl, "dtb"), o(Fl, "A"), o(Fl, "D"),
                       o(W, "out"), o(Fl, "ns"), nb])
            vec = max(vec, 2 * d_inner, dt_rank + 2 * d_state)
            bott_meta.append(dict(d_inner=d_inner, d_state=d_state, dt_rank=dt_rank,
                                  d_conv=d_conv))
        elif kind == "mamba2":
            _, d_inner, d_state, n_heads, headdim = bottleneck_mamba2.mixer_geometry(p)
            Fl.add(f"m{li}dtb", p["dt_bias"])
            A_head = -torch.exp(p["A_log"].float())
            # per-head decay and skip expanded per channel at pack time (constants)
            Fl.add(f"m{li}A", A_head.repeat_interleave(headdim)[:, None]
                   .expand(d_inner, d_state))
            Fl.add(f"m{li}D", p["D"].float().repeat_interleave(headdim))
            Fl.add(f"m{li}nw", p["norm_w"])
            rec(base, [d_inner, d_state, n_heads, d_conv, o(W, "in"), o(W, "cw"), o(Fl, "cb"),
                       o(Fl, "dtb"), 0, 0, o(Fl, "A"), o(Fl, "D"), o(W, "out"), o(Fl, "ns"),
                       nb, o(Fl, "nw")])
            vec = max(vec, 2 * d_inner + 2 * d_state + n_heads)
            bott_meta.append(dict(d_inner=d_inner, d_state=d_state, n_heads=n_heads,
                                  d_conv=d_conv))
        else:  # mamba_s4: the discrete system, computed once on the host
            d_inner = p["conv_w"].shape[1]
            sysm = bottleneck_s4.sp_discrete_system(p)
            if sysm["dC"].shape[0] != 1:
                return None  # one SSM output channel
            Hh, Ns = sysm["dB"].shape[:2]
            # dAt[h, n, m] = dA[h, m, n]: neighbouring threads (m) read neighbours
            Fl.add(f"m{li}dAt", sysm["dA"].permute(0, 2, 1, 3))
            Fl.add(f"m{li}dB", sysm["dB"])
            Fl.add(f"m{li}dC", sysm["dC"][0])
            W.add(f"m{li}ulw", p["input_linear_w"])
            Fl.add(f"m{li}ulb", p["input_linear_b"])
            Fl.add(f"m{li}D", p["ssm_D"][0])
            W.add(f"m{li}olw", p["output_linear_w"])
            Fl.add(f"m{li}olb", p["output_linear_b"])
            rec(base, [d_inner, Hh, Ns, d_conv, o(W, "in"), o(W, "cw"), o(Fl, "cb"),
                       o(W, "ulw"), o(Fl, "ulb"), o(Fl, "dAt"), o(Fl, "dB"), o(Fl, "dC"),
                       o(W, "out"), o(Fl, "ns"), nb, o(Fl, "D"), o(W, "olw"), o(Fl, "olb")])
            vec = max(vec, 2 * d_inner, Hh)
            bott_meta.append(dict(d_inner=d_inner, d_conv=d_conv, H=Hh, N=Ns))

    nf = params["bottleneck"].get("enc_norm" if kind == "mha" else "norm_f")
    nfs = nfb = -1
    if nf is not None:
        Fl.add("nfs", nf["scale"])
        nfs = Fl.slices["nfs"][0]
        if "bias" in nf:
            Fl.add("nfb", nf["bias"])
            nfb = Fl.slices["nfb"][0]

    dec_meta = []
    for j, dp in enumerate(params["decoder"]):
        Kw, Cg, Cout = dp["convt_w"].shape
        C, C2 = dp["mix_w"].shape[-2:]
        T = S ** j
        if Kw != K or C2 // 2 != Cg:
            return None
        W.add(f"d{j}mw", dp["mix_w"].reshape(-1, C2))
        Fl.add(f"d{j}mb", dp["mix_b"])
        # (Cg, K*Cout): columns k*Cout + cout; the lo taps (k < S) then the hi taps
        W.add(f"d{j}ct", dp["convt_w"].permute(1, 0, 2).reshape(Cg, Kw * Cout))
        Fl.add(f"d{j}cb", dp["convt_b"])
        rec(_DEC_BASE + j * _REC, [T, C, Cg, Cout, D - 1 - j, W.slices[f"d{j}mw"][0],
                                   Fl.slices[f"d{j}mb"][0], W.slices[f"d{j}ct"][0],
                                   Fl.slices[f"d{j}cb"][0]])
        buf = max(buf, T * C, T * Cg, T * S * Cout)
        dec_meta.append(dict(T=T, C=C, C2=C2, Cout=Cout, enc_i=D - 1 - j))

    itemsize = torch.empty((), dtype=cdt).element_size()
    smem = 4 * (3 * buf + _N_VEC * vec + C_last)
    if W.off * itemsize + Fl.off * 4 > _PACK_BUDGET or smem > _SMEM_BUDGET:
        return None

    max_len = mha_max_len(cfg) if kind == "mha" else 0
    eps_bits = struct.unpack("i", struct.pack("f", float(cfg.norm_epsilon)))[0]
    rec(0, [KINDS[kind], D, K, S, cfg.frame_length, cfg.total_stride,
            _ACT_CODES[cfg.glu_activation], int(cfg.rms_norm), len(layers), d_model, C_last,
            cfg.tsfm_n_head, buf, vec, max_len, eps_bits,
            W.slices["c1w"][0], Fl.slices["c1b"][0], W.slices["c2w"][0], Fl.slices["c2b"][0],
            nfs, nfb])
    arrays = {"w": W.finalize(), "f": Fl.finalize(),
              "table": torch.tensor(table, dtype=torch.int32, device=device)}
    meta = dict(K=K, S=S, D=D, lens=tuple(lens), strides=tuple(strides), d_model=d_model,
                act=cfg.glu_activation, rms=bool(cfg.rms_norm), eps=float(cfg.norm_epsilon),
                cdt=cdt, kind=kind, n_head=cfg.tsfm_n_head, max_len=max_len,
                frame_length=cfg.frame_length, total_stride=cfg.total_stride,
                enc=tuple(enc_meta), bott=tuple(bott_meta), dec=tuple(dec_meta),
                slices_w=dict(W.slices), slices_f=dict(Fl.slices), smem_bytes=smem)
    return arrays, meta


# --------------------------------------------------------------------------
# The cluster plan: how every product of a frame is cut over the blocks of a
# thread block cluster, and when each block copies its weights into its ring
# --------------------------------------------------------------------------

CLUSTERS = (8, 4, 2, 1)
# Layout of the plan table, shared with csrc/stream_mega.cu: a header, then
# one record per product and rank.
_PLAN_HDR, _PLAN_REC, _MAX_PROD = 16, 10, 96
_SMEM_LIMIT = 227 * 1024   # dynamic shared memory of one block on sm_90
# bytes before the activations: the products' mbarriers, copies of the model table
# and of a block's plan records (csrc/stream_mega.cu: kActOff)
_HEAD = 2048 + 4 * _TABLE_LEN + 4 * _MAX_PROD * _PLAN_REC
# a product this small, whose weights take at most this share of the ring,
# runs whole in every block of the cluster
_REDUNDANT_MACS, _REDUNDANT_RING_SHARE = 16384, 4
_MIN_COLS = 32             # columns a block keeps where rows are left to split: one a lane
# with fp32 weights, a level's product whose blocks keep at least _MMA_ROWS
# rows runs on the tensor cores (tiles of 16 columns x 8 rows; _MMA_COLS
# columns a block where the rows allow).  bf16 packs keep one thread's sum in
# k order: the tensor cores' order moved a bf16 decoder tail of the capstone
# checkpoint by 2.09 % of its largest value, past the checks' 2 %.
_MMA_ROWS, _MMA_COLS = 8, 16


def _cdiv(a, b):
    return -(-a // b)


def _products(meta):
    """Every weight product of a frame in the kernel's order, as dicts: name,
    rows T (a ConvTranspose counts its T + 1 virtual rows), contraction K,
    columns N, ``srcs`` (one (weight slice, first column) per weight set of
    the product) and NI input row sets (2: the ConvTranspose's lo and hi
    taps read rows t and t - 1)."""
    sw = meta["slices_w"]
    prods = []

    def add(name, T, K, N, srcs, NI=1, multi=False):
        prods.append(dict(name=name, T=T, K=K, N=N, srcs=tuple(srcs), NI=NI, multi=multi))

    for i, e in enumerate(meta["enc"]):
        half = e["C2"] // 2
        add(f"e{i}c", e["T"], meta["K"] * e["Cin"], e["C"], [(f"e{i}cw", 0)], multi=True)
        add(f"e{i}m", e["T"], e["C"], half, [(f"e{i}mw", 0), (f"e{i}mw", half)], multi=True)
    C_last, d_model = sw["c1w"][1]
    add("c1", 1, C_last, d_model, [("c1w", 0)])
    for li, bm in enumerate(meta["bott"]):
        def mat(name, NW=1, split=0):
            K, N = sw[f"m{li}{name}"][1]
            N = N // NW if split else N
            add(f"m{li}{name}", 1, K, N, [(f"m{li}{name}", j * split) for j in range(NW)])

        kind = meta["kind"]
        if kind == "lstm":
            mat("wx")
        elif kind == "mha":
            d = bm["d"]
            add(f"m{li}qkv", 1, d, d, [(f"m{li}w{x}", 0) for x in "qkv"])
            for name in ("fc", "f1", "f2"):
                mat(name)
        elif kind == "mamba":
            for name in ("in", "xp", "dtw", "out"):
                mat(name)
        elif kind == "mamba2":
            mat("in")
            mat("out")
        else:  # mamba_s4
            mat("in")
            mat("ulw")
            mat("olw", NW=2, split=bm["d_inner"])
            mat("out")
    add("c2", 1, sw["c2w"][1][0], C_last, [("c2w", 0)])
    for j, d in enumerate(meta["dec"]):
        Cg, N = d["C2"] // 2, meta["S"] * d["Cout"]
        add(f"d{j}m", d["T"], d["C"], Cg, [(f"d{j}mw", 0), (f"d{j}mw", Cg)], multi=True)
        add(f"d{j}t", d["T"] + 1, Cg, N, [(f"d{j}ct", 0), (f"d{j}ct", N)], NI=2, multi=True)
    return prods


def _mma_shape(T, N, C):
    """(row ranks, column ranks) of a product on the tensor cores: the most
    column ranks that leave a block ``_MMA_ROWS`` rows and ``_MMA_COLS``
    columns, else the fewest that leave it the rows; None if none does."""
    shapes = [(C // Cc, Cc) for Cc in CLUSTERS if Cc <= C and _cdiv(T, C // Cc) >= _MMA_ROWS]
    wide = [s for s in shapes if _cdiv(N, s[1]) >= _MMA_COLS]
    return wide[0] if wide else (shapes[-1] if shapes else None)


def _split_shape(T, N, C):
    """(row ranks, column ranks) of a product split over a cluster of C:
    columns as long as a block keeps ``_MIN_COLS`` of them (a warp's lanes on
    neighbouring columns) and rows are left to split, the rest over rows."""
    Cc = C
    while Cc > 1 and _cdiv(N, Cc) < _MIN_COLS and 2 * (C // Cc) <= T:
        Cc //= 2
    return C // Cc, Cc


def _aux_floats(meta):
    """Floats of the kernel's reduction scratch and of one rank's slot in the
    MHA exchange (per layer parity)."""
    red = 4096  # a split contraction's partial sums: parts x outputs x weight sets
    red = max([red] + [2 * b["H"] * b["N"] for b in meta["bott"] if "N" in b])
    xch = 2 * meta["n_head"] + meta["bott"][0]["d"] if meta["kind"] == "mha" else 0
    return red, xch


def _smem_layout(meta):
    """Byte offsets of K5's shared memory, the same for every cluster size:
    mbarriers and tables, the activations (``meta["smem_bytes"]``), the reduction
    scratch, the MHA exchange (two layer parities x 8 ranks), the header rows
    of every level's input window (S rows of the OLD cache a level), then the
    ring of weight slabs up to the limit."""
    red, xch = _aux_floats(meta)
    red_off = _HEAD + meta["smem_bytes"]
    xch_off = red_off + 4 * red
    hdr_off = xch_off + 4 * 2 * CLUSTERS[0] * xch
    hdr = sum(meta["S"] * e["C2"] // 2 for e in meta["enc"][:-1])
    ring_off = _cdiv(hdr_off + 4 * hdr, 128) * 128
    ring = max(0, (_SMEM_LIMIT - ring_off) // 16 * 16)
    return dict(red_off=red_off, xch_off=xch_off, xch=xch, hdr_off=hdr_off, ring_off=ring_off,
                ring=ring, smem=ring_off + ring)


def mega_plan(meta, C):
    """The plan of a frame for a cluster of ``C`` blocks, a pure function of
    ``meta``.  Returns a dict: ``products`` (``_products`` with, per product,
    ``split``, ``mma`` and ``ranks``: per rank (first row, rows, first column,
    columns, offset of its slab in the kernel's weight buffer, bytes, ring
    offset or -1, the product after which it is copied or -1)), ``slabs``
    (offset, product, first column, columns: the weight buffer's layout),
    ``wk_len`` (its elements), ``table`` (the int32 plan the kernel reads)
    and ``smem`` (bytes of dynamic shared memory).

    A product of at most ``_REDUNDANT_MACS`` multiply-adds (with bf16
    weights also one of no more outputs than a block has threads) whose
    weights fit ``1 / _REDUNDANT_RING_SHARE`` of the ring runs whole in every
    block (no exchange, no cluster barrier); any other is cut into C blocks
    of rows x columns (``_split_shape``), ranks in row-major order, each
    block's outputs written into every block's shared memory.  With fp32
    weights a level's product whose blocks keep at least ``_MMA_ROWS`` rows
    (``_mma_shape``) runs on the tensor cores (``mma``).  A block's slab is
    its columns
    of the product's weights, (K, weight set, columns) row-major, copied by
    one bulk copy into a ring of shared memory as soon as the ring space it
    takes has been read (the product that last used it has ended); a slab
    larger than the ring is read from device memory where it lies."""
    if C not in CLUSTERS:
        raise ValueError(f"cluster of {C} blocks: expected one of {CLUSTERS}")
    esize = torch.empty((), dtype=meta["cdt"]).element_size()
    elem_align = 16 // esize
    prods = _products(meta)
    if len(prods) > _MAX_PROD:
        raise ValueError(f"{len(prods)} products, the kernel takes {_MAX_PROD}")
    lay = _smem_layout(meta)
    ring, ring_off = lay["ring"], lay["ring_off"]

    wk_len, slabs = 0, []
    for pi, p in enumerate(prods):
        NW = len(p["srcs"])
        whole = p["K"] * NW * p["N"] * esize
        # a bf16 product is summed in one thread an output (the kernel's
        # kSplitK): cutting one with no more outputs than a block has threads
        # shortens no thread's sum and only adds the exchange
        big = p["T"] * p["K"] * p["N"] * NW > _REDUNDANT_MACS and (
            meta["cdt"] == torch.float32 or p["T"] * p["N"] > _THREADS)
        p["split"] = int(C > 1 and (big or whole > ring // _REDUNDANT_RING_SHARE))
        shape = None
        if p["multi"] and meta["cdt"] == torch.float32:
            shape = (_mma_shape(p["T"], p["N"], C) if p["split"]
                     else (1, 1) if p["T"] >= _MMA_ROWS else None)
        p["mma"] = int(shape is not None)
        Cr, Cc = shape or (_split_shape(p["T"], p["N"], C) if p["split"] else (1, 1))
        tr, ncr = _cdiv(p["T"], Cr), _cdiv(p["N"], Cc)
        blocks = []
        for rc in range(Cc):
            n0 = min(p["N"], rc * ncr)
            nc = min(p["N"], n0 + ncr) - n0
            blocks.append((wk_len, n0, nc))
            if nc:
                slabs.append((wk_len, pi, n0, nc))
                wk_len += _cdiv(p["K"] * NW * nc, elem_align) * elem_align
        ranks = []
        for r in range(C):
            rr, rc = (r // Cc, r % Cc) if p["split"] else (0, 0)
            row0 = min(p["T"], rr * tr)
            src, n0, nc = blocks[rc]
            nbytes = _cdiv(p["K"] * NW * nc * esize, 16) * 16
            ranks.append([row0, min(p["T"], row0 + tr) - row0, n0, nc, src, nbytes, -1, -1])
        p["ranks"] = ranks

    # each block's ring: slabs placed one after the other, wrapping at its end;
    # a slab is copied once every earlier slab whose space it takes is read
    for r in range(C):
        pos, placed, after = 0, [], -1
        for pi, p in enumerate(prods):
            rec = p["ranks"][r]
            size = rec[5]
            if size == 0 or size > ring:
                continue
            start = pos if pos % ring + size <= ring else _cdiv(pos, ring) * ring
            end = start + size
            for q, s_q, e_q in placed:
                if e_q > start - ring and s_q < end - ring:
                    after = max(after, q)
            rec[6], rec[7] = ring_off + start % ring, after
            placed.append((pi, start, end))
            pos = end

    table = [0] * (_PLAN_HDR + len(prods) * C * _PLAN_REC)
    table[:9] = [C, len(prods), ring_off, ring, lay["red_off"], lay["xch_off"], lay["xch"],
                 lay["smem"], lay["hdr_off"]]
    for pi, p in enumerate(prods):
        for r, rec in enumerate(p["ranks"]):
            base = _PLAN_HDR + (pi * C + r) * _PLAN_REC
            table[base: base + _PLAN_REC] = [p["split"], *rec, p["mma"]]
    return dict(products=prods, slabs=slabs, wk_len=wk_len, table=table, **lay)


def _cluster_pack(arrays, meta, C):
    """(weight buffer, plan table, shared memory bytes) of a cluster of C for
    the kernel, built once per pack and cluster size and kept in ``meta``."""
    cache = meta.setdefault("cluster", {})
    if C not in cache:
        plan = mega_plan(meta, C)
        w = arrays["w"].cpu()
        wk = torch.zeros(plan["wk_len"], dtype=w.dtype)
        for off, pi, n0, nc in plan["slabs"]:
            p = plan["products"][pi]
            parts = []
            for name, col in p["srcs"]:
                base, shape = meta["slices_w"][name]
                m = w[base: base + math.prod(shape)].view(shape[0], -1)
                parts.append(m[:, col + n0: col + n0 + nc])
            wk[off: off + p["K"] * len(parts) * nc] = torch.stack(parts, dim=1).reshape(-1)
        dev = arrays["w"].device
        cache[C] = (wk.to(dev), torch.tensor(plan["table"], dtype=torch.int32, device=dev),
                    plan["smem"])
    return cache[C]


# --------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the reference on the card)
# --------------------------------------------------------------------------

def _norm(x, scale, bias, rms, eps):
    if rms:
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale
    return y if bias is None else y + bias


def mega_stream_step_ref(x_norm, state, arrays, meta):
    """The whole-frame step in plain PyTorch: what K5 computes, on the same
    pack and state.  x_norm (B, frame_length) normalised input.  Returns
    ``({"enc", "dec", "bottleneck"}, out (B, total_stride))``.

    All arithmetic is fp32 on values rounded to the compute dtype where the
    kernel rounds them, so with an fp32 pack it is ``streaming.stream_step``
    without its normalisation."""
    K, S, D, cdt = meta["K"], meta["S"], meta["D"], meta["cdt"]
    kind, eps, rms = meta["kind"], meta["eps"], meta["rms"]
    act = ACTIVATIONS[meta["act"]]
    wbuf, fbuf = arrays["w"], arrays["f"]

    def view(buf, slices, name):
        off, shape = slices[name]
        return buf[off: off + math.prod(shape)].view(shape).float()

    w = functools.partial(view, wbuf, meta["slices_w"])
    f = functools.partial(view, fbuf, meta["slices_f"])

    def fo(name):
        return f(name) if name in meta["slices_f"] else None

    def r(t):  # the value a tensor of the compute dtype would hold
        return t.to(cdt).float()

    def glu(t, mw, mb):
        ab = t @ mw + mb
        half = ab.shape[-1] // 2
        return r(ab[..., :half] * act(ab[..., half:]))

    B = x_norm.shape[0]
    out_dtype = x_norm.dtype
    xp = r(x_norm.float())[..., None]
    skips, enc_new = [], []
    for i, em in enumerate(meta["enc"]):
        T = em["T"]
        win = encoder_windows(xp[:, xp.shape[1] - S * (T + 1):, :], K, S)
        h = r(torch.relu(win @ w(f"e{i}cw") + f(f"e{i}cb")))
        g = glu(h, w(f"e{i}mw"), f(f"e{i}mb"))
        # the skip is the head of the OLD cache plus the new rows; the new
        # cache is the same rows without the first T
        full = torch.cat([r(state["enc"][i].float()), g], dim=1) if em["cache"] > 0 else g
        enc_new.append(full[:, T:].to(state["enc"][i].dtype))
        skips.append(full)
        xp = full

    t = skips[-1][:, -1, :] @ w("c1w") + f("c1b")  # (B, d_model) fp32
    cache = state["bottleneck"]
    n_layers = len(meta["bott"])

    def rolled_conv(li, conv_state, new):
        """Roll the conv window, return (window, silu(conv) rounded)."""
        cs = torch.cat([r(conv_state[:, 1:].float()), new[:, None, :]], dim=1)
        pre = r((cs * w(f"m{li}cw")).sum(dim=1) + f(f"m{li}cb"))
        return cs, r(F.silu(pre))

    def scan_step(li, ssm, xc, Bv, Cv, dt):
        h = torch.exp(dt[..., None] * f(f"m{li}A")) * ssm.float() \
            + (dt * xc)[..., None] * Bv[:, None, :]
        return h, torch.einsum("bis,bs->bi", h, Cv) + xc * f(f"m{li}D")

    if kind == "lstm":
        xh, bott = r(t), []
        for li, bm in enumerate(meta["bott"]):
            H = bm["H"]
            gates = r(torch.cat([xh, r(cache[li]["h"].float())], dim=1) @ w(f"m{li}wx")
                      + f(f"m{li}b"))
            gi, gf, gg, go = (gates[:, k * H:(k + 1) * H] for k in range(4))
            c = r(torch.sigmoid(gf)) * cache[li]["c"].float() \
                + r(r(torch.sigmoid(gi)) * r(torch.tanh(gg)))
            xh = r(r(torch.sigmoid(go)) * torch.tanh(c))
            bott.append({"h": xh.to(cache[li]["h"].dtype), "c": c})
        tok = xh
    elif kind == "mha":
        n_head, d = meta["n_head"], meta["bott"][0]["d"]
        max_len = cache["k"].shape[2]
        onehot, valid = (m[..., None] for m in ring_mask(cache["pos"], max_len))
        xh = r(_norm(t, f("nfs"), f("nfb"), False, eps))
        new_k, new_v = [], []
        for li in range(n_layers):
            q, k, v = (xh @ w(f"m{li}{n}") for n in ("wq", "wk", "wv"))
            kc = torch.where(onehot, k[:, None, :], cache["k"][:, li].float())
            vc = torch.where(onehot, v[:, None, :], cache["v"][:, li].float())
            new_k.append(kc.to(cache["k"].dtype))
            new_v.append(vc.to(cache["v"].dtype))
            logits = (kc * q[:, None, :]).reshape(B, max_len, n_head, d // n_head).sum(-1) \
                / math.sqrt(d // n_head)
            attn = torch.softmax(torch.where(valid, logits, torch.full_like(logits, -1e9)),
                                 dim=1)
            a = (vc * attn.repeat_interleave(d // n_head, dim=-1)).sum(dim=1)
            xh = r(_norm(r(a) @ w(f"m{li}fc") + xh, f(f"m{li}ans"), f(f"m{li}anb"), False, eps))
            ff = r(torch.relu(xh @ w(f"m{li}f1") + f(f"m{li}f1b")))
            xh = r(_norm(ff @ w(f"m{li}f2") + f(f"m{li}f2b") + xh, f(f"m{li}fns"),
                         f(f"m{li}fnb"), False, eps))
        bott = {"k": torch.stack(new_k, 1), "v": torch.stack(new_v, 1), "pos": cache["pos"] + 1}
        tok = xh
    else:
        hidden, residual, bott = t, torch.zeros_like(t), []
        for li, bm in enumerate(meta["bott"]):
            residual = hidden + residual
            hb = r(_norm(residual, f(f"m{li}ns"), fo(f"m{li}nb"), rms, eps))
            proj = hb @ w(f"m{li}in")
            di = bm["d_inner"]
            if kind == "mamba":
                ds, dr = bm["d_state"], bm["dt_rank"]
                xs, zg = r(proj[:, :di]), r(proj[:, di:])
                cs, xc = rolled_conv(li, cache[li]["conv_state"], xs)
                dbc = xc @ w(f"m{li}xp")
                dt = F.softplus(r(dbc[:, :dr]) @ w(f"m{li}dtw") + f(f"m{li}dtb"))
                h, y = scan_step(li, cache[li]["ssm_state"], xc, dbc[:, dr:dr + ds],
                                 dbc[:, dr + ds:], dt)
                y = r(r(y) * r(F.silu(zg)))
                new = {"conv_state": cs.to(cache[li]["conv_state"].dtype), "ssm_state": h}
            elif kind == "mamba2":
                ds, nh = bm["d_state"], bm["n_heads"]
                zg = r(proj[:, :di])
                cs, v = rolled_conv(li, cache[li]["conv_state"], r(proj[:, di:2 * di + 2 * ds]))
                dt_h = F.softplus(proj[:, 2 * di + 2 * ds:] + f(f"m{li}dtb"))
                h, y = scan_step(li, cache[li]["ssm_state"], v[:, :di], v[:, di:di + ds],
                                 v[:, di + ds:], dt_h.repeat_interleave(di // nh, dim=-1))
                yf = y * F.silu(zg)  # gated RMSNorm, eps 1e-5
                y = r(yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-5)
                      * f(f"m{li}nw"))
                new = {"conv_state": cs.to(cache[li]["conv_state"].dtype), "ssm_state": h}
            else:  # mamba_s4
                xs, zg = r(proj[:, :di]), r(proj[:, di:])
                cs, xc = rolled_conv(li, cache[li]["conv_state"], xs)
                u = r(xc @ w(f"m{li}ulw") + f(f"m{li}ulb"))  # (B, H)
                c = torch.view_as_complex
                s = torch.einsum("hnm,bhn->bhm", c(f(f"m{li}dAt")),
                                 c(cache[li]["s4_state"].float().contiguous())) \
                    + c(f(f"m{li}dB"))[None] * u[..., None]
                y = (c(f(f"m{li}dC"))[None] * s).sum(-1).real + u * f(f"m{li}D")
                ab = r(F.gelu(y)) @ w(f"m{li}olw") + f(f"m{li}olb")  # exact (erf) GELU
                y = r(r(ab[:, :di] * torch.sigmoid(ab[:, di:])) * r(F.silu(zg)))
                new = {**cache[li], "conv_state": cs.to(cache[li]["conv_state"].dtype),
                       "s4_state": torch.view_as_real(s).contiguous()}
            bott.append(new)
            hidden = y @ w(f"m{li}out")
        tok = r(_norm(hidden + residual, f("nfs"), fo("nfb"), rms, eps))
    xd = r(tok @ w("c2w") + f("c2b"))[:, None, :]  # (B, 1, C_last)

    dec_new = []
    for j, dm in enumerate(meta["dec"]):
        T, Cout = dm["T"], dm["Cout"]
        xd = r(xd + skips[dm["enc_i"]][:, :T])
        lohi = glu(xd, w(f"d{j}mw"), f(f"d{j}mb")) @ w(f"d{j}ct")
        lo, hi = lohi[..., :S * Cout], lohi[..., S * Cout:]
        prev = state["dec"][j].reshape(B, 1, S * Cout).float()
        z = lo + torch.cat([prev, hi[:, :T - 1]], dim=1) + f(f"d{j}cb").repeat(S)
        if j != D - 1:
            z = torch.relu(z)
        dec_new.append(hi[:, T - 1].reshape(B, S, Cout).to(state["dec"][j].dtype))
        xd = r(z).reshape(B, T * S, Cout)
    return {"enc": enc_new, "dec": dec_new, "bottleneck": bott}, xd[:, :, 0].to(out_dtype)


def mega_stream_frame_ref(state, new_samples, arrays, meta, normalize):
    """The whole frame with the input normalisation around it, in plain
    PyTorch (``cleanumamba_tpu/streaming.py::stream_step_mega``): the frame
    is the tail and the new samples; with ``normalize`` the running std (an
    EMA of the frame's population std + 1e-3 with weight 1/frames) scales
    it down before :func:`mega_stream_step_ref` and the output up after.
    Returns ``(the whole new state, out (B, total_stride))``."""
    frame = torch.cat([state["input_tail"], new_samples], dim=1)
    frames = state["frames"] + 1
    if normalize:
        inv_n = 1.0 / frames.float()
        std_now = frame.float().std(dim=1, keepdim=True, correction=0) + 1e-3
        input_std = std_now * inv_n + (1.0 - inv_n) * state["input_std"]
        x = frame.float() / input_std
    else:
        input_std = state["input_std"]
        x = frame.float()
    upd, out = mega_stream_step_ref(x, state, arrays, meta)
    if normalize:
        out = out * input_std.to(out.dtype)
    return {"input_tail": frame[:, meta["total_stride"]:], "input_std": input_std,
            "frames": frames, **upd}, out


# --------------------------------------------------------------------------
# Kernel wrapper: CUDA tensors launch csrc/stream_mega.cu
# --------------------------------------------------------------------------

@functools.cache
def _kernel():
    fn = load_library("stream_mega").mega_stream_step
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def clusters_at_once(code: int, cluster: int, smem: int) -> int:
    """K5's clusters of ``cluster`` blocks that the card holds at once."""
    fn = load_library("stream_mega").mega_clusters_at_once
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    n = fn(code, cluster, _THREADS, smem)
    if n < 0:
        raise RuntimeError(f"mega_clusters_at_once: CUDA error {-n}")
    return n


@functools.cache
def fit_cluster(code: int, B: int, smem: int) -> int:
    """The largest cluster (8, 4, 2 or 1 blocks a stream) with which B
    streams take no more waves than blocks alone would: a cluster needs all
    its SMs free at once in one part of the card."""
    def waves(c):
        at_once = clusters_at_once(code, c, smem)
        return _cdiv(B, at_once) if at_once > 0 else float("inf")

    least = waves(1)
    return next(c for c in CLUSTERS if waves(c) <= least)


def _checked(what, device, t, shape, name, dtype=torch.float32):
    """``t`` if it is a contiguous ``dtype`` tensor of ``shape`` on ``device``; raises otherwise."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} {dtype}")
    require_cuda(what, device, **{name: t})
    return t


def _rows(what, device, t, shape, name):
    """An fp32 tensor of ``shape`` on ``device`` whose rows are contiguous
    (a slice of columns of a larger tensor will do): its row stride."""
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} torch.float32")
    if t.device != device or t.stride(1) != 1:
        raise ValueError(f"{what}: {name} must lie on {device} with contiguous rows")
    return t.stride(0)


def _bottleneck_io(what, device, meta, cache, B):
    """The bottleneck state as the kernel takes it: per layer up to three
    (input, newly allocated output) tensor pairs in the kernel's order, the
    new cache built from those outputs, and MHA's (position, new position)
    pair (None for the other families)."""
    kind = meta["kind"]
    if kind == "mha":  # each layer's rings start at k[0, li]; a row's lie L * W * d further
        shape = (B, len(meta["bott"]), meta["max_len"], meta["bott"][0]["d"])
        k = _checked(what, device, cache["k"], shape, "k ring")
        v = _checked(what, device, cache["v"], shape, "v ring")
        pos = _checked(what, device, cache["pos"], (B,), "pos", torch.int32)
        new = {"k": torch.empty_like(k), "v": torch.empty_like(v), "pos": torch.empty_like(pos)}
        pairs = [[(k[:, li], new["k"][:, li]), (v[:, li], new["v"][:, li])]
                 for li in range(shape[1])]
        return pairs, new, (pos, new["pos"])
    pairs, new = [], []
    for li, (lc, bm) in enumerate(zip(cache, meta["bott"])):
        if kind == "lstm":
            shapes = {"h": (B, bm["H"]), "c": (B, bm["H"])}
        elif kind == "mamba_s4":
            shapes = {"conv_state": (B, bm["d_conv"], bm["d_inner"]),
                      "s4_state": (B, bm["H"], bm["N"], 2)}
        else:
            conv_ch = bm["d_inner"] + (2 * bm["d_state"] if kind == "mamba2" else 0)
            shapes = {"conv_state": (B, bm["d_conv"], conv_ch),
                      "ssm_state": (B, bm["d_inner"], bm["d_state"])}
        outs = {n: torch.empty_like(_checked(what, device, lc[n], shape, f"layer {li} {n}"))
                for n, shape in shapes.items()}
        pairs.append([(lc[n], outs[n]) for n in shapes])
        new.append({**lc, **outs})
    return pairs, new, None


def _launch(what, tail, new, state, arrays, meta, norm=None):
    """One launch of K5 on ``B`` streams: the frame is ``tail`` (B,
    frame_length - total_stride) and ``new`` (B, total_stride), each with
    contiguous rows.  ``norm``: None (the frame is already normalised; the
    kernel writes no tail, std or count), or ``(input_std, frames,
    normalize)``: the kernel writes the new tail, std and count and, with
    ``normalize``, scales the frame and its output.  Returns ``(upd, out)``,
    upd the new ``enc``, ``dec``, ``bottleneck`` (and ``input_tail``,
    ``input_std``, ``frames`` with ``norm``) leaves in new tensors."""
    dev = new.device
    D, S, FL, TS = meta["D"], meta["S"], meta["frame_length"], meta["total_stride"]
    B = new.shape[0]
    ld_tail = _rows(what, dev, tail, (B, FL - TS), "input tail")
    ld_new = _rows(what, dev, new, (B, TS), "new samples")
    if arrays["w"].dtype != meta["cdt"] or arrays["w"].dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: pack dtype {arrays['w'].dtype}, expected {meta['cdt']} "
                        "(float32 or bfloat16)")
    require_cuda(what, dev, **arrays)

    ptrs = [0] * _MAX_PTRS
    enc_new, dec_new = [], []
    for i, em in enumerate(meta["enc"]):
        e = _checked(what, dev, state["enc"][i], (B, em["cache"], em["C2"] // 2), f"enc[{i}]")
        enc_new.append(torch.empty_like(e))
        if em["cache"] > 0:  # the deepest level's cache has no rows and no pointer
            ptrs[i], ptrs[D + i] = e.data_ptr(), enc_new[i].data_ptr()
    for j, dm in enumerate(meta["dec"]):
        t = _checked(what, dev, state["dec"][j], (B, S, dm["Cout"]), f"dec[{j}]")
        dec_new.append(torch.empty_like(t))
        ptrs[2 * D + j], ptrs[3 * D + j] = t.data_ptr(), dec_new[j].data_ptr()
    L = len(meta["bott"])
    pairs, bott_new, pos = _bottleneck_io(what, dev, meta, state["bottleneck"], B)
    for li, layer in enumerate(pairs):
        for k, (tin, tout) in enumerate(layer):
            ptrs[4 * D + 3 * li + k] = tin.data_ptr()
            ptrs[4 * D + 3 * L + 3 * li + k] = tout.data_ptr()
    if pos is not None:
        ptrs[4 * D + 6 * L], ptrs[4 * D + 6 * L + 1] = pos[0].data_ptr(), pos[1].data_ptr()

    out = torch.empty((B, TS), dtype=torch.float32, device=dev)
    upd = {"enc": enc_new, "dec": dec_new, "bottleneck": bott_new}
    io = [0] * 6  # std in, frames in, tail out, std out, frames out; normalize
    if norm is not None:
        std, frames, normalize = norm
        _checked(what, dev, std, (B, 1), "input_std")
        _checked(what, dev, frames, (B, 1), "frames", torch.int32)
        upd = {"input_tail": torch.empty((B, FL - TS), dtype=torch.float32, device=dev),
               "input_std": torch.empty_like(std), "frames": torch.empty_like(frames), **upd}
        io = [std.data_ptr(), frames.data_ptr(), upd["input_tail"].data_ptr(),
              upd["input_std"].data_ptr(), upd["frames"].data_ptr(), int(bool(normalize))]
    if B == 0:
        return upd, out
    code = DTYPE_CODES[meta["cdt"]]
    cluster = fit_cluster(code, B, _smem_layout(meta)["smem"])
    wk, plan, smem = _cluster_pack(arrays, meta, cluster)
    status = _kernel()(
        code, tail.data_ptr(), ld_tail, new.data_ptr(), ld_new, *io, out.data_ptr(),
        wk.data_ptr(), arrays["w"].data_ptr(), arrays["f"].data_ptr(), arrays["table"].data_ptr(),
        plan.data_ptr(),
        (ctypes.c_void_p * _MAX_PTRS)(*ptrs), _MAX_PTRS, B, cluster, _THREADS, smem,
        stream_ptr(dev))
    check(status, what)
    mega_stream_step.launches += 1
    return upd, out


def mega_stream_step(x_norm, state, arrays, meta):
    """K5.  One whole block-1 frame, the JAX package's contract.

    x_norm: (B, frame_length) normalised input; ``state``: the streaming
    state of ``streaming.py`` (its ``enc``, ``dec`` and ``bottleneck``
    leaves are read); ``arrays, meta``: ``pack_mega``'s.  Returns
    ``({"enc", "dec", "bottleneck"}, out (B, total_stride))``: the new state
    leaves in newly allocated tensors (a step is repeatable) and the frame's
    output; the caller keeps the normalisation scalars.

    The kernel for CUDA tensors (fp32 input and state, contiguous), the plain
    version for CPU tensors.  The kernel is the one of
    :func:`mega_stream_frame` with the normalisation off, the frame split
    into its tail and new samples where it lies.
    """
    if x_norm.device.type == "cpu":
        return mega_stream_step_ref(x_norm, state, arrays, meta)
    if x_norm.device.type != "cuda":
        raise ValueError(f"mega_stream_step: no kernel for device {x_norm.device}")
    cut = meta["frame_length"] - meta["total_stride"]
    return _launch("mega_stream_step", x_norm[:, :cut], x_norm[:, cut:], state, arrays, meta)


def mega_stream_frame(state, new_samples, arrays, meta, normalize):
    """K5 with the input normalisation inside the launch: the single-frame
    step of ``streaming.stream_step_mega`` from the raw tail
    (``state["input_tail"]``), the new samples (B, total_stride), the running
    std and the frame count.  Returns ``(the whole new state, out)``, every
    leaf in a new tensor.  One launch for CUDA tensors;
    :func:`mega_stream_frame_ref` for CPU tensors."""
    if new_samples.device.type == "cpu":
        return mega_stream_frame_ref(state, new_samples, arrays, meta, normalize)
    if new_samples.device.type != "cuda":
        raise ValueError(f"mega_stream_frame: no kernel for device {new_samples.device}")
    return _launch("mega_stream_frame", state["input_tail"], new_samples, state, arrays, meta,
                   norm=(state["input_std"], state["frames"], normalize))


# launches of the kernel, through either entry point; a launch recorded into
# a CUDA graph counts at each replay (graphs.StepGraphs)
mega_stream_step.launches = 0
