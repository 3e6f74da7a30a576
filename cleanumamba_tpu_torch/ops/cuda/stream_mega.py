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
        onehot, valid = (m[None, :, None] for m in ring_mask(cache["pos"], max_len))
        xh = r(_norm(t, f("nfs"), f("nfb"), False, eps))
        new_k, new_v = [], []
        for li in range(n_layers):
            q, k, v = (xh @ w(f"m{li}{n}") for n in ("wq", "wk", "wv"))
            kc = torch.where(onehot, k[:, None, :], cache["k"][li].float())
            vc = torch.where(onehot, v[:, None, :], cache["v"][li].float())
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
        bott = {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": cache["pos"] + 1}
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


# --------------------------------------------------------------------------
# Kernel wrapper: CUDA tensors launch csrc/stream_mega.cu
# --------------------------------------------------------------------------

@functools.cache
def _kernel():
    fn = load_library("stream_mega").mega_stream_step
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _checked(what, device, t, shape, name, dtype=torch.float32):
    """``t`` if it is a contiguous ``dtype`` tensor of ``shape`` on ``device``; raises otherwise."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} {dtype}")
    require_cuda(what, device, **{name: t})
    return t


def _bottleneck_io(what, device, meta, cache, B):
    """The bottleneck state as the kernel takes it: per layer up to three
    (input, newly allocated output) tensor pairs in the kernel's order, the
    new cache built from those outputs, and MHA's (position, new position)
    pair (None for the other families)."""
    kind = meta["kind"]
    if kind == "mha":
        shape = (len(meta["bott"]), B, meta["max_len"], meta["bott"][0]["d"])
        k = _checked(what, device, cache["k"], shape, "k ring")
        v = _checked(what, device, cache["v"], shape, "v ring")
        pos = _checked(what, device, cache["pos"], (), "pos", torch.int32)
        new = {"k": torch.empty_like(k), "v": torch.empty_like(v), "pos": torch.empty_like(pos)}
        pairs = [[(k[li], new["k"][li]), (v[li], new["v"][li])] for li in range(shape[0])]
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


def mega_stream_step(x_norm, state, arrays, meta):
    """K5.  One whole block-1 frame.

    x_norm: (B, frame_length) normalised input; ``state``: the streaming
    state of ``streaming.py`` (its ``enc``, ``dec`` and ``bottleneck``
    leaves are read); ``arrays, meta``: ``pack_mega``'s.  Returns
    ``({"enc", "dec", "bottleneck"}, out (B, total_stride))``: the new state
    leaves in newly allocated tensors (a step is repeatable) and the frame's
    output; the caller keeps the normalisation scalars.

    The kernel for CUDA tensors (fp32 input and state, contiguous), the plain
    version for CPU tensors.
    """
    if x_norm.device.type == "cpu":
        return mega_stream_step_ref(x_norm, state, arrays, meta)
    if x_norm.device.type != "cuda":
        raise ValueError(f"mega_stream_step: no kernel for device {x_norm.device}")
    what = "mega_stream_step"
    dev = x_norm.device
    D, S = meta["D"], meta["S"]
    B = x_norm.shape[0]
    if tuple(x_norm.shape) != (B, meta["frame_length"]) or x_norm.dtype != torch.float32:
        raise ValueError(f"{what}: x is {tuple(x_norm.shape)} {x_norm.dtype}, expected "
                         f"(B, {meta['frame_length']}) torch.float32")
    if arrays["w"].dtype != meta["cdt"] or arrays["w"].dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: pack dtype {arrays['w'].dtype}, expected {meta['cdt']} "
                        "(float32 or bfloat16)")
    require_cuda(what, dev, x=x_norm, **arrays)

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

    out = torch.empty((B, meta["total_stride"]), dtype=torch.float32, device=dev)
    if B == 0:
        return {"enc": enc_new, "dec": dec_new, "bottleneck": bott_new}, out
    status = _kernel()(
        DTYPE_CODES[meta["cdt"]], x_norm.data_ptr(), out.data_ptr(), arrays["w"].data_ptr(),
        arrays["f"].data_ptr(), arrays["table"].data_ptr(),
        (ctypes.c_void_p * _MAX_PTRS)(*ptrs), _MAX_PTRS, B, _THREADS, meta["smem_bytes"],
        stream_ptr(dev))
    check(status, what)
    mega_stream_step.launches += 1
    return {"enc": enc_new, "dec": dec_new, "bottleneck": bott_new}, out


mega_stream_step.launches = 0
