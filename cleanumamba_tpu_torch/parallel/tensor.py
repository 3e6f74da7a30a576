"""Tensor (model) parallelism over the model axis of a mesh (port of
``cleanumamba_tpu/parallel/tensor.py``).

Megatron-style intra-layer sharding, laid out so that every U-Net level
costs one ``psum`` and every mamba block two:

- **Encoder level** (strided conv -> ReLU -> 1x1 -> GLU): the strided conv is
  column-parallel over its ``H`` output channels, the 1x1 mix row-parallel
  over the same ``H`` (partial products -> ``psum``), the GLU replicated.
- **Mamba mixer**: ``in_proj`` column-parallel over ``2*d_inner`` (the x|z
  halves block-interleaved at prepare time, so that a rank's contiguous
  slice is ``[x_k | z_k]``), the depthwise conv, SiLU and selective scan
  local on the rank's ``d_inner/n`` channels (K1, and K2 in its backward,
  on CUDA), ``x_proj`` row-parallel (psum), ``dt_proj`` column-parallel,
  ``out_proj`` row-parallel (psum).  Norms and the fp32 residual stream are
  replicated.
- **mamba2**: heads, their ``d_inner`` columns, ``dt_bias``/``A_log``/``D``
  and ``norm_w`` shard; the head-shared B/C columns move to replicated
  leaves.  One psum of the gated RMSNorm's sum of squares and one of
  ``out_proj``.
- **mamba_s4**: ``d_inner`` shards as mamba's; ``input_linear`` row-parallel
  into the replicated S4 long convolution, ``output_linear`` column-parallel
  with its GLU halves interleaved, ``out_proj`` row-parallel.
- **MHA**: Q/K/V column-parallel over whole heads, the output projection and
  the FFN's down-projection row-parallel.
- **Decoder level** (1x1 -> GLU -> ConvT): the 1x1 column-parallel with its
  ``[bypass | A | B]`` columns interleaved so that the GLU gates locally,
  the ConvT row-parallel over its input channels (psum).
- **LSTM** does not shard (one collective per time step): it trains
  data-parallel.

Where JAX's ``shard_map`` slices a ``PartitionSpec`` per leaf, here each rank
is a process (``parallel.make_mesh(model_parallel=n)``): :func:`tp_prepare`
returns the permuted tree and its specs, a tree of "the dim this leaf is
sharded on, or None" (non-tensor leaves, such as an S4 kernel's
``l_kernel``, are None and pass through), and :func:`tp_shard` cuts rank k's
contiguous 1/n of every sharded leaf.  The psums are
``parallel.mesh.psum`` over the mesh's model group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.losses import loss_fn
from cleanumamba_tpu_torch.models.bottleneck_mha import _causal_attention
from cleanumamba_tpu_torch.models.bottleneck_s4 import fft_long_conv
from cleanumamba_tpu_torch.ops.conv import (
    causal_depthwise_conv,
    conv1d_strided_matmul,
    conv_transpose1d,
    glu_activation,
)
from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan_fn
from cleanumamba_tpu_torch.ops.norms import layer_norm, rms_norm
from cleanumamba_tpu_torch.ops.scan import ssd_scan_grad
from cleanumamba_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    batch_sharding,
    pmean,
    psum,
    psum_leaves,
)
from cleanumamba_tpu_torch.params import tensor_leaves, tree_map, tree_unflatten
from cleanumamba_tpu_torch.train.optim import apply_updates, make_optimizer

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Parameter preparation: block-interleave permutations and shard dims
# --------------------------------------------------------------------------

def _interleave_perm(sizes: List[int], n: int) -> np.ndarray:
    """Index permutation so that contiguous block k (of n) of the permuted
    axis holds ``[seg0_k | seg1_k | ...]`` where ``segi_k`` is the k-th
    1/n slice of the i-th original contiguous segment."""
    offs = np.cumsum([0] + list(sizes))[:-1]
    idx = []
    for k in range(n):
        for sz, off in zip(sizes, offs):
            m = sz // n
            idx.extend(range(off + k * m, off + (k + 1) * m))
    return np.asarray(idx, np.int64)


def _check_div(name: str, value: int, n: int):
    if value % n != 0:
        raise ValueError(
            f"tensor parallelism: {name}={value} not divisible by mesh axis "
            f"size {n} (TP targets the full-size geometries; ragged pruned "
            f"checkpoints stream single-chip)"
        )


def _take(t, idx, dim: int):
    """``t`` indexed by the numpy ``idx`` along ``dim`` (differentiable)."""
    return t.index_select(dim, torch.as_tensor(idx, device=t.device))


def _rep(tree):
    """Specs of a replicated subtree: None at every leaf."""
    return tree_map(lambda _: None, tree)


def _mixer2_geometry(mx):
    """(d_inner, d_state, n_heads) of a mamba2 mixer param dict."""
    n_heads = mx["A_log"].shape[0]
    d_inner = mx["out_proj"].shape[0]
    d_state = (mx["conv_w"].shape[1] - d_inner) // 2
    return d_inner, d_state, n_heads


def _mixer2_zxdt_idx(d_inner: int, d_state: int, n_heads: int, n: int) -> np.ndarray:
    """Column gather so that contiguous block k of the permuted axis is
    ``[z_k | x_k | dt_k]``: the shardable columns of mamba2's ``in_proj``
    layout [z | x | B | C | dt] (B/C are head-shared: a replicated leaf)."""
    m, nhl = d_inner // n, n_heads // n
    dt0 = 2 * d_inner + 2 * d_state
    idx = []
    for k in range(n):
        idx.extend(range(k * m, (k + 1) * m))                       # z_k
        idx.extend(range(d_inner + k * m, d_inner + (k + 1) * m))   # x_k
        idx.extend(range(dt0 + k * nhl, dt0 + (k + 1) * nhl))       # dt_k
    return np.asarray(idx, np.int64)


def _tp_prepare_mixer2(mx, l: int, n: int):
    """The mamba2 (SSD) mixer: heads (with dt_bias, A_log, D, their x
    columns, the scan state and norm_w) shard; B/C's in_proj columns and
    conv channels become replicated leaves that every rank computes alike."""
    d_inner, d_state, n_heads = _mixer2_geometry(mx)
    _check_div(f"bottleneck[{l}].n_heads", n_heads, n)
    _check_div(f"bottleneck[{l}].d_inner", d_inner, n)
    mx_p = {
        "in_proj_zxdt": _take(mx["in_proj"], _mixer2_zxdt_idx(d_inner, d_state, n_heads, n), 1),
        "in_proj_bc": mx["in_proj"][:, 2 * d_inner: 2 * d_inner + 2 * d_state],
        "conv_w_x": mx["conv_w"][:, :d_inner],
        "conv_b_x": mx["conv_b"][:d_inner],
        "conv_w_bc": mx["conv_w"][:, d_inner:],
        "conv_b_bc": mx["conv_b"][d_inner:],
        "dt_bias": mx["dt_bias"],
        "A_log": mx["A_log"],
        "D": mx["D"],
        "norm_w": mx["norm_w"],
        "out_proj": mx["out_proj"],
    }
    mx_s = {"in_proj_zxdt": 1, "in_proj_bc": None, "conv_w_x": 1, "conv_b_x": 0,
            "conv_w_bc": None, "conv_b_bc": None, "dt_bias": 0, "A_log": 0, "D": 0,
            "norm_w": 0, "out_proj": 0}
    return mx_p, mx_s


def _tp_unsplit_mixer2(mx_tp, n: int):
    """Inverse of :func:`_tp_prepare_mixer2`: the canonical mamba2 mixer
    leaves from the TP layout."""
    d_inner = mx_tp["out_proj"].shape[0]
    n_heads = mx_tp["A_log"].shape[0]
    d_state = mx_tp["in_proj_bc"].shape[1] // 2
    # columns of cat([zxdt, bc]) in the canonical layout, then their inverse
    cols = np.concatenate([_mixer2_zxdt_idx(d_inner, d_state, n_heads, n),
                           np.arange(2 * d_inner, 2 * d_inner + 2 * d_state)])
    in_proj = _take(torch.cat([mx_tp["in_proj_zxdt"], mx_tp["in_proj_bc"]], 1),
                    np.argsort(cols), 1)
    return {
        "in_proj": in_proj,
        "conv_w": torch.cat([mx_tp["conv_w_x"], mx_tp["conv_w_bc"]], 1),
        "conv_b": torch.cat([mx_tp["conv_b_x"], mx_tp["conv_b_bc"]]),
        "dt_bias": mx_tp["dt_bias"],
        "A_log": mx_tp["A_log"],
        "D": mx_tp["D"],
        "norm_w": mx_tp["norm_w"],
        "out_proj": mx_tp["out_proj"],
    }


def _tp_prepare_s4_mixer(mx, l: int, n: int):
    """The MambaS4 mixer: ``d_inner`` shards as mamba's (x|z interleave),
    ``input_linear`` row-parallel into the replicated S4 long convolution,
    ``output_linear`` column-parallel with its GLU [A | B] halves
    interleaved, ``out_proj`` row-parallel."""
    d_inner = mx["conv_w"].shape[1]
    _check_div(f"bottleneck[{l}].d_inner", d_inner, n)
    perm = _interleave_perm([d_inner, d_inner], n)
    mx_p = dict(mx)
    mx_p["in_proj"] = _take(mx["in_proj"], perm, 1)
    mx_p["output_linear_w"] = _take(mx["output_linear_w"], perm, 1)
    mx_p["output_linear_b"] = _take(mx["output_linear_b"], perm, 0)
    mx_s = {
        "in_proj": 1, "conv_w": 1, "conv_b": 0, "input_linear_w": 0,
        "input_linear_b": None,  # added once, after the psum
        "kernel": _rep(mx["kernel"]), "ssm_D": None,
        "output_linear_w": 1, "output_linear_b": 0, "out_proj": 0,
    }
    return mx_p, mx_s


def _tp_prepare_mha(bott, cfg, n: int):
    """The MHA ("CleanUNet") bottleneck, Megatron's construction: Q/K/V
    column-parallel over whole heads (a contiguous 1/n of the columns holds
    n_head/n heads), the output projection row-parallel, the FFN's
    up-projection column-parallel and down-projection row-parallel."""
    d = bott["layers"][0]["w_qs"].shape[0]
    _check_div("mha.n_head", cfg.tsfm_n_head, n)
    _check_div("mha.d_model", d, n)
    layers_p, layers_s = [], []
    for lp in bott["layers"]:
        _check_div("mha.ffn_d_inner", lp["ffn_b1"].shape[0], n)
        layers_p.append(dict(lp))
        layers_s.append({
            "w_qs": 1, "w_ks": 1, "w_vs": 1, "fc": 0,
            "attn_norm": {"scale": None, "bias": None},
            "ffn_w1": 1, "ffn_b1": 0, "ffn_w2": 0,
            "ffn_b2": None,  # added once, after the psum
            "ffn_norm": {"scale": None, "bias": None},
        })
    return ({"layers": layers_p, "enc_norm": dict(bott["enc_norm"])},
            {"layers": layers_s, "enc_norm": {"scale": None, "bias": None}})


def tp_prepare(params: Params, cfg: CleanUMambaConfig, n: int) -> Tuple[Params, Any]:
    """``(params_tp, specs)``: the params with their GLU and x|z column
    structures block-interleaved so that a contiguous 1/n slice is locally
    consistent, and a tree like it of the dim each leaf is sharded on (None:
    replicated).  Differentiable reindexing, done once per (params, n)."""
    if cfg.bottleneck == "lstm":
        # the LSTM recurrence needs the FULL h_{t-1} through the dense (h, 4h)
        # recurrent matrix: sharding the hidden dim costs one collective per
        # time step.  LSTM models train data-parallel.
        raise NotImplementedError(
            "tensor parallelism: the LSTM bottleneck's dense recurrence "
            "requires a per-timestep collective and does not shard; use "
            "data parallelism (see tp_prepare docstring)"
        )
    out_p: Params = {}
    out_s: Params = {}

    enc_p, enc_s = [], []
    for i, ep in enumerate(params["encoder"]):
        if cfg.group_of_layer(i) != 1:
            raise NotImplementedError("TP encoder requires groups == 1")
        if cfg.kernel_size != 2 * cfg.stride:
            raise NotImplementedError("TP encoder requires K == 2*S")
        _check_div(f"encoder[{i}].H", ep["conv_w"].shape[2], n)
        enc_p.append(dict(ep))
        # conv column-parallel over its outputs, the mix row-parallel over H;
        # mix_b is added once, after the psum
        enc_s.append({"conv_w": 2, "conv_b": 0, "mix_w": 1, "mix_b": None})
    out_p["encoder"], out_s["encoder"] = enc_p, enc_s

    if "residual_projection" in params:
        out_p["residual_projection"] = params["residual_projection"]
        out_s["residual_projection"] = _rep(params["residual_projection"])
    for name in ("tsfm_conv1", "tsfm_conv2"):
        out_p[name] = params[name]
        out_s[name] = {"w": None, "b": None}

    if cfg.bottleneck == "mha":
        out_p["bottleneck"], out_s["bottleneck"] = _tp_prepare_mha(params["bottleneck"], cfg, n)
        return _tp_prepare_decoder(params, cfg, n, out_p, out_s)

    layers_p, layers_s = [], []
    for l, lp in enumerate(params["bottleneck"]["layers"]):
        mx = lp["mixer"]
        if "dt_bias" in mx:  # mamba2 (SSD): per-head scalar decay
            mx_p, mx_s = _tp_prepare_mixer2(mx, l, n)
        elif "input_linear_w" in mx:  # mamba_s4 (S4 inner SSM)
            mx_p, mx_s = _tp_prepare_s4_mixer(mx, l, n)
        else:
            d_inner = mx["dt_proj_w"].shape[1]
            _check_div(f"bottleneck[{l}].d_inner", d_inner, n)
            mx_p = dict(mx)
            mx_p["in_proj"] = _take(mx["in_proj"], _interleave_perm([d_inner, d_inner], n), 1)
            mx_s = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj_w": 1,
                    "dt_proj_b": 0, "A_log": 0, "D": 0, "out_proj": 0}
        layers_p.append({"norm": dict(lp["norm"]), "mixer": mx_p})
        layers_s.append({"norm": _rep(lp["norm"]), "mixer": mx_s})
    out_p["bottleneck"] = {"layers": layers_p, "norm_f": dict(params["bottleneck"]["norm_f"])}
    out_s["bottleneck"] = {"layers": layers_s, "norm_f": _rep(params["bottleneck"]["norm_f"])}
    return _tp_prepare_decoder(params, cfg, n, out_p, out_s)


def _decoder_perms(cfg, n, j, n_levels, mix_out):
    """The decoder level's column ([bypass | A | B]) and row ([bypass | AB])
    interleaves."""
    bp = cfg.bypass_of_layer(n_levels - 1 - j)
    nAB = (mix_out - bp) // 2
    _check_div(f"decoder[{j}].bypass", bp, n)
    _check_div(f"decoder[{j}].glu_pair", nAB, n)
    return _interleave_perm([bp, nAB, nAB], n), _interleave_perm([bp, nAB], n)


def _tp_prepare_decoder(params, cfg, n, out_p, out_s):
    """Decoder half of :func:`tp_prepare` (every bottleneck family): the 1x1
    column-parallel with the GLU's column structure interleaved, the ConvT
    row-parallel."""
    D = len(params["encoder"])
    dec_p, dec_s = [], []
    for j, dp in enumerate(params["decoder"]):
        perm_cols, perm_rows = _decoder_perms(cfg, n, j, D, dp["mix_w"].shape[2])
        dec_p.append({
            "mix_w": _take(dp["mix_w"], perm_cols, 2),
            "mix_b": _take(dp["mix_b"], perm_cols, 0),
            "convt_w": _take(dp["convt_w"], perm_rows, 1),
            "convt_b": dp["convt_b"],
        })
        dec_s.append({"mix_w": 2, "mix_b": 0, "convt_w": 1,
                      "convt_b": None})  # convt_b added once, after the psum
    out_p["decoder"], out_s["decoder"] = dec_p, dec_s
    return _in_order(params, out_p), _in_order(params, out_s)


def _in_order(src, out):
    """``out`` with the dict keys it shares with ``src`` in ``src``'s order
    (then its own), at every level: the order :func:`tp_permute_like` keeps,
    so that ``tensor_leaves`` pairs a TP tree's leaves with its moments'."""
    if isinstance(out, dict) and isinstance(src, dict):
        keys = [k for k in src if k in out] + [k for k in out if k not in src]
        return {k: _in_order(src.get(k), out[k]) for k in keys}
    if isinstance(out, list) and isinstance(src, (list, tuple)):
        return [_in_order(a, b) for a, b in zip(src, out)]
    return out


def tp_permute_like(tree: Params, cfg: CleanUMambaConfig, n: int,
                    inverse: bool = False) -> Params:
    """Apply :func:`tp_prepare`'s interleaves (or, with ``inverse=True``,
    undo them) to any tree with the params' structure: the params
    themselves, or Adam's mu/nu.  Returns a new tree; ``tree`` is kept."""
    out = tree_map(lambda x: x, tree)  # a new structure over the same leaves
    for l, lp in enumerate(out["bottleneck"]["layers"]):
        if "mixer" not in lp:  # mha: heads are contiguous, no permutation
            continue
        mx = lp["mixer"]
        if "dt_bias" in mx:  # mamba2: split <-> canonical restructuring
            lp["mixer"] = (_tp_unsplit_mixer2(mx, n) if inverse
                           else _in_order(mx, _tp_prepare_mixer2(mx, l, n)[0]))
            continue
        d_inner = mx["conv_w"].shape[1]
        perm = _interleave_perm([d_inner, d_inner], n)
        if inverse:
            perm = np.argsort(perm)
        mx["in_proj"] = _take(mx["in_proj"], perm, 1)
        if "input_linear_w" in mx:  # mamba_s4: the GLU [A|B] interleave too
            mx["output_linear_w"] = _take(mx["output_linear_w"], perm, 1)
            mx["output_linear_b"] = _take(mx["output_linear_b"], perm, 0)
    D = len(out["encoder"])
    for j, dp in enumerate(out["decoder"]):
        perm_c, perm_r = _decoder_perms(cfg, n, j, D, dp["mix_w"].shape[2])
        if inverse:
            perm_c, perm_r = np.argsort(perm_c), np.argsort(perm_r)
        dp["mix_w"] = _take(dp["mix_w"], perm_c, 2)
        dp["mix_b"] = _take(dp["mix_b"], perm_c, 0)
        dp["convt_w"] = _take(dp["convt_w"], perm_r, 1)
    return out


def tp_unprepare(params_tp: Params, cfg: CleanUMambaConfig, n: int) -> Params:
    """Inverse of :func:`tp_prepare`: a (gathered) TP params tree back in the
    canonical layout, e.g. to bank a checkpoint after TP training."""
    return tp_permute_like(params_tp, cfg, n, inverse=True)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def tp_opt_state_like(opt_state, params_template: Params, cfg: CleanUMambaConfig, n: int,
                      inverse: bool = False):
    """Permute (or un-permute) every params-structured subtree of an
    optimizer state (``{"count", "mu", "nu"}``, ``train/optim.py``) with
    :func:`tp_permute_like`, so that TP training banks canonical moments and
    a resume re-permutes them.  ``params_template`` has the structure of mu
    and nu as they are now: the canonical params going forward, the TP
    layout with ``inverse=True`` (mamba2's TP layout has other keys)."""
    want = _structure(params_template)

    def walk(x):
        if _structure(x) == want:
            return tp_permute_like(x, cfg, n, inverse)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return x

    return walk(opt_state)


def _map_specs(fn, tree, specs):
    """fn(leaf, spec) over ``tree`` and its specs, in the same structure."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def tp_shard(params_tp: Params, specs, n: int, k: int) -> Params:
    """Rank k's part of the TP layout: the k-th contiguous 1/n of every
    sharded leaf along its dim, as a contiguous tensor (K1 takes contiguous
    inputs); replicated and non-tensor leaves as they are."""
    def take(x, dim):
        if dim is None or not isinstance(x, torch.Tensor):
            return x
        m = x.shape[dim] // n
        return x.narrow(dim, k * m, m).contiguous()

    return _map_specs(take, params_tp, specs)


def tp_gather(mesh: Mesh, local: Params, specs) -> Params:
    """The whole TP layout from every rank's part (:func:`tp_shard`'s
    inverse), over the mesh's model group; every rank of the row gets it."""
    def gather(x, dim):
        if dim is None or not isinstance(x, torch.Tensor):
            return x
        parts = all_gather(x.detach(), mesh.model_group, mesh.model_size, mesh.model_rank)
        return torch.cat(list(parts), dim)

    return _map_specs(gather, local, specs)


# --------------------------------------------------------------------------
# Local (per-rank) forward with explicit collectives
# --------------------------------------------------------------------------

def _tp_encoder_level(p, x, cfg, i, group):
    x = conv1d_strided_matmul(x, p["conv_w"], p["conv_b"], stride=cfg.stride)
    part = torch.relu(x) @ p["mix_w"][0].to(x.dtype)
    full = psum(part, group) + p["mix_b"].to(x.dtype)
    return glu_activation(full, cfg.glu_activation, cfg.bypass_of_layer(i))


def _tp_decoder_level(p, x, cfg, enc_i, relu, group, n):
    part = x @ p["mix_w"][0].to(x.dtype) + p["mix_b"].to(x.dtype)
    # local GLU: bypass/A/B were block-interleaved, so the local slice is
    # [bypass_k | A_k | B_k] and the rank's bypass width is bp/n
    x = glu_activation(part, cfg.glu_activation, cfg.bypass_of_layer(enc_i) // n)
    y = conv_transpose1d(x, p["convt_w"], None, stride=cfg.stride)
    y = psum(y, group) + p["convt_b"].to(y.dtype)
    return torch.relu(y) if relu else y


def _tp_mixer_forward(p, x, group):
    """The mamba mixer on the rank's ``m = d_inner/n`` channels, with its two
    psums; the scan is K1 (K2 in its backward) on CUDA."""
    dt_rank, m = p["dt_proj_w"].shape
    d_state = (p["x_proj"].shape[1] - dt_rank) // 2
    xz = x @ p["in_proj"].to(x.dtype)  # (B, T, 2m) = [x_k | z_k]
    xs, z = xz[..., :m], xz[..., m:]
    xs = F.silu(causal_depthwise_conv(xs, p["conv_w"], p["conv_b"]))
    dbc = psum(xs @ p["x_proj"].to(xs.dtype), group)  # row-parallel
    dt = dbc[..., :dt_rank] @ p["dt_proj_w"].to(dbc.dtype) + p["dt_proj_b"].to(dbc.dtype)
    dt = F.softplus(dt.float())
    Bm = dbc[..., dt_rank: dt_rank + d_state].contiguous()
    Cm = dbc[..., dt_rank + d_state:].contiguous()
    A = -torch.exp(p["A_log"].float())
    h0 = torch.zeros((xs.shape[0], m, d_state), dtype=torch.float32, device=xs.device)
    y, _ = selective_scan_fn(xs.contiguous(), dt, A, Bm, Cm, p["D"].float(), h0)
    return psum((y * F.silu(z)) @ p["out_proj"].to(y.dtype), group)  # row-parallel


def _tp_mixer2_forward(p, x, group, n, chunk):
    """The mamba2 (SSD) mixer on the rank's m = d_inner/n channels and
    n_heads/n heads; B/C from the replicated leaves.  The gated RMSNorm's
    mean square spans the full d_inner: its sum of squares is psum-ed."""
    m = p["out_proj"].shape[0]
    nhl = p["A_log"].shape[0]
    ds = p["in_proj_bc"].shape[1] // 2
    zxdt = x @ p["in_proj_zxdt"].to(x.dtype)
    z, xs, dt_h = zxdt[..., :m], zxdt[..., m: 2 * m], zxdt[..., 2 * m:]
    xs = F.silu(causal_depthwise_conv(xs, p["conv_w_x"], p["conv_b_x"]))
    bc = x @ p["in_proj_bc"].to(x.dtype)
    bc = F.silu(causal_depthwise_conv(bc, p["conv_w_bc"], p["conv_b_bc"]))
    dt_h = F.softplus(dt_h.float() + p["dt_bias"].float())
    A_head = -torch.exp(p["A_log"].float())
    Bsz, T, _ = xs.shape
    y, _ = ssd_scan_grad(xs.reshape(Bsz, T, nhl, m // nhl), dt_h, A_head, bc[..., :ds],
                         bc[..., ds:], p["D"], None, min(chunk * 2, 64))
    yf = y.reshape(Bsz, T, m).float() * F.silu(z.float())
    ms = psum(yf.square().sum(dim=-1, keepdim=True), group) / (m * n)
    y = (yf * torch.rsqrt(ms + 1e-5) * p["norm_w"].float()).to(x.dtype)
    return psum(y @ p["out_proj"].to(y.dtype), group)


def _tp_s4_mixer_forward(p, x, group):
    """The MambaS4 mixer on the rank's d_inner/n channels; the S4 long
    convolution runs replicated on the full (small) H."""
    m = p["conv_w"].shape[1]
    xz = x @ p["in_proj"].to(x.dtype)  # (B, T, 2m) = [x_k | z_k]
    xs, z = xz[..., :m], xz[..., m:]
    xs = F.silu(causal_depthwise_conv(xs, p["conv_w"], p["conv_b"]))
    # input_linear row-parallel: psum of the (B, T, H) projection, then its bias
    u = psum(xs @ p["input_linear_w"].to(xs.dtype), group) + p["input_linear_b"].to(xs.dtype)
    y = fft_long_conv(p, u)
    # output_linear column-parallel: the local slice is [A_k | B_k]
    y = y @ p["output_linear_w"].to(x.dtype) + p["output_linear_b"].to(x.dtype)
    half = y.shape[-1] // 2
    y = y[..., :half] * torch.sigmoid(y[..., half:]) * F.silu(z)
    return psum(y @ p["out_proj"].to(y.dtype), group)  # row-parallel


def _tp_mha_forward(params, x, cfg, group, n):
    """The MHA bottleneck with n_head/n whole heads a rank and two psums a
    layer."""
    eps = cfg.norm_epsilon
    heads_local = cfg.tsfm_n_head // n
    x = layer_norm(x, params["enc_norm"]["scale"], params["enc_norm"]["bias"], eps)
    for p in params["layers"]:
        q, k, v = (x @ p[w].to(x.dtype) for w in ("w_qs", "w_ks", "w_vs"))
        a = psum(_causal_attention(q, k, v, heads_local) @ p["fc"].to(x.dtype), group)
        x = layer_norm(a + x, p["attn_norm"]["scale"], p["attn_norm"]["bias"], eps)
        f = torch.relu(x @ p["ffn_w1"].to(x.dtype) + p["ffn_b1"].to(x.dtype))
        f = psum(f @ p["ffn_w2"].to(x.dtype), group) + p["ffn_b2"].to(x.dtype)
        x = layer_norm(f + x, p["ffn_norm"]["scale"], p["ffn_norm"]["bias"], eps)
    return x


def _norm(p, x, cfg):
    if cfg.rms_norm:
        return rms_norm(x, p["scale"], cfg.norm_epsilon)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_epsilon)


def _tp_bottleneck(params, x, cfg, group, n, chunk):
    hidden, residual = x, None
    for lp in params["layers"]:
        residual = hidden.float() if residual is None else hidden.float() + residual
        hidden = _norm(lp["norm"], residual, cfg).to(x.dtype)
        mx = lp["mixer"]
        if "dt_bias" in mx:
            hidden = _tp_mixer2_forward(mx, hidden, group, n, chunk)
        elif "input_linear_w" in mx:
            hidden = _tp_s4_mixer_forward(mx, hidden, group)
        else:
            hidden = _tp_mixer_forward(mx, hidden, group)
    residual = hidden.float() + residual
    return _norm(params["norm_f"], residual, cfg).to(x.dtype)


def _tp_forward_local(params, noisy, cfg, group, n, chunk=32):
    """One rank's program: ``models.cleanumamba.forward`` with the TP level
    and mixer variants (activations replicated over the model group)."""
    if noisy.ndim == 3:
        noisy = noisy.reshape(noisy.shape[0], -1)
    B, L = noisy.shape
    x = noisy[..., None]
    if cfg.normalize_input:
        std = x.std(dim=1, keepdim=True, correction=0) + 1e-3  # jnp.std: population
        x = x / std
    x = F.pad(x, (0, 0, 0, cfg.valid_length(L) - L))

    skips = []
    for i, ep in enumerate(params["encoder"]):
        x = _tp_encoder_level(ep, x, cfg, i, group)
        skips.append(x)
    if cfg.residual_projection:
        skips = [s @ rp["w"][0].to(s.dtype) + rp["b"].to(s.dtype)
                 for s, rp in zip(skips, params["residual_projection"])]
    skips = skips[::-1]

    x = x @ params["tsfm_conv1"]["w"][0].to(x.dtype) + params["tsfm_conv1"]["b"].to(x.dtype)
    if cfg.bottleneck == "mha":
        x = _tp_mha_forward(params["bottleneck"], x, cfg, group, n)
    else:
        x = _tp_bottleneck(params["bottleneck"], x, cfg, group, n, chunk)
    x = x @ params["tsfm_conv2"]["w"][0].to(x.dtype) + params["tsfm_conv2"]["b"].to(x.dtype)

    n_dec = len(params["decoder"])
    for j, dp in enumerate(params["decoder"]):
        x = x + skips[j][:, : x.shape[1], :]
        x = _tp_decoder_level(dp, x, cfg, n_dec - 1 - j, relu=(j != n_dec - 1), group=group,
                              n=n)
    y = x[:, :L, 0]
    if cfg.normalize_input:
        y = y * std[:, 0, :]
    return y


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------

def tp_forward(params: Params, noisy, cfg: CleanUMambaConfig, mesh: Mesh, chunk: int = 32):
    """Tensor-parallel offline forward over the mesh's model axis.

    Every rank passes the whole canonical ``params`` and the whole batch
    ``noisy`` (B, L) and gets the whole output back.  On a 2-D mesh the batch
    is also split over the data axis (DP x TP) and the outputs gathered.
    Equals ``models.cleanumamba.forward``.  Differentiable over the model
    axis only (the data axis' gather is not).
    """
    n = mesh.model_size
    params_tp, specs = tp_prepare(params, cfg, n)
    local = tp_shard(params_tp, specs, n, mesh.model_rank)
    y = _tp_forward_local(local, batch_sharding(mesh, noisy, 0), cfg, mesh.model_group, n, chunk)
    if mesh.data_group is None:
        return y
    parts = all_gather(y, mesh.data_group, mesh.data_size, mesh.data_rank)
    return parts.reshape(-1, *y.shape[1:])


def spec_leaves(params_tp, specs):
    """The spec of each tensor leaf of ``params_tp``, in ``tensor_leaves``
    order (looked up by key: the two trees' dict orders may differ)."""
    out = []
    _map_specs(lambda x, s: out.append(s) if isinstance(x, torch.Tensor) else None,
               params_tp, specs)
    return out


def make_tp_grad_fn(cfg: CleanUMambaConfig, loss_cfg, mesh: Mesh, specs, bf16: bool = True,
                    chunk: int = 32, remat: bool = False):
    """Returns grad_fn(params_local, clean, noisy) -> (grads, aux): the
    gradient of the rank's TP params (:func:`tp_shard`'s part, ``specs``
    from :func:`tp_prepare`) on the rank's batch (accum, B, L), as JAX's
    ``make_tp_train_step`` builds it:

    - the differentiated scalar is the rank's loss divided by n.  Every rank
      seeds its own output, and psum's adjoint is psum, so autograd yields
      the gradient of the sum over the ranks of their scalars: the loss is
      already the full loss on every rank, so that sum is the loss, and
      every sharded leaf's gradient is exactly its true shard;
    - a replicated leaf's gradient on a rank holds only its own shard's
      adjoint paths: it is summed over the model group;
    - then every gradient and aux is averaged over the data group.

    The grads are the micro-batch mean, fp32; aux the micro-batch means of
    the loss and its parts.
    """
    n = mesh.model_size
    group = mesh.model_group

    def fwd(p, noisy):
        return _tp_forward_local(p, noisy, cfg, group, n, chunk)

    def micro_loss(p, clean, noisy):
        if bf16:
            p = tree_map(lambda x: x.to(torch.bfloat16) if isinstance(x, torch.Tensor)
                         and x.dtype == torch.float32 else x, p)
            noisy = noisy.to(torch.bfloat16)
        y = checkpoint(fwd, p, noisy, use_reentrant=False) if remat else fwd(p, noisy)
        loss, aux = loss_fn(y.float(), clean.float(), loss_cfg)
        return loss / n, aux

    def grad_fn(params, clean, noisy):
        flat_specs = spec_leaves(params, specs)
        grads, auxs = None, []
        for c, nz in zip(clean, noisy):
            leaf_params = tree_map(lambda x: x.detach().requires_grad_()
                                   if isinstance(x, torch.Tensor) else x, params)
            loss, aux = micro_loss(leaf_params, c, nz)
            g = torch.autograd.grad(loss, tensor_leaves(leaf_params))
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            auxs.append({k: v.detach() for k, v in aux.items()})
        grads = [g.float() / clean.shape[0] for g in grads]
        rep = [i for i, s in enumerate(flat_specs) if s is None]
        for i, g in zip(rep, psum_leaves(mesh, [grads[i] for i in rep])):
            grads[i] = g
        keys = sorted(auxs[0])
        aux = [torch.stack([a[k] for a in auxs]).mean() for k in keys]
        both = pmean(mesh, grads + aux)
        return tree_unflatten(params, both[:len(grads)]), dict(zip(keys, both[len(grads):]))

    return grad_fn


def make_tp_train_step(cfg: CleanUMambaConfig, loss_cfg, opt_cfg, mesh: Mesh,
                       bf16: bool = True, chunk: int = 32, remat: bool = False):
    """Tensor-parallel (x data-parallel on a 2-D mesh) train step.

    Returns ``make``; ``make(params) -> (params_tp, opt_state, step)``: the
    rank's part of the TP layout of the canonical ``params``
    (:func:`tp_prepare`, :func:`tp_shard`), Adam's state on it (the moments
    shard with their parameters), and ``step(params_tp, opt_state, (clean,
    noisy)) -> (params_tp, opt_state, aux)``.  clean, noisy: (accum, B, L),
    the rank's data-axis part of the batch (``parallel.batch_sharding(mesh,
    x, 1)`` of the global one; every rank of a model row passes the same);
    the leading axis is accumulated, as in ``make_train_step``.  The gradient
    is :func:`make_tp_grad_fn`'s.  The clip uses the true global norm (the
    squares of the sharded leaves summed over the model group, plus the
    replicated leaves'), so the port's optimizer runs with its clip off
    (``clip_grad_norm_max=1e30``).  aux adds ``grad_norm`` (before the clip)
    and ``grads_finite``.
    """
    max_norm = float(opt_cfg.clip_grad_norm_max)
    optimizer = make_optimizer(dataclasses.replace(opt_cfg, clip_grad_norm_max=1e30))
    n = mesh.model_size

    def make(params):
        params_tp, specs = tp_prepare(params, cfg, n)
        local = tp_shard(params_tp, specs, n, mesh.model_rank)
        grad_fn = make_tp_grad_fn(cfg, loss_cfg, mesh, specs, bf16, chunk, remat)
        flat_specs = spec_leaves(local, specs)

        def step(p_tp, opt_state, batch):
            grads, aux = grad_fn(p_tp, *batch)
            g = tensor_leaves(grads)
            sq_sh = sum(x.square().sum() for x, s in zip(g, flat_specs) if s is not None)
            sq_rep = sum(x.square().sum() for x, s in zip(g, flat_specs) if s is None)
            norm = torch.sqrt(psum(sq_sh, mesh.model_group) + sq_rep)
            scale = torch.where(norm > max_norm, max_norm / (norm + 1e-12),
                                torch.ones_like(norm))
            grads = tree_unflatten(grads, [x * scale for x in g])
            updates, opt_state = optimizer.update(grads, opt_state, p_tp)
            aux["grad_norm"] = norm
            aux["grads_finite"] = torch.isfinite(norm)
            return apply_updates(p_tp, updates), opt_state, aux

        return local, optimizer.init(local), step

    return make
