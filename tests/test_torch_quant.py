"""PyTorch port weight-only int8 (``quant.py``, the int8 K3/K4 packs and
``Streamer(weights="int8")``) vs the JAX package.

The same numpy weights go through ``cleanumamba_tpu.quant`` and the port's
``quant``: the same leaves are selected, the int8 values agree bit for bit
and the scales within 1 ulp.  An int8 level pack's plain K3/K4 (what the CUDA
kernels are held to on the card) matches the JAX Pallas kernels in interpret
mode with the JAX int8 pack within 2e-2 of max|ref| (bf16 compute), at every
level of a small config quantized at ``min_size=64``, which also leaves
level 0's conv and the last ConvTranspose dense beside an int8 mix.
``Streamer(weights="int8")`` matches the JAX ``Streamer`` for ``fused=False``
(fp32 view, 1e-4 of max|ref|), ``fused=True`` (int8 packs, bf16, 2e-2) and
``"auto"`` (the per-op path in both packages).  The port runs before JAX in
each test (the interpret-mode ordering of ``test_torch_fused``).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import quant as jq
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.ops.pallas import stream_fused as jsf
from cleanumamba_tpu.streaming import Streamer as JaxStreamer
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import quant as tq
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models.cleanumamba import init_params
from cleanumamba_tpu_torch.ops.cuda import stream_fused as tsf
from cleanumamba_tpu_torch.params import from_numpy, to_device, to_numpy

TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32)
CKPTS = ["artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"]
BF16_TOL = 2e-2  # of max|ref|: bf16 products, another summation order
FP32_TOL = 1e-4
MIN = 64  # quant_min_size at which the tiny model's mixes quantize and its level-0 conv does not


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig(**TINY)
    pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, pn


def _numpy_tree(name):
    """(numpy params, their source) for the quantization parity cases."""
    if name == "tiny":
        pn = jax.tree_util.tree_map(np.asarray,
                                    jax_init_params(jax.random.PRNGKey(0), JaxConfig(**TINY)))
        return pn, 64
    if name == "e8":  # E8-shaped leaves: the full model from the port's seeded init
        return to_numpy(init_params(CleanUMambaConfig(), torch.Generator().manual_seed(0),
                                    "cpu")), 4096
    return jax.tree_util.tree_map(np.asarray, jax_load_checkpoint(name)["params"]), 4096


def _port_leaves(tree):
    """{path: leaf} of a port tree, quantized dicts as leaves."""
    out = {}
    tq._map(lambda path, x: out.__setitem__(path, x), tree)
    return out


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree, quantized dicts as leaves, paths as the port's."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jq._is_quantized)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): x
            for path, x in flat}


@pytest.mark.parametrize("name", ["tiny", "e8"] + CKPTS)
def test_quantize_matches_jax(name):
    """Same selection (sensitive keys included), int8 values bit for bit,
    scales within 1 ulp."""
    pn, min_size = _numpy_tree(name)
    ours = tq.quantize_params(from_numpy(pn, "cpu"), min_size)
    theirs = jq.quantize_params(pn, min_size)
    got, want = _port_leaves(ours), _jax_leaves(theirs)
    assert set(got) == set(want)
    n_q = 0
    for path, a in got.items():
        b = want[path]
        assert tq.is_quantized(a) == jq._is_quantized(b)
        if not tq.is_quantized(a):
            continue
        n_q += 1
        np.testing.assert_array_equal(a[tq._Q_TAG].numpy(), np.asarray(b[jq._Q_TAG]))
        assert a["scale"].dtype == torch.float32 and a["scale"].shape == b["scale"].shape
        np.testing.assert_array_max_ulp(a["scale"].numpy(), np.asarray(b["scale"]), maxulp=1)
    assert n_q >= 8
    assert tq._SENSITIVE_KEYS == jq._SENSITIVE_KEYS
    if "bottleneck" in ours and "A_log" in ours["bottleneck"]["layers"][0]["mixer"]:
        assert not tq.is_quantized(tq.quantize_params(from_numpy(pn, "cpu"), 1)[
            "bottleneck"]["layers"][0]["mixer"]["A_log"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dequantize_matches_jax(tiny, dtype):
    _, pn = tiny
    ours = tq.dequantize_params(tq.quantize_params(from_numpy(pn, "cpu"), MIN), dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    theirs = jq.dequantize_params(jq.quantize_params(pn, MIN), jdt)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(ours)), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_roundtrip_error_within_half_scale(tiny):
    """|w - q*scale| <= scale/2 per column; the per-tensor diagnostic agrees
    with JAX's and stays under 1/254 of max|w|."""
    _, pn = tiny
    pt = from_numpy(pn, "cpu")
    qt = tq.quantize_params(pt, MIN)
    dq = tq.dequantize_params(qt, torch.float32)
    checked = 0
    for w, q, d in zip(tq._leaves(pt), tq._leaves(qt), tq._leaves(dq)):
        if tq.is_quantized(q):
            # scale/2 plus the fp32 rounding of the product and of the division
            assert ((w - d).abs() <= q["scale"] * (0.5 + 1e-5)).all()
            checked += 1
    assert checked >= 8
    err = tq.quantization_error(pt, qt)
    assert err <= 1.0 / 254 + 1e-6
    assert err == pytest.approx(jq.quantization_error(pn, jq.quantize_params(pn, MIN)),
                                rel=1e-5, abs=1e-9)
    assert tq.count_quantized(qt) == checked


# --- int8 level packs: plain K3/K4 vs the JAX kernels in interpret mode ------

@pytest.fixture(scope="module")
def qparams(tiny):
    """(JAX config, port config, JAX int8 tree, port int8 tree), min_size 64."""
    jcfg, pn = tiny
    return (jcfg, CleanUMambaConfig(**dataclasses.asdict(jcfg)), jq.quantize_params(pn, MIN),
            tq.quantize_params(from_numpy(pn, "cpu"), MIN))


def _rand(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


def _close(got, want, tol=BF16_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max()


def _jax_logical(ja):
    """The JAX pack's matrices as its kernel reads them (``_deq``)."""
    out = {}
    for k, v in ja.items():
        if k.endswith("_scale"):
            continue
        out[k] = jsf._deq(v, ja.get(k + "_scale"), jnp.bfloat16) if k + "_scale" in ja else v
    return out


def _assert_int8_pack(tpk, jpk):
    """The port's tiled int8 pack dequantises to the JAX kernel's matrices,
    bit for bit, and has the same weight type product by product."""
    (ta, tm), (ja, jm) = tpk, jpk
    logical, want = tsf.unpack_level(ta, tm), _jax_logical(ja)
    assert set(logical) == set(want)
    for k in want:
        np.testing.assert_array_equal(logical[k].float().numpy(),
                                      np.asarray(want[k], np.float32), err_msg=k)
    assert ("mw_scale" in ta) == ("mwa_scale" in ja)
    assert ("cw_scale" in ta) == ("cw_scale" in ja)
    assert ("ctw_scale" in ta) == ("cwlo_scale" in ja)


@pytest.mark.parametrize("level", range(4))
def test_int8_encoder_level_matches_jax_interpret(qparams, level):
    jcfg, cfg, qj, qt = qparams
    S, D = cfg.stride, cfg.encoder_n_layers
    tpk = tsf.pack_encoder_level(qt["encoder"][level], cfg, level, torch.bfloat16)
    jpk = jsf.pack_encoder_level(qj["encoder"][level], jcfg, level, jnp.bfloat16)
    _assert_int8_pack(tpk, jpk)
    assert tpk[0]["mw"].dtype == torch.int8
    assert (tpk[0]["cw"].dtype == torch.int8) == (level > 0)  # level 0's conv is 32 values
    T = S ** (D - 1 - level)
    x = _rand(level, 2, cfg.kernel_size + S * (T - 1), tpk[1]["Cin"])
    win_t = tsf.encoder_windows(torch.from_numpy(x), cfg.kernel_size, S)
    got = tsf.fused_encoder_level(win_t, *tpk)
    assert got.dtype == torch.bfloat16 and got.shape == (2, T, tpk[1]["C2"] // 2)
    win_j = jsf.encoder_windows(jnp.asarray(x), cfg.kernel_size, S)
    want = jsf.fused_encoder_level(win_j, *jpk, compute_dtype=jnp.bfloat16, interpret=True)
    _close(got.float().numpy(), want)


@pytest.mark.parametrize("level_j", range(4))
@pytest.mark.parametrize("has_prev", [False, True])
def test_int8_decoder_level_matches_jax_interpret(qparams, level_j, has_prev):
    jcfg, cfg, qj, qt = qparams
    S, D = cfg.stride, cfg.encoder_n_layers
    enc_i = D - 1 - level_j
    tpk = tsf.pack_decoder_level(qt["decoder"][level_j], cfg, enc_i, torch.bfloat16)
    jpk = jsf.pack_decoder_level(qj["decoder"][level_j], jcfg, enc_i, jnp.bfloat16)
    _assert_int8_pack(tpk, jpk)
    # the last level's ConvTranspose (4 x 8 x 1) stays dense beside its int8 mix
    assert (tpk[0]["ctw"].dtype == torch.int8) == (level_j < D - 1)
    T, Cx, SC = S ** level_j, tpk[1]["Cx"], S * tpk[1]["Cout"]
    x, skip = _rand(10 + level_j, 2, T, Cx), _rand(20 + level_j, 2, T, Cx)
    prev = _rand(30 + level_j, 2, 1, SC) if has_prev else None
    relu = level_j != D - 1
    out_t, tail_t = tsf.fused_decoder_level(
        torch.from_numpy(x), torch.from_numpy(skip),
        None if prev is None else torch.from_numpy(prev), *tpk, relu=relu)
    out_j, tail_j = jsf.fused_decoder_level(
        jnp.asarray(x), jnp.asarray(skip), None if prev is None else jnp.asarray(prev),
        *jpk, relu=relu, compute_dtype=jnp.bfloat16, interpret=True)
    _close(out_t.float().numpy(), out_j)
    _close(tail_t.float().numpy(), tail_j)


@pytest.mark.parametrize("ckpt", CKPTS)
def test_int8_ragged_packs_plan_and_unpack(ckpt):
    """Every level of both pruned checkpoints quantized at min_size 4096 packs
    (ragged widths, dense and int8 products mixed within a level), its plan
    keeps int8 slabs within the bulk copies' 16-byte granule, and it unpacks
    to the fp32 view's matrices rounded to bf16."""
    from cleanumamba_tpu_torch.params import load_checkpoint

    cfg, pt = load_checkpoint(ckpt, "cpu")
    qt = tq.quantize_params(pt, 4096)
    dense = tq.dequantize_params(qt, torch.float32)
    D, mixed = cfg.encoder_n_layers, 0
    for kind, idx in [("enc", i) for i in range(D)] + [("dec", j) for j in range(D)]:
        if kind == "enc":
            arrays, meta = tsf.pack_encoder_level(qt["encoder"][idx], cfg, idx, torch.bfloat16)
            ref = tsf.pack_encoder_level(dense["encoder"][idx], cfg, idx, torch.bfloat16)
        else:
            arrays, meta = tsf.pack_decoder_level(qt["decoder"][idx], cfg, D - 1 - idx,
                                                  torch.bfloat16)
            ref = tsf.pack_decoder_level(dense["decoder"][idx], cfg, D - 1 - idx,
                                         torch.bfloat16)
        types = {w.dtype for w in tsf._level_weights(arrays)}
        mixed += types == {torch.int8, torch.bfloat16}
        got, want = tsf.unpack_level(arrays, meta), tsf.unpack_level(*ref)
        for k in want:
            assert torch.equal(got[k], want[k]), (ckpt, kind, idx, k)
        for name in tsf._WEIGHTS:
            if name + "_scale" in arrays:
                nt, K, NW, tile = arrays[name].shape
                assert arrays[name + "_scale"].shape == (nt, NW, tile)
                assert (NW * tile) % 16 == 0  # an int8 row: one bulk-copy granule or more
    assert mixed >= 1


@pytest.mark.parametrize("rows,K,N,NW,NI", [
    (1, 3072, 768, 1, 1), (128, 64, 64, 2, 1), (2, 768, 1536, 2, 2), (8, 1024, 768, 2, 1),
    (3, 69, 67, 2, 2), (17, 148, 36, 2, 1), (1, 1, 1, 1, 1),
])
def test_int8_plan_keeps_the_kernel_limits(rows, K, N, NW, NI):
    """An int8 product's split: half the slab bytes, so it splits no more
    than the bf16 product; the slab, its scales and the buffers fit."""
    splits, groups, kblk, rpb, R = tsf._plan(rows, K, N, NW, NI, 1)
    assert splits in (1, 2, 4, 8) and kblk % 8 == 0 and splits * kblk >= K
    assert kblk * tsf.TILE * NW <= tsf._SLAB_MAX
    assert (128 + kblk * tsf.TILE * NW + NW * tsf.TILE * 4
            + (NI * R * kblk + (8 * R + rpb) * NW * tsf.TILE) * 4) <= tsf._SMEM_LIMIT
    assert splits <= tsf._plan(rows, K, N, NW, NI, 2)[0]


# --- Streamer(weights="int8") against the JAX Streamer -----------------------

def _stream(s, audio, hop):
    outs = [s.feed(audio[:, i: i + hop]) for i in range(0, audio.shape[1], hop)]
    return np.concatenate(outs + [s.flush()], axis=1)


@pytest.mark.parametrize("fused", [False, True, "auto"], ids=["plain", "fused", "auto"])
def test_int8_streamer_matches_jax(tiny, fused):
    """One-frame hops (the single-frame step, K3/K4 packs under fused=True),
    then a feed of many frames (the block step) and the flush."""
    jcfg, pn = tiny
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    ts_ = cfg.total_stride
    x = (np.random.default_rng(3).normal(size=(1, cfg.frame_length + 24 * ts_)) * 0.3
         ).astype(np.float32)
    ours_s = ts.Streamer(from_numpy(pn, "cpu"), cfg, "cpu", weights="int8",
                         quant_min_size=MIN, fused=fused)
    assert ours_s.fused_mode == ("fused" if fused is True else "plain")
    assert tq.count_quantized(ours_s.params) >= 10
    ours = np.concatenate([_stream(ours_s, x[:, :cfg.frame_length + 12 * ts_], ts_),
                           _stream(ours_s, x[:, cfg.frame_length + 12 * ts_:], 12 * ts_)],
                          axis=1)
    theirs_s = JaxStreamer(pn, jcfg, weights="int8", quant_min_size=MIN,
                           fused=fused, fused_interpret=fused is True)
    assert theirs_s.fused_mode == ("fused" if fused is True else "xla")
    theirs = np.concatenate([_stream(theirs_s, x[:, :cfg.frame_length + 12 * ts_], ts_),
                             _stream(theirs_s, x[:, cfg.frame_length + 12 * ts_:], 12 * ts_)],
                            axis=1)
    assert ours.shape == theirs.shape
    _close(ours, theirs, BF16_TOL if fused is True else FP32_TOL)


# --- the CUDA kernels (need a card; chip_smoke.py phase 13 runs the same) ---

@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_int8_kernels_match_plain_on_cuda(qparams, B):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    _, cfg, _, qt = qparams
    dev = torch.device("cuda")
    qc = to_device(qt, dev)
    S, D = cfg.stride, cfg.encoder_n_layers
    for i in range(D):
        pk = tsf.pack_encoder_level(qc["encoder"][i], cfg, i, torch.bfloat16)
        T = S ** (D - 1 - i)
        win = torch.from_numpy(_rand(60 + i, B, T, pk[1]["K"] * pk[1]["Cin"])).to(dev)
        _close(tsf.fused_encoder_level(win, *pk).float().cpu(),
               tsf.fused_encoder_level_plain(win, *pk).float().cpu())
    for j in range(D):
        pk = tsf.pack_decoder_level(qc["decoder"][j], cfg, D - 1 - j, torch.bfloat16)
        T, Cx, SC = S ** j, pk[1]["Cx"], S * pk[1]["Cout"]
        x, skip = (torch.from_numpy(_rand(70 + j + k, B, T, Cx)).to(dev) for k in (0, 9))
        prev = torch.from_numpy(_rand(90 + j, B, 1, SC)).to(dev)
        got = tsf.fused_decoder_level(x, skip, prev, *pk, relu=j != D - 1)
        want = tsf.fused_decoder_level_plain(x, skip, prev, *pk, relu=j != D - 1)
        for g_, w_ in zip(got, want):
            _close(g_.float().cpu(), w_.float().cpu())
