"""PyTorch port fused streaming levels (K3/K4) vs the JAX package.

The port's packing and the plain versions of the fused encoder and decoder
levels take the same weights (JAX ``init_params`` -> numpy -> torch) and
the same numpy inputs as the JAX Pallas kernels run in interpret mode on the
CPU, at every level of a small config with the block-1 token counts.  fp32
packs; tolerance rtol=1e-5, atol=1e-5.  The CUDA kernels' own tests need a
card and skip here.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig
from cleanumamba_tpu.models.cleanumamba import init_params
from cleanumamba_tpu.ops.pallas import stream_fused as jsf
from cleanumamba_tpu_torch.ops.cuda import stream_fused as tsf
from cleanumamba_tpu_torch.params import from_numpy, to_device

CFG = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
                        tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
TOL = dict(rtol=1e-5, atol=1e-5)
D, S = CFG.encoder_n_layers, CFG.stride


@pytest.fixture(scope="module")
def params():
    pj = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    pn = jax.tree_util.tree_map(np.asarray, pj)
    return pj, from_numpy(pn, "cpu")


def _rand(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


def _assert_pack_equal(tpk, jpk):
    (ta, tm), (ja, jm) = tpk, jpk
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)
    assert {k: v for k, v in tm.items() if k != "cdt"} == \
        {k: v for k, v in jm.items() if k != "cdt"}


def _check_encoder(pj, pt, cfg, level):
    jpk = jsf.pack_encoder_level(pj["encoder"][level], cfg, level, jnp.float32)
    tpk = tsf.pack_encoder_level(pt["encoder"][level], cfg, level, torch.float32)
    _assert_pack_equal(tpk, jpk)
    T = S ** (D - 1 - level)  # block-1 token count at this level
    Cin = tpk[1]["Cin"]
    x = _rand(level, 2, cfg.kernel_size + S * (T - 1), Cin)
    win_j = jsf.encoder_windows(jnp.asarray(x), cfg.kernel_size, S)
    win_t = tsf.encoder_windows(torch.from_numpy(x), cfg.kernel_size, S)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    got = tsf.fused_encoder_level(win_t, *tpk)  # the port before JAX, as in test_torch_scan
    want = np.asarray(jsf.fused_encoder_level(win_j, *jpk, compute_dtype=jnp.float32,
                                              interpret=True))
    assert got.shape == (2, T, tpk[1]["C2"] // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _check_decoder(pj, pt, cfg, level_j, has_prev):
    enc_i = D - 1 - level_j
    jpk = jsf.pack_decoder_level(pj["decoder"][level_j], cfg, enc_i, jnp.float32)
    tpk = tsf.pack_decoder_level(pt["decoder"][level_j], cfg, enc_i, torch.float32)
    _assert_pack_equal(tpk, jpk)
    T = S ** level_j
    Cx, SC = tpk[0]["mwa"].shape[0], S * tpk[1]["Cout"]
    x, skip = _rand(10 + level_j, 2, T, Cx), _rand(20 + level_j, 2, T, Cx)
    prev = _rand(30 + level_j, 2, 1, SC) if has_prev else None
    relu = level_j != D - 1
    out_t, tail_t = tsf.fused_decoder_level(
        torch.from_numpy(x), torch.from_numpy(skip),
        None if prev is None else torch.from_numpy(prev), *tpk, relu=relu)
    out_j, tail_j = map(np.asarray, jsf.fused_decoder_level(
        jnp.asarray(x), jnp.asarray(skip), None if prev is None else jnp.asarray(prev),
        *jpk, relu=relu, compute_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(tail_t.numpy(), np.asarray(tail_j), **TOL)


@pytest.mark.parametrize("level", range(D))
def test_encoder_level_matches_jax_interpret(params, level):
    _check_encoder(*params, CFG, level)


@pytest.mark.parametrize("level_j", range(D))
@pytest.mark.parametrize("has_prev", [False, True])
def test_decoder_level_matches_jax_interpret(params, level_j, has_prev):
    _check_decoder(*params, CFG, level_j, has_prev)


@pytest.mark.parametrize("act", ["ReLU", "SiLU", "GELU"])
def test_glu_activations_match_jax_interpret(params, act):
    """The other GLU gate activations (the tests above run the default
    Sigmoid), at one encoder and one decoder level."""
    cfg = dataclasses.replace(CFG, glu_activation=act)
    _check_encoder(*params, cfg, 1)
    _check_decoder(*params, cfg, 2, True)


def test_pack_stream_params_packs_every_level(params):
    _, pt = params
    arrays, meta = tsf.pack_stream_params(pt, CFG, torch.bfloat16)
    assert all(m is not None for m in meta["enc"] + meta["dec"])
    assert arrays["enc"][0]["cw"].dtype == torch.bfloat16
    assert arrays["enc"][0]["cb"].dtype == torch.float32  # biases stay fp32
    assert all(a["cwlo"].is_contiguous() for a in arrays["dec"])


def test_pack_static_constraints_and_int8(params):
    _, pt = params
    cfg_bp = dataclasses.replace(CFG, bypass_channels=2)
    assert tsf.pack_encoder_level(pt["encoder"][1], cfg_bp, 1) is None
    assert tsf.pack_decoder_level(pt["decoder"][0], cfg_bp, D - 1) is None
    q = dict(pt["encoder"][0], conv_w={"int8_values": torch.zeros(4, 1, 8, dtype=torch.int8),
                                       "scale": torch.ones(1, 1, 8)})
    with pytest.raises(NotImplementedError, match="quant.py"):
        tsf.pack_encoder_level(q, CFG, 0)


def test_decoder_without_tokens_carries_the_tail(params):
    _, pt = params
    tpk = tsf.pack_decoder_level(pt["decoder"][0], CFG, D - 1, torch.float32)
    Cx, SC = tpk[0]["mwa"].shape[0], S * tpk[1]["Cout"]
    prev = torch.from_numpy(_rand(40, 2, 1, SC))
    out, tail = tsf.fused_decoder_level(torch.zeros(2, 0, Cx), torch.zeros(2, 0, Cx), prev,
                                        *tpk, relu=True)
    assert out.shape == (2, 0, SC)
    torch.testing.assert_close(tail, prev)


def test_wrappers_take_plain_versions_on_cpu(params):
    _, pt = params
    pk = tsf.pack_encoder_level(pt["encoder"][0], CFG, 0, torch.float32)
    win = torch.from_numpy(_rand(50, 1, 8, pk[1]["K"] * pk[1]["Cin"]))
    before = tsf.fused_encoder_level.launches
    torch.testing.assert_close(tsf.fused_encoder_level(win, *pk),
                               tsf.fused_encoder_level_plain(win, *pk), rtol=0, atol=0)
    assert tsf.fused_encoder_level.launches == before


# --- the CUDA kernels (need a card; chip_smoke.py runs the same checks) ---

@pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernels need a GPU")
@pytest.mark.parametrize("act", ["Sigmoid", "ReLU", "SiLU", "GELU"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_cuda(params, cdt, act):
    _, pt = params
    cfg = dataclasses.replace(CFG, glu_activation=act)
    dev = torch.device("cuda")
    pc = to_device(pt, dev)
    tol = 1e-4 if cdt == torch.float32 else 2e-2  # relative to max|ref|

    def f32(pk):
        return {k: v.float() for k, v in pk[0].items()}, {**pk[1], "cdt": torch.float32}

    def close(got, want):
        assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()

    for i in range(D):
        pk = tsf.pack_encoder_level(pc["encoder"][i], cfg, i, cdt)
        T = S ** (D - 1 - i)
        win = torch.from_numpy(_rand(60 + i, 2, T, pk[1]["K"] * pk[1]["Cin"])).to(dev, cdt)
        close(tsf.fused_encoder_level(win, *pk),
              tsf.fused_encoder_level_plain(win.float(), *f32(pk)))
    for j in range(D):
        pk = tsf.pack_decoder_level(pc["decoder"][j], cfg, D - 1 - j, cdt)
        T, Cx, SC = S ** j, pk[0]["mwa"].shape[0], S * pk[1]["Cout"]
        x, skip = (torch.from_numpy(_rand(70 + j + k, 2, T, Cx)).to(dev, cdt) for k in (0, 9))
        prev = torch.from_numpy(_rand(90 + j, 2, 1, SC)).to(dev, cdt)
        out, tail = tsf.fused_decoder_level(x, skip, prev, *pk, relu=j != D - 1)
        r_out, r_tail = tsf.fused_decoder_level_plain(x.float(), skip.float(), prev.float(),
                                                      *f32(pk), relu=j != D - 1)
        close(out, r_out)
        close(tail, r_tail)
