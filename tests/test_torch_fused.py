"""PyTorch port fused streaming levels (K3/K4) vs the JAX package.

The port's packing and the plain versions of the fused encoder and decoder
levels take the same weights (JAX ``init_params`` -> numpy -> torch) and
the same numpy inputs as the JAX Pallas kernels run in interpret mode on the
CPU, at every level of a small config with the block-1 token counts and at
the ragged widths of the pruned checkpoint.  fp32 packs; tolerance rtol=1e-5,
atol=1e-5.  The port's pack is tiled for its kernels: the tests read it back
(``unpack_level``) against the matrices it was built from, and hold the
planner's split of each product to the kernels' limits.  The CUDA kernels' own
tests need a card and skip here.
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
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch.ops.cuda import stream_fused as tsf
from cleanumamba_tpu_torch.params import from_numpy, load_checkpoint, to_device

CFG = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
                        tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
TOL = dict(rtol=1e-5, atol=1e-5)
D, S = CFG.encoder_n_layers, CFG.stride
PRUNED = "artifacts/pruned_473k_finetuned.pkl"  # channel counts that are no multiple of 8


@pytest.fixture(scope="module")
def params():
    pj = jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)
    pn = jax.tree_util.tree_map(np.asarray, pj)
    return pj, from_numpy(pn, "cpu")


def _rand(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


def _assert_pack_equal(tpk, jpk):
    """The port's tiled pack holds the JAX pack's logical matrices and dims."""
    (ta, tm), (ja, jm) = tpk, jpk
    logical = tsf.unpack_level(ta, tm)
    assert set(logical) == set(ja)
    for k in ja:
        np.testing.assert_array_equal(logical[k].numpy(), np.asarray(ja[k]), err_msg=k)
    assert {k: tm[k] for k in jm if k != "cdt"} == {k: v for k, v in jm.items() if k != "cdt"}


def _check_encoder(pj, pt, cfg, level, T=None):
    jpk = jsf.pack_encoder_level(pj["encoder"][level], cfg, level, jnp.float32)
    tpk = tsf.pack_encoder_level(pt["encoder"][level], cfg, level, torch.float32)
    _assert_pack_equal(tpk, jpk)
    if T is None:
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


def _check_decoder(pj, pt, cfg, level_j, has_prev, T=None):
    depth = cfg.encoder_n_layers
    enc_i = depth - 1 - level_j
    jpk = jsf.pack_decoder_level(pj["decoder"][level_j], cfg, enc_i, jnp.float32)
    tpk = tsf.pack_decoder_level(pt["decoder"][level_j], cfg, enc_i, torch.float32)
    _assert_pack_equal(tpk, jpk)
    if T is None:
        T = S ** level_j
    Cx, SC = tpk[1]["Cx"], S * tpk[1]["Cout"]
    x, skip = _rand(10 + level_j, 2, T, Cx), _rand(20 + level_j, 2, T, Cx)
    prev = _rand(30 + level_j, 2, 1, SC) if has_prev else None
    relu = level_j != depth - 1
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
    assert all(a["ctw"].is_contiguous() for a in arrays["dec"])


def test_pack_static_constraints_and_int8(params):
    _, pt = params
    cfg_bp = dataclasses.replace(CFG, bypass_channels=2)
    assert tsf.pack_encoder_level(pt["encoder"][1], cfg_bp, 1) is None
    assert tsf.pack_decoder_level(pt["decoder"][0], cfg_bp, D - 1) is None
    q = dict(pt["encoder"][0], conv_w={"int8_values": torch.zeros(4, 1, 8, dtype=torch.int8),
                                       "scale": torch.ones(1, 1, 8)})
    arrays, _ = tsf.pack_encoder_level(q, CFG, 0)  # int8 packs, with its scales beside it
    assert arrays["cw"].dtype == torch.int8 and arrays["cw_scale"].dtype == torch.float32
    assert arrays["mw"].dtype == torch.bfloat16 and "mw_scale" not in arrays  # dense mix
    with pytest.raises(TypeError, match="bfloat16"):  # an int8 pack computes in bf16
        tsf.pack_encoder_level(q, CFG, 0, torch.float32)


def test_decoder_without_tokens_carries_the_tail(params):
    _, pt = params
    tpk = tsf.pack_decoder_level(pt["decoder"][0], CFG, D - 1, torch.float32)
    Cx, SC = tpk[1]["Cx"], S * tpk[1]["Cout"]
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


# --- the tiled pack, its scratch and the planner ----------------------------

@pytest.fixture(scope="module")
def pruned():
    """(JAX config, JAX params, torch params) of the pruned checkpoint."""
    cfg_t, pt = load_checkpoint(PRUNED, "cpu")
    return (CleanUMambaConfig(**dataclasses.asdict(cfg_t)), jax_load_checkpoint(PRUNED)["params"],
            pt)


def _models(params, pruned):
    return {"small": (CFG, params[1]), "pruned": (pruned[0], pruned[2])}


def _logical_matrices(cfg, pt, kind, idx):
    """The (K, N) matrices a level pack is built from, straight from the params."""
    if kind == "enc":
        ep = pt["encoder"][idx]
        Kw, Cin, C = ep["conv_w"].shape
        mw = ep["mix_w"].reshape(-1, ep["mix_w"].shape[-1])
        half = mw.shape[1] // 2
        return {"cw": ep["conv_w"].reshape(Kw * Cin, C), "mwa": mw[:, :half], "mwb": mw[:, half:]}
    dp = pt["decoder"][idx]
    Kw, C, Cout = dp["convt_w"].shape
    mw = dp["mix_w"].reshape(-1, dp["mix_w"].shape[-1])
    half = mw.shape[1] // 2
    full = dp["convt_w"].permute(1, 0, 2).reshape(C, Kw * Cout)
    sc = cfg.stride * Cout
    return {"mwa": mw[:, :half], "mwb": mw[:, half:], "cwlo": full[:, :sc], "cwhi": full[:, sc:]}


def _level_packs(cfg, pt, cdt):
    depth = cfg.encoder_n_layers
    for i in range(depth):
        yield "enc", i, tsf.pack_encoder_level(pt["encoder"][i], cfg, i, cdt)
    for j in range(depth):
        yield "dec", j, tsf.pack_decoder_level(pt["decoder"][j], cfg, depth - 1 - j, cdt)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("model", ["small", "pruned"])
def test_tiled_pack_returns_its_logical_matrices(params, pruned, model, cdt):
    """``unpack_level`` gives back, bit for bit, the matrices the pack was
    built from (cast to the compute dtype); the columns that pad a tile to
    ``TILE`` are zero; every tiled weight starts each (tile, row) on 16 bytes."""
    cfg, pt = _models(params, pruned)[model]
    ragged = False
    for kind, idx, (arrays, meta) in _level_packs(cfg, pt, cdt):
        logical = tsf.unpack_level(arrays, meta)
        for name, want in _logical_matrices(cfg, pt, kind, idx).items():
            assert logical[name].dtype == cdt
            assert torch.equal(logical[name], want.to(cdt)), (kind, idx, name)
        for name in ("cw", "mw", "ctw"):
            if name not in arrays:
                continue
            t = arrays[name]
            nt, K, NW, tile = t.shape
            N = logical["cw" if name == "cw" else "mwa" if name == "mw" else "cwlo"].shape[1]
            assert tile == tsf.TILE and nt == -(-N // tsf.TILE) and t.is_contiguous()
            assert NW == (1 if name == "cw" else 2)
            flat = t.permute(1, 2, 0, 3).reshape(K, NW, nt * tile)
            assert not flat[:, :, N:].any(), (kind, idx, name)
            assert (NW * tile * t.element_size()) % 16 == 0
            ragged |= N % 8 != 0
    assert ragged  # both models have widths that end inside a tile


@pytest.mark.parametrize("model", ["small", "pruned"])
def test_scratch_covers_batch_8(params, pruned, model):
    """The scratch allocated at pack time holds the first product of every
    call of up to 8 streams at the level's block-1 token count, and every such
    call has a plan (both products, five ints each)."""
    cfg, pt = _models(params, pruned)[model]
    for kind, idx, (arrays, meta) in _level_packs(cfg, pt, torch.bfloat16):
        depth = cfg.encoder_n_layers
        assert meta["T"] == cfg.stride ** (idx if kind == "dec" else depth - 1 - idx)
        assert arrays["scratch"].dtype == torch.bfloat16
        k, dims = tsf._level_dims(meta)
        assert k == kind
        for B in range(1, 9):
            plan, scratch = tsf._level_plan(kind, B, meta["T"], dims, (2, 2))
            assert scratch == B * meta["T"] * dims[1] <= arrays["scratch"].numel()
            first, second = tsf._products(kind, B, meta["T"], dims)
            assert tuple(plan) == tsf._plan(*first, 2) + tsf._plan(*second, 2)


# E8 at full width (levels 0, 3 and 7 at batch 1 and 8) and ragged shapes
@pytest.mark.parametrize("rows,K,N,NW,NI,esize", [
    (128, 4, 64, 1, 1, 2), (128, 64, 64, 2, 1, 2), (16, 1024, 512, 1, 1, 2),
    (1, 3072, 768, 1, 1, 2), (1, 3072, 768, 1, 1, 4), (1, 768, 768, 2, 1, 4),
    (8, 3072, 768, 1, 1, 4), (64, 2048, 768, 1, 1, 2), (2, 768, 1536, 2, 2, 2),
    (9, 768, 1536, 2, 2, 4), (1032, 64, 2, 2, 2, 4), (4096, 4, 64, 1, 1, 4), (3, 69, 67, 2, 2, 2),
    (17, 148, 36, 2, 1, 2), (1, 264, 64, 1, 1, 2), (1, 1, 1, 1, 1, 4),
])
def test_plan_keeps_the_kernel_limits(rows, K, N, NW, NI, esize):
    """Every product's split stays inside what ``csrc/stream_fused.cu`` takes:
    1, 2, 4 or 8 ranges (a cluster) that cover the contraction in multiples
    of 8, a slab and its buffers inside the shared-memory limit, row groups
    that cover the rows with none empty, a row tile of 2, 4 or 8."""
    splits, groups, kblk, rpb, R = tsf._plan(rows, K, N, NW, NI, esize)
    assert splits in (1, 2, 4, 8) and kblk % 8 == 0 and splits * kblk >= K
    assert kblk * tsf.TILE * NW * esize <= tsf._SLAB_MAX
    assert (128 + kblk * tsf.TILE * NW * esize
            + (NI * R * kblk + (8 * R + rpb) * NW * tsf.TILE) * 4) <= tsf._SMEM_LIMIT
    assert R in (2, 4, 8) and rpb % R == 0 and rpb <= 32
    assert groups * rpb >= rows and (groups - 1) * rpb < rows
    if K * tsf.TILE * NW * esize <= tsf._SLAB_WHOLE:
        assert splits == 1  # a small contraction is not split


def test_too_wide_a_level_does_not_pack(params):
    """A tile whose weights exceed a cluster's shared memory has no plan, and
    the level then stays on the per-op path (its pack is None)."""
    assert tsf._plan(1, 7000, 64, 1, 1, 4) is None
    assert tsf._level_plan("enc", 1, 1, (7000, 64, 64), (4, 4)) is None
    _, pt = params
    wide = dict(pt["encoder"][D - 1], conv_w=torch.zeros(4, 1750, 16))
    assert tsf.pack_encoder_level(wide, CFG, D - 1, torch.float32) is None


@pytest.mark.parametrize("level", [0, 3, 7])
def test_ragged_encoder_level_matches_jax_interpret(pruned, level):
    """Pruned widths (no multiple of 8, so every tile is padded), 3 tokens."""
    cfg, pj, pt = pruned
    _check_encoder(pj, pt, cfg, level, T=3)


@pytest.mark.parametrize("level_j", [0, 4, 7])
def test_ragged_decoder_level_matches_jax_interpret(pruned, level_j):
    cfg, pj, pt = pruned
    _check_decoder(pj, pt, cfg, level_j, True, T=3)


# --- the CUDA kernels (need a card; chip_smoke.py runs the same checks) ---

@pytest.mark.cuda
@pytest.mark.parametrize("act", ["Sigmoid", "ReLU", "SiLU", "GELU"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_cuda(params, cdt, act):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
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
        T, Cx, SC = S ** j, pk[1]["Cx"], S * pk[1]["Cout"]
        x, skip = (torch.from_numpy(_rand(70 + j + k, 2, T, Cx)).to(dev, cdt) for k in (0, 9))
        prev = torch.from_numpy(_rand(90 + j, 2, 1, SC)).to(dev, cdt)
        out, tail = tsf.fused_decoder_level(x, skip, prev, *pk, relu=j != D - 1)
        r_out, r_tail = tsf.fused_decoder_level_plain(x.float(), skip.float(), prev.float(),
                                                      *f32(pk), relu=j != D - 1)
        close(out, r_out)
        close(tail, r_tail)


def _cuda_level_cases(pt, cfg, cdt, B, dev):
    """(encoder calls, decoder calls) of the two deepest levels at batch B."""
    pc = to_device(pt, dev)
    enc, dec = [], []
    for i in (D - 2, D - 1):
        pk = tsf.pack_encoder_level(pc["encoder"][i], cfg, i, cdt)
        T = S ** (D - 1 - i)
        enc.append((torch.from_numpy(_rand(100 + i, B, T, pk[1]["K"] * pk[1]["Cin"])).to(dev, cdt),
                    pk))
    for j in (0, 1):
        pk = tsf.pack_decoder_level(pc["decoder"][j], cfg, D - 1 - j, cdt)
        T, Cx, SC = S ** j, pk[1]["Cx"], S * pk[1]["Cout"]
        x, skip = (torch.from_numpy(_rand(110 + j + k, B, T, Cx)).to(dev, cdt) for k in (0, 9))
        prev = torch.from_numpy(_rand(130 + j, B, 1, SC)).to(dev, cdt)
        dec.append((x, skip, prev, pk))
    return enc, dec


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernels_match_plain_at_batch_on_cuda(params, cdt, B):
    """K3/K4 at batch 2 and 8 on the deepest levels (several rows per block,
    an odd count of decoder rows), fp32 1e-4 / bf16 2e-2 of max|ref|."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    tol = 1e-4 if cdt == torch.float32 else 2e-2

    def f32(pk):
        return {k: v.float() for k, v in pk[0].items()}, {**pk[1], "cdt": torch.float32}

    def close(got, want):
        assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()

    enc, dec = _cuda_level_cases(params[1], CFG, cdt, B, torch.device("cuda"))
    for win, pk in enc:
        close(tsf.fused_encoder_level(win, *pk),
              tsf.fused_encoder_level_plain(win.float(), *f32(pk)))
    for x, skip, prev, pk in dec:
        got = tsf.fused_decoder_level(x, skip, prev, *pk, relu=True)
        want = tsf.fused_decoder_level_plain(x.float(), skip.float(), prev.float(), *f32(pk),
                                             relu=True)
        for g_, w_ in zip(got, want):
            close(g_, w_)


@pytest.mark.cuda
def test_repeated_calls_are_bitwise_equal_on_cuda(params):
    """The split contraction sums in one fixed order: the same inputs give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    enc, dec = _cuda_level_cases(params[1], CFG, torch.bfloat16, 8, torch.device("cuda"))
    win, pk = enc[0]
    first = tsf.fused_encoder_level(win, *pk).clone()
    x, skip, prev, dpk = dec[1]
    first_dec = [t.clone() for t in tsf.fused_decoder_level(x, skip, prev, *dpk, relu=True)]
    for _ in range(5):
        assert torch.equal(tsf.fused_encoder_level(win, *pk), first)
        again = tsf.fused_decoder_level(x, skip, prev, *dpk, relu=True)
        assert all(torch.equal(a, b) for a, b in zip(again, first_dec))
