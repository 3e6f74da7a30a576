"""The whole-frame streaming step (K5) of the PyTorch port vs the JAX package.

On the CPU ``mega_stream_step`` runs its plain version
(``mega_stream_step_ref``) on the port's own pack; it is held against JAX's
``stream_step`` and the port's own ``stream_step``: outputs and every state
leaf, atol 2e-5, rtol 1e-4 in fp32 (the tolerance of
tests/test_stream_mega.py, which holds JAX's own whole-frame kernel to its
``stream_step``).  The kernel itself is held against the plain version on a
GPU (the case marked ``cuda``).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import streaming as js
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.ops.cuda import stream_mega as sm

FAMILIES = ["mamba", "mamba2", "lstm", "mamba_s4", "mha"]
# the mega-compatible small geometry of tests/test_stream_mega.py
SMALL = dict(channels_H=16, max_H=48, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
             tsfm_d_model=32, tsfm_d_inner=64)
FULLMINI = dict(channels_H=32, max_H=64, encoder_n_layers=8, tsfm_n_layers=3, tsfm_n_head=8,
                tsfm_d_model=64, tsfm_d_inner=128)  # the released small geometry
BIG_LANE = dict(channels_H=64, max_H=768, encoder_n_layers=2, tsfm_n_head=8, tsfm_d_model=512,
                tsfm_d_inner=2048)
CKPTS = ["artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"]
TOL = dict(atol=2e-5, rtol=1e-4)


def _audio(cfg, B, n_frames, seed):
    L = cfg.frame_length + n_frames * cfg.total_stride
    return (np.random.default_rng(seed).normal(size=(B, L)) * 0.3).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def _assert_states(got, want, **tol):
    lg, lw = _leaves(tparams.to_numpy(got)), _leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol)


def _as_jax(state):
    """A port state in the JAX package's layout: an mha model's rings
    (batch, layers, W, d) as (layers, batch, W, d) and its rows' positions,
    equal here, as JAX's one position; other states as they are."""
    bc = state["bottleneck"]
    if not isinstance(bc, dict) or "pos" not in bc:
        return state
    assert bool((bc["pos"] == bc["pos"][0]).all())
    return dict(state, bottleneck={"k": bc["k"].transpose(0, 1), "v": bc["v"].transpose(0, 1),
                                   "pos": bc["pos"][0]})


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(family):
        if family not in cache:
            jcfg = JaxConfig(bottleneck=family, **SMALL)
            pj = jax_init_params(jax.random.PRNGKey(3), jcfg)
            cache[family] = (jcfg, pj,
                             tparams.from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu"))
        return cache[family]

    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_pack_small_and_fullmini(models, family):
    jcfg, _, pt = models(family)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    arrays, meta = sm.pack_mega(pt, cfg, torch.float32)
    assert arrays["w"].dtype == torch.float32 and arrays["table"].dtype == torch.int32
    assert meta["kind"] == family and len(meta["enc"]) == len(meta["dec"]) == 4
    full = CleanUMambaConfig(bottleneck=family, **FULLMINI)
    pfull = tm.init_params(full, torch.Generator().manual_seed(0), "cpu")
    for cdt in (torch.float32, torch.bfloat16):
        packed = sm.pack_mega(pfull, full, cdt)
        assert packed is not None and packed[0]["w"].dtype == cdt
        assert packed[1]["smem_bytes"] <= 200 * 1024
        assert sum(t.numel() * t.element_size() for t in packed[0].values()) < 8 * 2 ** 20


@pytest.mark.parametrize("ckpt", CKPTS)
def test_pack_artifacts(ckpt):
    """Ragged pruned checkpoints (per-layer widths, matrices wider than 128) pack."""
    cfg, pt = tparams.load_checkpoint(ckpt, "cpu")
    packed = sm.pack_mega(pt, cfg, torch.float32)
    assert packed is not None and packed[1]["kind"] == "mamba"
    widths = {bm["d_inner"] for bm in packed[1]["bott"]} | {e["C"] for e in packed[1]["enc"]}
    assert len(widths) > 2  # ragged


def test_pack_refuses():
    big = CleanUMambaConfig(**BIG_LANE)
    assert sm.pack_mega(tm.init_params(big, torch.Generator().manual_seed(1), "cpu"), big,
                        torch.bfloat16) is None
    small = CleanUMambaConfig(**SMALL)
    ps = tm.init_params(small, torch.Generator().manual_seed(1), "cpu")
    assert sm.pack_mega(ps, dataclasses.replace(small, kernel_size=8), torch.float32) is None
    e8 = CleanUMambaConfig()  # E8-full, 41 M parameters: stays on the per-level kernels
    pe8 = tm.init_params(e8, torch.Generator().manual_seed(1), "cpu")
    assert sm.pack_mega(pe8, e8, torch.bfloat16) is None
    with pytest.raises(ValueError, match="pack_mega"):
        ts.Streamer(pe8, e8, "cpu", fused="mega")
    assert ts.Streamer(pe8, e8, "cpu").fused_mode == "plain"
    assert ts.Streamer(pe8, e8, "cpu", fused=True).fused_mode == "fused"


@pytest.mark.parametrize("normalize_input", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_mega_step_matches_jax_and_plain(models, family, normalize_input):
    """6 steps: the port's stream_step_mega == JAX stream_step == the port's
    stream_step, outputs and state."""
    jcfg, pj, pt = models(family)
    jcfg = dataclasses.replace(jcfg, normalize_input=normalize_input)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    mega = sm.pack_mega(pt, cfg, torch.float32)
    assert mega is not None
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = _audio(cfg, 2 if normalize_input else 1, 6, seed=31)  # batch 2 and batch 1
    st, _ = ts.stream_prime(pt, cfg, torch.from_numpy(x[:, :fl]))
    sj, _ = js.stream_prime(pj, jcfg, jnp.asarray(x[:, :fl]))
    s_mega, s_plain, sj_plain = st, st, sj
    for t in range(6):
        new = x[:, fl + t * tsd: fl + (t + 1) * tsd]
        s_mega, y_mega = ts.stream_step_mega(cfg, s_mega, torch.from_numpy(new), mega)
        s_plain, y_plain = ts.stream_step(pt, cfg, s_plain, torch.from_numpy(new))
        sj_plain, yj_plain = js.stream_step(pj, jcfg, sj_plain, jnp.asarray(new))
        for want in (yj_plain, y_plain):
            np.testing.assert_allclose(y_mega.numpy(), np.asarray(want), **TOL)
    _assert_states(_as_jax(s_mega), sj_plain, **TOL)
    _assert_states(s_mega, tparams.to_numpy(s_plain), **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_pack_tracks_fp32(models, family):
    """bf16 packs track the fp32 step within 0.05 of max|ref| (tests/test_stream_mega.py)."""
    jcfg, _, pt = models(family)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    mega = sm.pack_mega(tparams.prepare_weight_view(pt, "bf16")[0], cfg, torch.bfloat16)
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy(_audio(cfg, 1, 3, seed=32))
    s_ref, _ = ts.stream_prime(pt, cfg, x[:, :fl])
    s_mega = s_ref
    for t in range(3):
        new = x[:, fl + t * tsd: fl + (t + 1) * tsd]
        s_ref, y_ref = ts.stream_step(pt, cfg, s_ref, new)
        s_mega, y_mega = ts.stream_step_mega(cfg, s_mega, new, mega)
    assert torch.isfinite(y_mega).all()
    assert float((y_mega - y_ref).abs().max()) / (float(y_ref.abs().max()) + 1e-9) < 0.05


@pytest.mark.parametrize("family", ["mamba", "mha", "mamba_s4"])
def test_mega_and_plain_steps_interleave(models, family):
    """One state through alternating mega and plain steps == plain steps only."""
    jcfg, _, pt = models(family)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    mega = sm.pack_mega(pt, cfg, torch.float32)
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy(_audio(cfg, 2, 4, seed=33))
    s_mix, _ = ts.stream_prime(pt, cfg, x[:, :fl])
    s_ref = s_mix
    for t in range(4):
        new = x[:, fl + t * tsd: fl + (t + 1) * tsd]
        s_ref, y_ref = ts.stream_step(pt, cfg, s_ref, new)
        if t % 2 == 0:
            s_mix, y = ts.stream_step_mega(cfg, s_mix, new, mega)
        else:
            s_mix, y = ts.stream_step(pt, cfg, s_mix, new)
        torch.testing.assert_close(y, y_ref, **TOL)
    _assert_states(s_mix, tparams.to_numpy(s_ref), **TOL)


def test_step_is_repeatable(models):
    """The new state lies in new tensors: the same step twice gives the same result."""
    jcfg, _, pt = models("mamba")
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    mega = sm.pack_mega(pt, cfg, torch.float32)
    x = torch.from_numpy(_audio(cfg, 1, 1, seed=34))
    s0, _ = ts.stream_prime(pt, cfg, x[:, :cfg.frame_length])
    before = [t.clone() for t in tparams.tree_leaves(s0)]
    a = ts.stream_step_mega(cfg, s0, x[:, cfg.frame_length:], mega)
    b = ts.stream_step_mega(cfg, s0, x[:, cfg.frame_length:], mega)
    torch.testing.assert_close(a[1], b[1], atol=0, rtol=0)
    for t0, t1 in zip(before, tparams.tree_leaves(s0)):
        torch.testing.assert_close(t0, t1, atol=0, rtol=0)


def _streamed_vs_offline(pt, cfg, L, seed):
    x = (np.random.default_rng(seed).normal(size=(1, L)) * 0.3).astype(np.float32)
    offline = tm.forward(pt, torch.from_numpy(x), cfg).numpy()
    s = ts.Streamer(pt, cfg, "cpu", fused="mega")
    assert s.fused_mode == "mega"
    tsd = cfg.total_stride
    outs = [s.feed(x[:, i: i + tsd]) for i in range(0, L, tsd)] + [s.flush()]
    streamed = np.concatenate(outs, axis=1)
    assert streamed.shape == (1, L)
    n = L - cfg.frame_length  # the flush boundary differs
    np.testing.assert_allclose(streamed[:, :n], offline[:, :n], atol=1e-3, rtol=1e-3)


def test_streamer_mega_equals_offline_small(models):
    jcfg, _, pt = models("mamba")
    cfg = CleanUMambaConfig(**{**dataclasses.asdict(jcfg), "normalize_input": False})
    _streamed_vs_offline(pt, cfg, 2048, seed=35)


def test_streamer_mega_equals_offline_pruned_checkpoint():
    cfg, pt = tparams.load_checkpoint(CKPTS[0], "cpu")
    _streamed_vs_offline(pt, dataclasses.replace(cfg, normalize_input=False), 4096, seed=36)


def test_fused_policy(models):
    """"auto": mega where the model packs (by model, on any device), else the
    per-level packs on a GPU, else plain; True/False/"mega" as asked."""
    jcfg, _, pt = models("lstm")
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    assert ts.Streamer(pt, cfg, "cpu").fused_mode == "mega"
    assert ts.Streamer(pt, cfg, "cpu", weights="bf16").mega[1]["cdt"] == torch.bfloat16
    assert ts.Streamer(pt, cfg, "cpu", fused=False).fused_mode == "plain"
    assert ts.Streamer(pt, cfg, "cpu", fused=True).fused_mode == "fused"
    assert ts.Streamer(pt, cfg, "cpu", fused="mega").fused_mode == "mega"
    # bf16 state: "auto" takes the whole frame too, as the JAX package does
    # (stream_step_mega casts the state to fp32 around the launch)
    assert ts.Streamer(pt, cfg, "cpu", dtype=torch.bfloat16).fused_mode == "mega"
    with pytest.raises(ValueError, match="fused"):
        ts.Streamer(pt, cfg, "cpu", fused="level")
    big = CleanUMambaConfig(**BIG_LANE)
    pbig = tm.init_params(big, torch.Generator().manual_seed(1), "cpu")
    assert ts.Streamer(pbig, big, "cpu").fused_mode == "plain"
    with pytest.raises(ValueError, match="pack_mega"):
        ts.Streamer(pbig, big, "cpu", fused="mega")


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_matches_plain_on_cuda(family, cdt):
    """K5 against its plain version on the card: 4 carried frames at batch 2,
    outputs and every state leaf (fp32 1e-4, bf16 2e-2 of max|ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    dev = torch.device("cuda:0")
    cfg = CleanUMambaConfig(bottleneck=family, **SMALL)
    pt = tm.init_params(cfg, torch.Generator().manual_seed(2), dev)
    mega = sm.pack_mega(pt, cfg, cdt)
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy(_audio(cfg, 2, 4, seed=37)).to(dev)
    s_k, _ = ts.stream_prime(pt, cfg, x[:, :fl])
    s_r = s_k
    tol = 1e-4 if cdt == torch.float32 else 2e-2
    for t in range(4):
        frame = torch.cat([s_r["input_tail"], x[:, fl + t * tsd: fl + (t + 1) * tsd]], 1)
        cont = lambda s: tparams.tree_map(lambda a: a.contiguous(), s)  # noqa: E731
        upd_k, y_k = sm.mega_stream_step(frame, cont(s_k), *mega)
        upd_r, y_r = sm.mega_stream_step_ref(frame, cont(s_r), *mega)
        for a, b in zip([y_k] + tparams.tree_leaves(upd_k), [y_r] + tparams.tree_leaves(upd_r)):
            if b.numel():
                assert float((a.float() - b.float()).abs().max()) <= tol * max(
                    float(b.float().abs().max()), 1e-30)
        tail = frame[:, tsd:]
        s_k, s_r = {**s_k, **upd_k, "input_tail": tail}, {**s_r, **upd_r, "input_tail": tail}
