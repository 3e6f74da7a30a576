"""PyTorch port streaming vs the JAX package (and against itself).

Same weights (JAX ``init_params`` or a checkpoint -> numpy -> torch) and the
same numpy audio go through JAX's ``stream_prime``/``stream_step``/
``stream_step_block``/``Streamer`` and the port's, on the CPU, with
``normalize_input`` on and off.  Tolerance: max|Δ| <= 1e-4 * max|y_jax|
for outputs and carried state (fp32).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import streaming as js
from cleanumamba_tpu.config import CleanUMambaConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.models.cleanumamba import forward
from cleanumamba_tpu_torch.ops.cuda.stream_fused import pack_stream_params

SMALL = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
                          tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
CKPTS = ["artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"]
REL = 1e-4

_prime = jax.jit(js.stream_prime, static_argnums=1)
_step = jax.jit(js.stream_step, static_argnums=1)
_block = jax.jit(js.stream_step_block, static_argnums=1)


def _rel(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0.0, 1e-6), (what, err)


def _assert_state(st, sj):
    _rel(st["input_tail"], sj["input_tail"], what="input_tail")
    _rel(st["input_std"], sj["input_std"], what="input_std")
    np.testing.assert_array_equal(st["frames"].numpy(), np.asarray(sj["frames"]))
    for i, (a, b) in enumerate(zip(st["enc"], sj["enc"])):
        _rel(a, b, what=f"enc[{i}]")
    for j, (a, b) in enumerate(zip(st["dec"], sj["dec"])):
        _rel(a, b, what=f"dec[{j}]")  # overlap tails, stored without the convT bias
    for l, (a, b) in enumerate(zip(st["bottleneck"], sj["bottleneck"])):
        _rel(a["conv_state"], b["conv_state"], what=f"conv_state[{l}]")
        _rel(a["ssm_state"], b["ssm_state"], what=f"ssm_state[{l}]")


@pytest.fixture(scope="module")
def small():
    pj = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), SMALL)
    return SMALL, pj, tparams.from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _audio(cfg, B, n_frames, seed=0, scale=0.3):
    L = cfg.frame_length + n_frames * cfg.total_stride
    return (np.random.default_rng(seed).normal(size=(B, L)) * scale).astype(np.float32)


def _normalize_cases(model_id):
    # the checkpoints run with their own setting (normalize_input=True); the
    # small config covers both
    return [True, False] if model_id == "small" else [True]


MODEL_CASES = [(m, n) for m in ["small"] + CKPTS for n in _normalize_cases(m)]


@pytest.fixture(scope="module")
def models(small):
    cache = {"small": small}

    def get(model_id):
        if model_id not in cache:
            ref = jax_load_checkpoint(model_id)
            cfg, pt = tparams.load_checkpoint(model_id, "cpu")
            cache[model_id] = (cfg, ref["params"], pt)
        return cache[model_id]

    return get


@pytest.mark.parametrize("model_id,normalize_input", [("small", True), ("small", False)])
def test_prime_steps_and_block_match_jax(models, model_id, normalize_input):
    cfg, pj, pt = models(model_id)
    cfg = dataclasses.replace(cfg, normalize_input=normalize_input)
    fl, tsd = cfg.frame_length, cfg.total_stride
    a = _audio(cfg, 2, 3 + 5)
    sj, oj = jax.block_until_ready(_prime(pj, cfg, jnp.asarray(a[:, :fl])))
    st, ot = ts.stream_prime(pt, cfg, torch.from_numpy(a[:, :fl]))
    _assert_state(st, sj)
    outs_j, outs_t = [oj], [ot]
    for f in range(3):
        new = a[:, fl + f * tsd: fl + (f + 1) * tsd]
        sj, oj = jax.block_until_ready(_step(pj, cfg, sj, jnp.asarray(new)))
        st, ot = ts.stream_step(pt, cfg, st, torch.from_numpy(new))
        outs_j.append(oj)
        outs_t.append(ot)
    _assert_state(st, sj)
    new = a[:, fl + 3 * tsd:]  # a 5-frame block
    sj, oj = jax.block_until_ready(_block(pj, cfg, sj, jnp.asarray(new)))
    st, ot = ts.stream_step_block(pt, cfg, st, torch.from_numpy(new))
    _assert_state(st, sj)
    # prime, 3 single steps, one block: 1e-4 of the stream's max|y_jax|
    _rel(torch.cat(outs_t + [ot], 1), np.concatenate([np.asarray(o) for o in outs_j + [oj]], 1),
         what="outputs")


@pytest.mark.parametrize("normalize_input", [True, False])
@pytest.mark.parametrize("N", [1, 4, 7])
def test_block_equals_single_steps(small, normalize_input, N):
    """stream_step_block over N frames == N stream_steps, including the
    per-frame std EMA; and the fused-level steps (plain K3/K4 on the CPU)
    == the per-op steps."""
    cfg, _, pt = small
    cfg = dataclasses.replace(cfg, normalize_input=normalize_input)
    fl, tsd = cfg.frame_length, cfg.total_stride
    a = torch.from_numpy(_audio(cfg, 2, 2 * N, seed=N))
    state0, _ = ts.stream_prime(pt, cfg, a[:, :fl])
    st, blocks = state0, []
    for b in range(2):
        st, out = ts.stream_step_block(pt, cfg, st, a[:, fl + b * N * tsd: fl + (b + 1) * N * tsd])
        blocks.append(out)
    packs = pack_stream_params(pt, cfg, torch.float32)
    singles = {}
    for name, pk in (("per-op", None), ("fused", packs)):
        st2, outs = state0, []
        for f in range(2 * N):
            st2, out = ts.stream_step(pt, cfg, st2, a[:, fl + f * tsd: fl + (f + 1) * tsd],
                                      packs=pk)
            outs.append(out)
        singles[name] = torch.cat(outs, 1)
        _assert_state(st2, tparams.to_numpy(st))
    want = singles["per-op"].numpy()
    _rel(torch.cat(blocks, 1), want, 2e-5)
    _rel(singles["fused"], want, 2e-5)


def test_stream_many_equals_step_loop(small):
    cfg, _, pt = small
    fl, tsd = cfg.frame_length, cfg.total_stride
    a = torch.from_numpy(_audio(cfg, 1, 4, seed=7))
    state, _ = ts.stream_prime(pt, cfg, a[:, :fl])
    blocks = torch.stack([a[:, fl + f * tsd: fl + (f + 1) * tsd] for f in range(4)])
    _, many = ts.stream_many(pt, cfg, state, blocks)
    st, outs = state, []
    for blk in blocks:
        st, out = ts.stream_step(pt, cfg, st, blk)
        outs.append(out)
    torch.testing.assert_close(many, torch.cat(outs, 1), rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [SMALL, CleanUMambaConfig()], ids=["small", "E8"])
def test_level_geometry_matches_jax(cfg):
    """Per-level frame-output lengths and new outputs per frame; at the
    deepest level they are equal, so its encoder cache has zero length."""
    lens, strides = ts._level_lengths(cfg), ts._level_strides(cfg)
    assert lens == js._level_lengths(cfg) and strides == js._level_strides(cfg)
    assert lens[-1] == strides[-1] == 1
    if cfg == CleanUMambaConfig():
        assert lens[:2] == [382, 190]


def test_ema_stds_closed_form():
    """The closed form equals N single EMA updates and JAX's _ema_stds; the
    frame counter is per session (B, 1)."""
    rng = np.random.default_rng(8)
    std_now = (rng.random((2, 9, 1)) + 0.5).astype(np.float32)
    std0 = (rng.random((2, 1)) + 0.5).astype(np.float32)
    frames0 = np.array([[1], [40]], np.int32)
    got = ts._ema_stds(torch.from_numpy(std_now), torch.from_numpy(std0),
                       torch.from_numpy(frames0))
    s, n, loop = std0[:, 0].astype(np.float64), frames0[:, 0].astype(np.float64), []
    for t in range(9):
        n = n + 1
        s = std_now[:, t, 0] / n + (1 - 1 / n) * s
        loop.append(s)
    np.testing.assert_allclose(got.numpy(), np.stack(loop, 1), rtol=1e-5, atol=1e-6)
    want = js._ema_stds(jnp.asarray(std_now), jnp.asarray(std0), jnp.asarray(frames0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _feed_all(s, x, sizes):
    outs, pos = [], 0
    for n in sizes:
        outs.append(s.feed(x[:, pos: pos + n]))
        pos += n
    outs.append(s.feed(x[:, pos:]))
    outs.append(s.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("model_id,normalize_input", MODEL_CASES)
def test_streamer_matches_jax(models, model_id, normalize_input):
    """Same chunking through both Streamers: prime, single-frame steps, and
    multi-frame blocks, then flush; outputs and the carried state agree."""
    cfg, pj, pt = models(model_id)
    cfg = dataclasses.replace(cfg, normalize_input=normalize_input)
    tsd = cfg.total_stride
    x = _audio(cfg, 1, 9, seed=9)
    # prime, a single step (over two feeds), two 4-frame blocks, then flush
    # (2 frames); few distinct block sizes keep JAX's compiles few
    sizes = [cfg.frame_length + 3, tsd - 5, 2, 4 * tsd]
    s_t, s_j = ts.Streamer(pt, cfg, "cpu"), js.Streamer(pj, cfg)
    assert s_t.fused_mode == "mega"  # these models pack; on the CPU the plain version runs
    got = _feed_all(s_t, x, sizes)
    want = _feed_all(s_j, x, sizes)
    assert got.shape == want.shape == x.shape
    _rel(torch.from_numpy(got), want)
    _assert_state(s_t.state, s_j.state)


def test_offline_equals_streaming(small):
    """normalize_input=False: streamed == offline forward on the input
    extended with zeros (the tolerance of tests/test_streaming.py)."""
    cfg, _, pt = small
    cfg = dataclasses.replace(cfg, normalize_input=False)
    L = 6000
    x = (np.random.default_rng(10).normal(size=(1, L)) * 0.3).astype(np.float32)
    x_ext = torch.from_numpy(np.pad(x, ((0, 0), (0, 1000))))
    offline = forward(pt, x_ext, cfg)[:, :L].numpy()
    s = ts.Streamer(pt, cfg, "cpu")
    streamed = np.concatenate([s.feed(x[:, i: i + 1000]) for i in range(0, L, 1000)]
                              + [s.flush()], axis=1)
    assert streamed.shape == (1, L)
    np.testing.assert_allclose(streamed, offline, atol=1e-3, rtol=1e-3)


def test_streamer_weight_views(small):
    cfg, _, pt = small
    x = _audio(cfg, 1, 6, seed=11)
    out = _feed_all(ts.Streamer(pt, cfg, "cpu", weights="bf16"), x, [cfg.frame_length])
    assert out.shape == x.shape and np.isfinite(out).all()
    s8 = ts.Streamer(pt, cfg, "cpu", weights="int8", quant_min_size=64)
    out8 = _feed_all(s8, x, [cfg.frame_length])
    assert out8.shape == x.shape and np.isfinite(out8).all()
    assert s8.fused_mode == "plain"  # "auto" keeps int8 on the per-op path, as JAX does


def test_auto_takes_mega_for_any_state_dtype(small):
    """"auto" resolves to the whole-frame path whatever the state dtype, as
    the JAX package's does: a bf16 state is cast to fp32 around K5's launch and
    each new leaf back to bf16.  It tracks the plain bf16 step within 2e-2 of
    max|ref| (bf16 state rounding on both sides, fp32 inside the frame)."""
    cfg, _, pt = small
    x = _audio(cfg, 1, 12, seed=12)
    s = ts.Streamer(pt, cfg, "cpu", dtype=torch.bfloat16)
    assert s.fused_mode == "mega"
    plain = ts.Streamer(pt, cfg, "cpu", dtype=torch.bfloat16, fused=False)
    hops = [cfg.frame_length] + [cfg.total_stride] * 12
    got, want = _feed_all(s, x, hops), _feed_all(plain, x, hops)
    _rel(torch.from_numpy(got), want, rel=2e-2)
    assert all(t.dtype == u.dtype for t, u in zip(tparams.tree_leaves(s.state),
                                                  tparams.tree_leaves(plain.state)))
