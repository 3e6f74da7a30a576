"""PyTorch port ``SessionMultiplexer`` (``serve.py``) against itself and the
JAX package.

Mirrors ``tests/test_serve.py``: a session multiplexed beside other traffic
(staggered joins, uneven feeds, an empty slot, slot churn, block-4 ticks)
gives the audio it gives streamed alone at batch 1 (1e-5), ``flush`` trims to
the fed length and a full pool refuses a session.  Beyond it: a paused
session's state rows are bitwise unchanged across ticks of others, and the
step writes nothing into its input state; the port's multiplexer equals the
JAX package's on the same weights and traffic in fp32 and int8 (1e-4 of
max|ref|: the two frameworks' CPU sums).  The long-audio cases are marked
slow as the JAX package's are; a fast case of each runs in the tier.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.serve import SessionMultiplexer as JaxMultiplexer
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.params import from_numpy, tree_leaves
from cleanumamba_tpu_torch.serve import SessionMultiplexer

TINY = dict(channels_H=8, max_H=16, tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32,
            normalize_input=True)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def model():
    """(port config, port params, JAX config, numpy params): one set of weights."""
    jcfg = JaxConfig(bottleneck="mamba", **TINY)
    pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    return CleanUMambaConfig(**dataclasses.asdict(jcfg)), from_numpy(pn, "cpu"), jcfg, pn


def _solo(params, cfg, audio):
    """Oracle: the session streamed alone at batch 1, whole ticks only."""
    fl, tsr = cfg.frame_length, cfg.total_stride
    state, out = ts.stream_prime(params, cfg, torch.from_numpy(audio[None, :fl]))
    outs = [out[0].numpy()]
    pos = fl
    while pos + tsr <= audio.shape[0]:
        state, out = ts.stream_step(params, cfg, state,
                                    torch.from_numpy(audio[None, pos:pos + tsr]))
        outs.append(out[0].numpy())
        pos += tsr
    return np.concatenate(outs)


def _audio(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 0.2).astype(np.float32)


def _staggered(mux, cfg, ticks):
    """Three sessions joining at different ticks, fed in uneven chunks; a
    fourth slot stays empty.  Returns ({i: audio}, {i: output})."""
    fl, tsr = cfg.frame_length, cfg.total_stride
    lengths = [fl + ticks[0] * tsr, fl + ticks[1] * tsr, fl + ticks[2] * tsr]
    audios = [_audio(i, n) for i, n in enumerate(lengths)]
    got = {i: [] for i in range(3)}
    sids = {0: mux.open()}
    got[0].append(mux.feed(sids[0], audios[0][: fl + 5 * tsr]))
    sids[1] = mux.open()
    got[1].append(mux.feed(sids[1], audios[1][: fl + tsr]))
    sids[2] = mux.open()
    pos = [fl + 5 * tsr, fl + tsr, 0]
    chunk = [3 * tsr, 2 * tsr, 5 * tsr]
    while any(pos[i] < lengths[i] for i in range(3)):
        for i in range(3):
            if pos[i] < lengths[i]:
                nxt = min(pos[i] + chunk[i], lengths[i])
                got[i].append(mux.feed(sids[i], audios[i][pos[i]:nxt]))
                pos[i] = nxt
    return audios, {i: np.concatenate(got[i] + [mux._drain(sids[i])]) for i in range(3)}


def _check_staggered(model, ticks):
    cfg, params, _, _ = model
    mux = SessionMultiplexer(params, cfg, slots=4, device="cpu")
    audios, outs = _staggered(mux, cfg, ticks)
    for i in range(3):
        ref = _solo(params, cfg, audios[i])
        assert outs[i].shape == ref.shape, (i, outs[i].shape, ref.shape)
        np.testing.assert_allclose(outs[i], ref, **TOL)


@pytest.mark.slow
def test_staggered_sessions_match_solo(model):
    _check_staggered(model, (23, 17, 11))


def test_staggered_sessions_match_solo_short(model):
    _check_staggered(model, (9, 7, 5))


def _check_churn(model, n_live, n_new):
    """Close a session mid-run and admit a new one into its slot while
    another keeps streaming: both match their solo streams."""
    cfg, params, _, _ = model
    fl, tsr = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(params, cfg, slots=2, device="cpu")
    a_live, a_dead, a_new = _audio(10, fl + n_live * tsr), _audio(11, fl + 4 * tsr), \
        _audio(12, fl + n_new * tsr)
    live, dead = mux.open(), mux.open()
    out_live = [mux.feed(live, a_live[: fl + 2 * tsr])]
    mux.feed(dead, a_dead[: fl + 2 * tsr])
    mux.close(dead)
    newcomer = mux.open()
    assert newcomer == dead  # the same slot, reused
    out_new = [mux.feed(newcomer, a_new[: fl + tsr])]
    pos_l, pos_n = fl + 2 * tsr, fl + tsr
    while pos_l < a_live.shape[0] or pos_n < a_new.shape[0]:
        if pos_l < a_live.shape[0]:
            nxt = min(pos_l + 2 * tsr, a_live.shape[0])
            out_live.append(mux.feed(live, a_live[pos_l:nxt]))
            pos_l = nxt
        if pos_n < a_new.shape[0]:
            nxt = min(pos_n + 2 * tsr, a_new.shape[0])
            out_new.append(mux.feed(newcomer, a_new[pos_n:nxt]))
            pos_n = nxt
    out_live.append(mux._drain(live))
    out_new.append(mux._drain(newcomer))
    np.testing.assert_allclose(np.concatenate(out_live), _solo(params, cfg, a_live), **TOL)
    np.testing.assert_allclose(np.concatenate(out_new), _solo(params, cfg, a_new), **TOL)


@pytest.mark.slow
def test_slot_churn_reuses_slots_exactly(model):
    _check_churn(model, 20, 8)


def test_slot_churn_reuses_slots_exactly_short(model):
    _check_churn(model, 8, 4)


def test_block_ticks_match_solo(model):
    """block=4 ticks (stream_step_block) match the per-frame solo stream on
    the tick-aligned prefix."""
    cfg, params, _, _ = model
    fl, tsr = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(params, cfg, slots=2, block=4, device="cpu")
    audio = _audio(20, fl + 16 * tsr)
    sid = mux.open()
    ours = np.concatenate([mux.feed(sid, audio), mux._drain(sid)])
    assert ours.shape[0] == tsr + 16 * tsr  # prime + 4 block-4 ticks
    np.testing.assert_allclose(ours, _solo(params, cfg, audio)[: ours.shape[0]], **TOL)


def test_flush_trims_to_fed_length(model):
    cfg, params, _, _ = model
    fl, tsr = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(params, cfg, slots=2, device="cpu")
    n = fl + 3 * tsr + 7  # ragged tail
    sid = mux.open()
    out = [mux.feed(sid, _audio(30, n)), mux.flush(sid)]
    assert sum(o.shape[0] for o in out) == n
    mux.close(sid)
    assert not mux._open[sid]
    with pytest.raises(ValueError, match="not open"):
        mux.feed(sid, _audio(31, 10))


def test_open_overflow_raises(model):
    cfg, params, _, _ = model
    mux = SessionMultiplexer(params, cfg, slots=2, device="cpu")
    mux.open(), mux.open()
    with pytest.raises(RuntimeError, match="busy"):
        mux.open()


def test_paused_session_state_is_bitwise_unchanged(model):
    """Ticks of one session leave a primed but starved session's state rows
    bit for bit as they were, and the step writes nothing into its input."""
    cfg, params, _, _ = model
    fl, tsr = cfg.frame_length, cfg.total_stride
    mux = SessionMultiplexer(params, cfg, slots=3, device="cpu")
    a, b = mux.open(), mux.open()
    mux.feed(a, _audio(40, fl + tsr))
    mux.feed(b, _audio(41, fl + tsr))  # both primed and stepped once
    rows = [t[b].clone() for t in tree_leaves(mux.pool)]
    before = [t.clone() for t in tree_leaves(mux.pool)]
    pool_in = mux.pool
    mux.feed(a, _audio(42, 5 * tsr))  # five ticks of a alone; b is paused
    assert mux.ticks == 2 + 5
    for got, want in zip(tree_leaves(mux.pool), rows):
        assert torch.equal(got[b], want)
    for got, want in zip(tree_leaves(pool_in), before):
        assert torch.equal(got, want)  # the step left its input state alone
    state, _ = ts.stream_prime(params, cfg, torch.from_numpy(_audio(43, fl)[None]))
    snapshot = [t.clone() for t in tree_leaves(state)]
    ts.stream_step(params, cfg, state, torch.from_numpy(_audio(44, tsr)[None]))
    ts.stream_step_block(params, cfg, state, torch.from_numpy(_audio(45, 4 * tsr)[None]))
    assert all(torch.equal(t, s) for t, s in zip(tree_leaves(state), snapshot))


# wide enough that the level and bottleneck matrices reach the default
# quant_min_size of 4096 values (the multiplexer quantizes at that size)
WIDER = dict(channels_H=16, max_H=64, tsfm_n_head=2, tsfm_d_model=32, tsfm_d_inner=64,
             normalize_input=True)


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_matches_jax_multiplexer(model, weights):
    """The same weights and traffic through the port's multiplexer and the
    JAX package's."""
    if weights == "fp32":
        cfg, params, jcfg, pn = model
    else:
        jcfg = JaxConfig(bottleneck="mamba", **WIDER)
        pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(1), jcfg))
        cfg, params = CleanUMambaConfig(**dataclasses.asdict(jcfg)), from_numpy(pn, "cpu")
    mux = SessionMultiplexer(params, cfg, slots=4, weights=weights, device="cpu")
    if weights == "int8":
        from cleanumamba_tpu_torch.quant import count_quantized

        assert count_quantized(mux.params) >= 10
    ours = _staggered(mux, cfg, (6, 5, 4))[1]
    theirs = _staggered(JaxMultiplexer(pn, jcfg, slots=4, weights=weights), cfg, (6, 5, 4))[1]
    for i in range(3):
        assert ours[i].shape == theirs[i].shape
        want = np.asarray(theirs[i])
        assert np.abs(ours[i] - want).max() <= 1e-4 * np.abs(want).max()


def test_from_bundle_raises(model):
    cfg, params, _, _ = model
    with pytest.raises(NotImplementedError, match="item 9b"):
        SessionMultiplexer.from_bundle("bundle", params)


def test_mha_refused_and_lstm_served(model):
    """The mha ring position is one for the whole batch: refused.  An lstm
    session beside another matches its solo stream."""
    cfg, params, _, _ = model
    from cleanumamba_tpu_torch.models.cleanumamba import init_params

    mha = dataclasses.replace(cfg, bottleneck="mha")
    with pytest.raises(ValueError, match="mha"):
        SessionMultiplexer(init_params(mha, torch.Generator().manual_seed(0), "cpu"), mha,
                           device="cpu")
    lstm = dataclasses.replace(cfg, bottleneck="lstm")
    pl = init_params(lstm, torch.Generator().manual_seed(0), "cpu")
    fl, tsr = lstm.frame_length, lstm.total_stride
    mux = SessionMultiplexer(pl, lstm, slots=2, device="cpu")
    a, b = mux.open(), mux.open()
    xa, xb = _audio(50, fl + 4 * tsr), _audio(51, fl + 2 * tsr)
    mux.feed(b, xb)
    out = np.concatenate([mux.feed(a, xa), mux._drain(a)])
    np.testing.assert_allclose(out, _solo(pl, lstm, xa), **TOL)
