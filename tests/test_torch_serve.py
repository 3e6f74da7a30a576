"""PyTorch port ``SessionMultiplexer`` (``serve.py``) against itself and the
JAX package.

Mirrors ``tests/test_serve.py``: a session multiplexed beside other traffic
(staggered joins, uneven feeds, an empty slot, slot churn, block-4 ticks)
gives the audio it gives streamed alone at batch 1 (1e-5), ``flush`` trims to
the fed length and a full pool refuses a session.  Beyond it: a paused
session's state rows are bitwise unchanged across ticks of others, and the
step writes nothing into its input state; the port's multiplexer equals the
JAX package's on the same weights and traffic in fp32, bf16 and int8 (1e-4
of max|ref|: the two frameworks' CPU sums).  At block 1 the port's ticks run
every level through the fused level kernels' plain versions (the packs the
card runs as K3/K4); the JAX package's run per op.  The long-audio cases are marked
slow as the JAX package's are; a fast case of each runs in the tier.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.serve import SessionMultiplexer as JaxMultiplexer
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.ops.cuda.stream_fused import pack_stream_params
from cleanumamba_tpu_torch.params import (
    from_numpy,
    prepare_weight_view,
    tensor_leaves,
    tree_leaves,
)
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
    assert mux.packed_levels == 2 * cfg.encoder_n_layers  # the ticks run the packs
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
    packs = pack_stream_params(params, cfg, torch.float32)
    ts.stream_step(ts.without_packed_levels(params, packs[1]), cfg, state,
                   torch.from_numpy(_audio(44, tsr)[None]), packs=packs)
    ts.stream_step_block(params, cfg, state, torch.from_numpy(_audio(45, 4 * tsr)[None]))
    assert all(torch.equal(t, s) for t, s in zip(tree_leaves(state), snapshot))


# wide enough that the level and bottleneck matrices reach the default
# quant_min_size of 4096 values (the multiplexer quantizes at that size)
WIDER = dict(channels_H=16, max_H=64, tsfm_n_head=2, tsfm_d_model=32, tsfm_d_inner=64,
             normalize_input=True)


@pytest.mark.parametrize("weights,dtype,slots,block,packs", [
    ("fp32", torch.float32, 8, 1, True), ("fp32", torch.float32, 16, 1, True),
    ("bf16", torch.bfloat16, 16, 1, True), ("bf16", torch.float32, 16, 1, True),
    ("fp32", torch.bfloat16, 16, 1, True), ("int8", torch.bfloat16, 16, 1, True),
    ("int8", torch.float32, 4, 1, False), ("fp32", torch.float32, 4, 4, False),
    ("bf16", torch.float32, 4, 4, False)])
def test_levels_pack_where_the_constructor_chooses(model, weights, dtype, slots, block, packs):
    """Every level packs at block 1, whatever the weights' storage type and
    the state's; never for int8 weights in fp32 state (an int8 pack computes
    in bf16) or at a block above 1."""
    cfg, params, _, _ = model
    mux = SessionMultiplexer(params, cfg, slots=slots, block=block, dtype=dtype,
                             weights=weights, device="cpu")
    assert mux.packed_levels == (2 * cfg.encoder_n_layers if packs else 0)
    _check_widened(mux, params, weights, dtype)


def _check_widened(mux, params, weights, dtype):
    """Where the ticks compute in fp32, every bf16 leaf outside the packs is
    held in fp32 (five a mamba layer, the two bottleneck projections; at a
    block above 1, where nothing packs, every bf16 leaf), and no bf16 leaf is
    left in the tick's tree; fp32 and int8 weights and bf16 state keep the
    stored leaves as they are."""
    stored = prepare_weight_view(params, weights, dtype)[0]
    bf16 = sum(t.dtype == torch.bfloat16 for t in tree_leaves(stored))
    if weights == "bf16" and dtype == torch.float32:
        want = 5 * mux.cfg.tsfm_n_layers + 2 if mux.packed_levels else bf16
        assert mux.widened == want > 0
        assert not any(t.dtype == torch.bfloat16 for t in tensor_leaves(mux._step_params))
        assert bf16 - sum(t.dtype == torch.bfloat16 for t in tree_leaves(mux.params)) == want
    else:
        assert mux.widened == 0
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(tensor_leaves(mux.params), tensor_leaves(stored)))


@pytest.mark.parametrize("weights", ["fp32", "bf16", "int8"])
def test_matches_jax_multiplexer(model, weights):
    """The same weights and traffic through the port's multiplexer and the
    JAX package's.  The port's ticks run every level through the packs, bf16
    weights as stored in an fp32 pack; int8 weights with fp32 state stay per
    op (an int8 pack computes in bf16)."""
    if weights == "fp32":
        cfg, params, jcfg, pn = model
    else:
        jcfg = JaxConfig(bottleneck="mamba", **WIDER)
        pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(1), jcfg))
        cfg, params = CleanUMambaConfig(**dataclasses.asdict(jcfg)), from_numpy(pn, "cpu")
    mux = SessionMultiplexer(params, cfg, slots=4, weights=weights, device="cpu")
    assert mux.packed_levels == (0 if weights == "int8" else 2 * cfg.encoder_n_layers)
    if weights == "int8":
        from cleanumamba_tpu_torch.quant import count_quantized

        assert count_quantized(mux.params) >= 10
    ours = _staggered(mux, cfg, (6, 5, 4))[1]
    theirs = _staggered(JaxMultiplexer(pn, jcfg, slots=4, weights=weights), cfg, (6, 5, 4))[1]
    for i in range(3):
        assert ours[i].shape == theirs[i].shape
        want = np.asarray(theirs[i])
        assert np.abs(ours[i] - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("family", ["mha", "lstm"])
def test_mha_and_lstm_served(model, family):
    """An mha session (its own KV rings and position in the pool) and an
    lstm one, each beside another session, match their solo streams."""
    cfg, params, _, _ = model
    from cleanumamba_tpu_torch.models.cleanumamba import init_params

    other = dataclasses.replace(cfg, bottleneck=family)
    po = init_params(other, torch.Generator().manual_seed(0), "cpu")
    fl, tsr = other.frame_length, other.total_stride
    mux = SessionMultiplexer(po, other, slots=2, device="cpu")
    a, b = mux.open(), mux.open()
    xa, xb = _audio(50, fl + 4 * tsr), _audio(51, fl + 2 * tsr)
    mux.feed(b, xb)
    out = np.concatenate([mux.feed(a, xa), mux._drain(a)])
    np.testing.assert_allclose(out, _solo(po, other, xa), **TOL)


# --- the tick at the width of its live rows ---------------------------------

WIDTH_SLOTS = 6  # widths 1, 2, 4 and 6: above 4 live rows the tick runs every slot
# live rows a tick -> the width it runs at (5: every slot, one of them paused)
WIDTHS = {1: 1, 2: 2, 3: 4, 5: WIDTH_SLOTS, WIDTH_SLOTS: WIDTH_SLOTS}


@pytest.mark.parametrize("slots", [1, 2, 6, 8, 12, 16])
def test_tick_width_is_the_next_power_of_two_within_slots(slots):
    from cleanumamba_tpu_torch.serve import tick_width

    widths = [tick_width(n, slots) for n in range(1, slots + 1)]
    assert all(n <= w <= slots for n, w in zip(range(1, slots + 1), widths))
    assert all(w == slots or w & (w - 1) == 0 for w in widths)
    assert all(w == slots or w < 2 * n for n, w in zip(range(1, slots + 1), widths))
    assert len(set(widths)) <= math.ceil(math.log2(slots)) + 1
    assert widths[-1] == slots


def _hops(mux, hops):
    """Buffer each ``(sid, samples)`` hop, then pump once: one tick of those
    sessions."""
    for sid, x in hops:
        mux._buf[sid] = np.concatenate([mux._buf[sid], x])
        mux._fed[sid] += x.shape[0]
    mux._pump()


def _width_run(mux, cfg, n_live, rounds=4, check=None):
    """Every slot admitted, then ``rounds`` ticks of ``n_live`` live rows, the
    live set turning so that each session pauses.  ``check(live, before,
    pool_in)`` runs after each tick with the pool's leaves as they were
    before it.  Returns ({sid: audio}, {sid: output})."""
    fl, tsr = cfg.frame_length, cfg.total_stride
    audio, outs = {}, {}
    for sid in range(mux.slots):
        assert mux.open() == sid
        audio[sid] = _audio(60 + sid, fl)
        outs[sid] = [mux.feed(sid, audio[sid])]
    assert mux.ticks == 0
    for r in range(rounds):
        live = sorted((r * n_live + k) % mux.slots for k in range(n_live))
        hops = [(s, _audio(100 * r + s, tsr)) for s in live]
        before, pool_in = [t.clone() for t in tree_leaves(mux.pool)], mux.pool
        _hops(mux, hops)
        for s, x in hops:
            audio[s] = np.concatenate([audio[s], x])
        if check is not None:
            check(live, before, pool_in)
    return audio, {s: np.concatenate(o + [mux._drain(s)]) for s, o in outs.items()}


@pytest.mark.parametrize("n_live", sorted(WIDTHS))
def test_width_ticks_match_each_session_alone(model, n_live):
    """A session beside others, in ticks of 1, 2, 3 (width 4), 5 (every slot,
    one paused) and every live row, matches itself streamed alone; the ticks
    run at their width."""
    cfg, params, _, _ = model
    mux = SessionMultiplexer(params, cfg, slots=WIDTH_SLOTS, device="cpu")
    audio, outs = _width_run(mux, cfg, n_live)
    assert mux.rows_stepped == mux.ticks * WIDTHS[n_live] and mux.ticks == 4
    for s in range(WIDTH_SLOTS):
        want = _solo(params, cfg, audio[s])
        assert outs[s].shape == want.shape
        np.testing.assert_allclose(outs[s], want, **TOL)


@pytest.mark.parametrize("n_live", sorted(WIDTHS))
def test_width_ticks_keep_rows_outside_them(model, n_live):
    """Every row without a hop (paused sessions, and the padding rows a tick
    of 3 live rows runs at width 4 or one of 5 at width 6) is bitwise what
    it was; the tick writes nothing into the pool it read."""
    cfg, params, _, _ = model
    mux = SessionMultiplexer(params, cfg, slots=WIDTH_SLOTS, device="cpu")

    def check(live, before, pool_in):
        rest = [s for s in range(WIDTH_SLOTS) if s not in live]
        for got, old in zip(tree_leaves(mux.pool), before):
            assert torch.equal(got[rest], old[rest])
            assert not torch.equal(got[live], old[live]) or not got.numel()
        assert all(torch.equal(t, old) for t, old in zip(tree_leaves(pool_in), before))

    _width_run(mux, cfg, n_live, check=check)
    assert mux.ticks == 4


@pytest.mark.parametrize("n_live", sorted(WIDTHS))
def test_bundle_functions_tick_every_slot(model, n_live):
    """A bundle's callables were traced at batch = slots: their multiplexer
    steps every row a tick, the rows without a hop kept, and matches the
    sessions alone."""
    cfg, params, _, _ = model
    fns = {"prime": lambda p, f: ts.stream_prime(p, cfg, f),
           "step": lambda p, s, n: ts.stream_step(p, cfg, s, n)}
    mux = SessionMultiplexer(params, cfg, slots=WIDTH_SLOTS, device="cpu", fns=fns)

    def check(live, before, pool_in):
        rest = [s for s in range(WIDTH_SLOTS) if s not in live]
        assert all(torch.equal(t[rest], old[rest]) for t, old in zip(tree_leaves(mux.pool),
                                                                      before))

    audio, outs = _width_run(mux, cfg, n_live, check=check)
    assert mux.rows_stepped == mux.ticks * WIDTH_SLOTS and mux.ticks == 4
    for s in range(WIDTH_SLOTS):
        np.testing.assert_allclose(outs[s], _solo(params, cfg, audio[s]), **TOL)


@pytest.mark.parametrize("slots", [4, 16])
def test_level_packs_hold_every_width_without_regrowing(model, slots):
    """Each pack's scratch is sized at construction for ``slots`` rows, the
    widest tick: a level call of any width up to it leaves the scratch
    where it was (a graph captured at one width keeps writing the scratch it
    was captured with)."""
    from cleanumamba_tpu_torch.ops.cuda import stream_fused as sf

    cfg, params, _, _ = model
    mux = SessionMultiplexer(params, cfg, slots=slots, weights="bf16", device="cpu")
    assert mux.packed_levels == 2 * cfg.encoder_n_layers
    arrays, meta = mux._packs
    for a, m in zip(arrays["enc"] + arrays["dec"], meta["enc"] + meta["dec"]):
        ptr = a["scratch"].data_ptr()
        for B in range(1, slots + 1):
            sf._plan_for("level", a, m, B, m["T"], torch.zeros(1))
        assert a["scratch"].data_ptr() == ptr


@pytest.mark.parametrize("n_live", [1, 8, 9])
def test_block_one_ticks_run_the_packs_at_their_width(model, n_live, monkeypatch):
    """Over weights stored in the state's dtype, every tick runs the level
    packs at its width, the widest too (9 live rows: width 12 of 12 slots),
    and matches the sessions alone."""
    from cleanumamba_tpu_torch.serve import tick_width

    cfg, params, _, _ = model
    seen, real = [], ts.stream_step

    def spy(p, cfg_, state, samples, *args, packs=None, **kw):
        seen.append((samples.shape[0], packs is not None))
        return real(p, cfg_, state, samples, *args, packs=packs, **kw)

    monkeypatch.setattr(ts, "stream_step", spy)
    mux = SessionMultiplexer(params, cfg, slots=12, device="cpu")
    assert mux.packed_levels == 2 * cfg.encoder_n_layers
    audio, outs = _width_run(mux, cfg, n_live)
    assert seen == [(tick_width(n_live, mux.slots), True)] * mux.ticks and mux.ticks == 4
    monkeypatch.setattr(ts, "stream_step", real)
    for s in range(mux.slots):
        np.testing.assert_allclose(outs[s], _solo(params, cfg, audio[s]), **TOL)


@pytest.mark.parametrize("n_live", [1, 2, 5, WIDTH_SLOTS])
def test_widened_ticks_equal_the_ticks_that_cast(model, n_live):
    """bf16 weights, fp32 state: ticks of 1, 2, 5 (every slot, one paused) and
    every live row, the live set turning, give bit for bit the outputs and
    pool of the same ticks over the stored bf16 weights cast per product."""
    cfg, params, _, _ = model
    wide, cast = [SessionMultiplexer(params, cfg, slots=WIDTH_SLOTS, weights="bf16",
                                     device="cpu") for _ in range(2)]
    assert wide.widened == 5 * cfg.tsfm_n_layers + 2
    stored = prepare_weight_view(params, "bf16")[0]  # read as stored, cast in every tick
    cast.params, cast._step_params = stored, ts.without_packed_levels(stored, cast._packs[1])
    a_in, a_out = _width_run(wide, cfg, n_live)
    b_in, b_out = _width_run(cast, cfg, n_live)
    assert wide.ticks == cast.ticks == 4
    for s in range(WIDTH_SLOTS):
        assert np.array_equal(a_in[s], b_in[s]) and np.array_equal(a_out[s], b_out[s]), s
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(wide.pool), tree_leaves(cast.pool)))
