"""The one-dispatch step of the port (``graphs.py``) and what it rests on.

On a CUDA device ``Streamer``, ``SessionMultiplexer``, the single-process
train step and ``make_device_data_steps`` replay CUDA graphs; on the CPU the
same bodies run eagerly.  Here, on the CPU:

- the in-place body a graph captures (``graphs.step_in_place``: the step,
  then the new state copied into the old) gives the functional step's
  output and state bit for bit, for every step that is captured;
- ``Streamer`` (single frames and blocks) and the masked multiplexer tick
  (staggered, paused and closed sessions) against the JAX package's, at the
  streaming tests' tolerance (1e-4 of max|ref|);
- the fp32 tensor schedule against JAX's over every step of a 1000-step run;
- the multi-tensor Adam against optax's chain over 5 steps;
- the sync-free ``skip_nonfinite_updates`` against JAX's on a NaN batch.

The cases marked ``cuda`` hold each graph against its eager body on the card
and pin the eager mesh step; they skip without a CUDA device.
"""

import dataclasses
import math

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import streaming as js
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.config import LossConfig as JaxLossConfig
from cleanumamba_tpu.config import OptimizationConfig as JaxOptConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.serve import SessionMultiplexer as JaxMultiplexer
from cleanumamba_tpu.train import trainer as jt
from cleanumamba_tpu.train.schedule import linear_warmup_cosine_decay as jax_schedule
from cleanumamba_tpu_torch import graphs
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
from cleanumamba_tpu_torch.serve import SessionMultiplexer
from cleanumamba_tpu_torch.train import optim as topt
from cleanumamba_tpu_torch.train import trainer as tt
from cleanumamba_tpu_torch.train.schedule import linear_warmup_cosine_decay_fp32

SMALL = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
             tsfm_d_model=16, tsfm_d_inner=32)
REL = 1e-4
L_TRAIN = 2048


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def small():
    """(port config, port params, JAX config, numpy params), normalize_input on."""
    jcfg = JaxConfig(**SMALL, normalize_input=True)
    pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg))
    return CleanUMambaConfig(**dataclasses.asdict(jcfg)), tparams.from_numpy(pn, "cpu"), jcfg, pn


def _audio(n, seed, B=1):
    return (np.random.default_rng(seed).normal(size=(B, n)) * 0.3).astype(np.float32)


def _leaves_equal(a, b):
    la, lb = tparams.tensor_leaves(a), tparams.tensor_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _rel(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size:  # the deepest level's cache is empty
        assert np.abs(got - want).max() <= REL * max(np.abs(want).max(), 1e-6), what


# --- the in-place bodies, eagerly ---

def _streamer_case(small, fused, n_frames):
    cfg, pt, _, _ = small
    s = ts.Streamer(pt, cfg, "cpu", batch=2, fused=fused)
    s.feed(_audio(cfg.frame_length + cfg.total_stride, 1, B=2))  # primed and stepped once
    step = s._frame_step if n_frames == 1 else s._block_step
    return step, s.state, (torch.from_numpy(_audio(n_frames * cfg.total_stride, 2, B=2)),)


def _mux_case(small):
    cfg, pt, _, _ = small
    mux = SessionMultiplexer(pt, cfg, slots=3, device="cpu")
    for sid, seed in ((mux.open(), 3), (mux.open(), 4)):
        mux.feed(sid, _audio(cfg.frame_length + cfg.total_stride, seed)[0])
    rows = torch.tensor([0, ~1, 2])  # slot 1 primed and paused: a padding row
    samples = torch.from_numpy(_audio(cfg.total_stride, 5, B=3))
    return mux._step_body, mux.pool, (rows, samples)


def _applied(state, new):
    """The state a step's result describes: each ``graphs.Rows`` leaf's rows
    (its non-negative indices) put into a copy of the state's leaf, any other
    leaf as it is."""
    def put(old, leaf):
        if not isinstance(leaf, graphs.Rows):
            return leaf
        keep = leaf.index >= 0
        out = old.clone()
        out[leaf.index[keep]] = leaf.values[keep]
        return out

    return tparams.tree_unflatten(state, [put(o, n) for o, n in zip(
        tparams.tree_leaves(state), tparams.tree_leaves(new))])


def _train_case(small, skip):
    cfg, pt, _, _ = small
    opt = topt.make_optimizer(OptimizationConfig(n_iters=100, learning_rate=1e-3,
                                                 weight_decay=0.1, optimizer="adamw"))
    step = tt.make_train_step(cfg, LossConfig(), opt, bf16=False, skip_nonfinite_updates=True)
    clean = _audio(L_TRAIN, 6, B=2)[None]
    noisy = clean + 0.1 * _audio(L_TRAIN, 7, B=2)[None]
    if skip:
        noisy[0, 0, 10] = np.nan

    def body(state, c, n):
        p, s, aux = step(state[0], state[1], (c, n))
        return [p, s], aux

    return body, [pt, opt.init(pt)], (torch.from_numpy(clean), torch.from_numpy(noisy))


@pytest.mark.parametrize("case", ["streamer-plain-frame", "streamer-mega-frame",
                                  "streamer-block", "mux-tick-paused", "train-step",
                                  "train-step-nonfinite"])
def test_in_place_body_equals_functional_step(small, case):
    """The body a graph captures (step, then the new state copied into the
    state it read) leaves the state and returns the output that the
    functional step gives, bit for bit."""
    if case.startswith("streamer"):
        fused = {"plain": False, "mega": "mega"}.get(case.split("-")[1], False)
        fn, state, inputs = _streamer_case(small, fused, 3 if case.endswith("block") else 1)
    elif case.startswith("mux"):
        fn, state, inputs = _mux_case(small)
    else:
        fn, state, inputs = _train_case(small, case.endswith("nonfinite"))
    want_state, want_out = fn(graphs.own(state), *inputs)
    if case.startswith("mux"):  # the tick returns the rows it stepped
        want_state = _applied(state, want_state)
    static = graphs.own(state)
    before = [t.data_ptr() for t in tparams.tensor_leaves(static)]
    out = graphs.step_in_place(fn, static, *inputs)
    assert [t.data_ptr() for t in tparams.tensor_leaves(static)] == before  # in place
    assert _leaves_equal(static, want_state)
    if isinstance(want_out, dict):
        assert want_out.keys() == out.keys()
        for k in want_out:  # a NaN batch's loss is NaN in both
            torch.testing.assert_close(out[k], want_out[k], rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(out, want_out)


def test_write_back_reads_no_leaf_it_has_written():
    """A new leaf that is (a view of) another state leaf is copied before any
    leaf is written; one that is its own target is left alone."""
    a, b, c = torch.arange(4.0), torch.arange(4.0) + 10, torch.arange(4.0) + 20
    state = {"a": a, "b": b, "c": c}
    graphs.write_back(state, {"a": b, "b": a[:], "c": c})  # swap a and b, keep c
    assert torch.equal(a, torch.arange(4.0) + 10) and torch.equal(b, torch.arange(4.0))
    assert torch.equal(c, torch.arange(4.0) + 20)
    with pytest.raises(ValueError, match="leaf 0"):
        graphs.write_back({"a": a}, {"a": torch.zeros(3)})


@pytest.mark.parametrize("rows", [[2], [0, 3], [3, ~1, 0], [0, 1, 2, 3]])
def test_write_back_copies_the_rows_of_a_rows_leaf(rows):
    """A ``Rows`` leaf writes its rows of the state leaf in place and no
    other row (a negative index writes nothing), beside whole leaves; one
    whose rows are not the leaf's shape is refused."""
    a, b = torch.arange(12.0).reshape(4, 3), torch.arange(4.0)
    state = {"a": a, "b": b}
    ptrs = (a.data_ptr(), b.data_ptr())
    index = torch.tensor(rows)
    values = -1.0 - torch.arange(3.0 * len(rows)).reshape(len(rows), 3)
    graphs.write_back(state, {"a": graphs.Rows(index, values), "b": b + 1})
    want = torch.arange(12.0).reshape(4, 3)
    want[index[index >= 0]] = values[index >= 0]
    assert torch.equal(a, want) and torch.equal(b, torch.arange(4.0) + 1)
    assert (a.data_ptr(), b.data_ptr()) == ptrs
    with pytest.raises(ValueError, match="leaf 0"):
        graphs.write_back(state, {"a": graphs.Rows(index, torch.zeros(len(rows), 2)),
                                  "b": b})


# --- against the JAX package ---

def _feed(streamer, x, sizes):
    outs, pos = [], 0
    for n in sizes:
        outs.append(streamer.feed(x[:, pos:pos + n]))
        pos += n
    outs.append(streamer.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("fused", [False, "mega"])
def test_streamer_matches_jax(small, fused):
    """Prime, single frames and 3-frame blocks in turns, then flush: the
    output and the carried state against JAX's Streamer."""
    cfg, pt, jcfg, pn = small
    fl, tsr = cfg.frame_length, cfg.total_stride
    sizes = [fl, tsr, 3 * tsr, tsr - 7, 7, 3 * tsr]
    x = _audio(sum(sizes) + 2 * tsr, 8)
    s_t = ts.Streamer(pt, cfg, "cpu", fused=fused)
    s_j = js.Streamer(jax.tree_util.tree_map(jnp.asarray, pn), jcfg)
    got, want = _feed(s_t, x, sizes), _feed(s_j, x, sizes)
    _rel(got, want)
    ours = jax.tree_util.tree_leaves(tparams.to_numpy(s_t.state))  # both in sorted-key order
    theirs = jax.tree_util.tree_leaves(s_j.state)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _rel(a, b, "state")


def test_masked_multiplexer_matches_jax(small):
    """Session 0 streams on; session 1 is primed, starved (paused) for several
    ticks and fed again; session 2 joins late and closes; slot 3 stays empty.
    Every session's audio against JAX's multiplexer on the same traffic."""
    cfg, pt, jcfg, pn = small
    fl, tsr = cfg.frame_length, cfg.total_stride
    audio = [_audio(fl + 12 * tsr, 20 + i)[0] for i in range(3)]
    plan = [(0, 0, fl + 2 * tsr), (1, 0, fl + tsr), (0, fl + 2 * tsr, fl + 6 * tsr),
            (2, 0, fl + 3 * tsr), (0, fl + 6 * tsr, fl + 9 * tsr),
            (1, fl + tsr, fl + 5 * tsr), (2, "close", None), (0, fl + 9 * tsr, fl + 12 * tsr),
            (1, fl + 5 * tsr, fl + 12 * tsr)]

    def run(mux):
        sids = [mux.open(), mux.open(), mux.open()]
        got = {i: [] for i in range(3)}
        for i, lo, hi in plan:
            if lo == "close":
                got[i].append(mux._drain(sids[i]))
                mux.close(sids[i])
                continue
            got[i].append(np.asarray(mux.feed(sids[i], audio[i][lo:hi])))
        return {i: np.concatenate(got[i] + ([np.asarray(mux._drain(sids[i]))] if i < 2 else []))
                for i in range(3)}

    ours = run(SessionMultiplexer(pt, cfg, slots=4, device="cpu"))
    theirs = run(JaxMultiplexer(pn, jcfg, slots=4))
    for i in range(3):
        assert ours[i].shape == theirs[i].shape and ours[i].size > 0
        _rel(ours[i], theirs[i], f"session {i}")


@pytest.mark.parametrize("lr_max,n_iter", [(1e-4, 1000), (2e-4, 77), (5e-4, 10)])
def test_fp32_schedule_matches_jax(lr_max, n_iter):
    """Every step of the run and a few past it.  Both compute in fp32; the
    two libraries' cos may differ by one unit in the last place, which the
    cosine's amplitude carries into lr where 1 + cos is small: the bound is
    rtol 1e-6 plus that one unit (2^-23 of cos) times the amplitude."""
    steps = np.arange(n_iter + 5)
    got = linear_warmup_cosine_decay_fp32(lr_max, n_iter)(torch.from_numpy(steps).int())
    assert got.dtype == torch.float32
    want = np.asarray(jax.vmap(jax_schedule(lr_max, n_iter))(steps))
    lr_final = lr_max / 25.0 / 1e4
    ulp = (lr_max - lr_final) / 2.0 * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ulp)


def _opt_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "layers": [{"k": (rng.normal(size=(3, 4, 2)) * scale).astype(np.float32)}]}


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name,weight_decay,grad_scale", [
    ("adam", 0.0, 1.0), ("adam", 0.1, 1.0), ("adam", 0.1, 100.0),
    ("adamw", 0.1, 1.0), ("adamw", 0.1, 100.0)])
def test_foreach_adam_matches_optax(name, weight_decay, grad_scale):
    """Five updates of the multi-tensor Adam (default fp32 warm-up cosine
    schedule over 10 iterations; grad_scale 100 clips) against optax's chain
    of the JAX package's ``make_optimizer``: updates to rtol 5e-5 (the fp32
    bias corrections), params to rtol 1e-6, the count an int32 tensor."""
    kw = dict(n_iters=10, learning_rate=1e-3, optimizer=name, weight_decay=weight_decay)
    jopt = jt.make_optimizer(JaxOptConfig(**kw))
    opt = topt.make_optimizer(OptimizationConfig(**kw))
    jp, tp = _opt_tree(0), tparams.from_numpy(_opt_tree(0), "cpu")
    jstate, tstate = jopt.init(jp), opt.init(tp)
    for k in range(5):
        g = _opt_tree(1 + k, grad_scale)
        ju, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = opt.update(tparams.from_numpy(g, "cpu"), tstate, tp)
        tp = topt.apply_updates(tp, tu)
        for a, b in zip(_np_leaves(tparams.to_numpy(tu)), _np_leaves(ju)):
            np.testing.assert_allclose(a, b, rtol=5e-5, atol=1e-8)
    for a, b in zip(_np_leaves(tparams.to_numpy(tp)), _np_leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 5


TINY = dict(channels_H=4, max_H=8, encoder_n_layers=3, tsfm_n_layers=2, tsfm_d_model=16,
            tsfm_n_head=2, tsfm_d_inner=32)


def test_nonfinite_skip_matches_jax():
    """A NaN in the batch: both steps report grads_finite False and return
    the params and the optimizer state (count 3, moments nonzero) with the
    values they were given, bit for bit."""
    jcfg = JaxConfig(**TINY)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    pn = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(9)
    clean = (rng.normal(size=(1, 2, L_TRAIN)) * 0.3).astype(np.float32)
    noisy = clean.copy()
    noisy[0, 1, 7] = np.nan

    kw = dict(n_iters=100, learning_rate=1e-3)
    jopt = jt.make_optimizer(JaxOptConfig(**kw))
    jstate = jopt.init(pn)
    adam = next(s for s in jstate if isinstance(s, optax.ScaleByAdamState))
    mu = jax.tree_util.tree_map(lambda x: (rng.normal(size=x.shape) * 1e-3).astype(np.float32),
                                adam.mu)
    nu = jax.tree_util.tree_map(lambda x: (rng.random(size=x.shape) * 1e-6).astype(np.float32),
                                adam.nu)
    jstate = jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.int32(3), mu=mu, nu=nu)
        if isinstance(s, optax.ScaleByAdamState) else s, jstate,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    jstep = jax.jit(jt.make_train_step(jcfg, JaxLossConfig(), jopt, bf16=False,
                                       skip_nonfinite_updates=True))
    jp2, js2, jaux = jstep(pn, jstate, (jnp.asarray(clean), jnp.asarray(noisy)))
    assert not bool(jaux["grads_finite"])
    for a, b in zip(jax.tree_util.tree_leaves((jp2, js2)), jax.tree_util.tree_leaves((pn, jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    opt = topt.make_optimizer(OptimizationConfig(**kw))
    pt = tparams.from_numpy(pn, "cpu")
    state = {"count": torch.tensor(3, dtype=torch.int32),
             "mu": tparams.from_numpy(mu, "cpu"), "nu": tparams.from_numpy(nu, "cpu")}
    step = tt.make_train_step(cfg, LossConfig(), opt, bf16=False, skip_nonfinite_updates=True)
    p2, s2, aux = step(pt, state, (torch.from_numpy(clean), torch.from_numpy(noisy)))
    assert not bool(aux["grads_finite"])
    assert _leaves_equal(p2, pt) and _leaves_equal(s2, state)
    assert s2["count"].dtype == torch.int32 and int(s2["count"]) == 3
    for a, b in zip(_np_leaves(tparams.to_numpy(p2)), _np_leaves(jp2)):
        np.testing.assert_array_equal(a, b)


# --- on the card: each graph against its eager body ---

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _card_model(small, dev):
    cfg, pt, _, _ = small
    return cfg, tparams.to_device(pt, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True, "mega"])
def test_streamer_graph_equals_eager_on_the_card(small, card, fused):
    cfg, params = _card_model(small, card)
    fl, tsr = cfg.frame_length, cfg.total_stride
    sizes = [fl, tsr, 3 * tsr, tsr, 3 * tsr, tsr]
    x = _audio(sum(sizes), 30, B=2)
    graphed = ts.Streamer(params, cfg, card, batch=2, fused=fused)
    eager = ts.Streamer(params, cfg, card, batch=2, fused=fused)
    eager._graphs = None
    got, want = _feed(graphed, x, sizes), _feed(eager, x, sizes)
    # a frame and a 3-frame block, each fed twice (eager, then captured); the
    # flush's block comes once and runs eagerly
    assert len(graphed._graphs) == 2
    np.testing.assert_array_equal(got, want)
    assert _leaves_equal(graphed.state, eager.state)


@pytest.mark.cuda
def test_multiplexer_graph_equals_eager_on_the_card(small, card):
    cfg, params = _card_model(small, card)
    fl, tsr = cfg.frame_length, cfg.total_stride
    outs = []
    for graphed in (True, False):
        mux = SessionMultiplexer(params, cfg, slots=3, device=card)
        if not graphed:
            mux._graphs = None
        a, b = mux.open(), mux.open()
        got = [mux.feed(a, _audio(fl + 2 * tsr, 31)[0]), mux.feed(b, _audio(fl + tsr, 32)[0]),
               mux.feed(a, _audio(4 * tsr, 33)[0]), mux.feed(b, _audio(3 * tsr, 34)[0])]
        outs.append((np.concatenate(got), mux.pool))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert _leaves_equal(outs[0][1], outs[1][1])


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms: the eager backward is not repeatable
    without them (cuDNN's weight gradients), so neither is graph ≡ eager."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_train_step_and_device_data_graphs_equal_eager_on_the_card(small, card, deterministic):
    cfg, params = _card_model(small, card)
    opt = topt.make_optimizer(OptimizationConfig(n_iters=100, learning_rate=1e-3))
    step = tt.make_train_step(cfg, LossConfig(), opt, bf16=False)
    batch = tuple(torch.from_numpy(_audio(L_TRAIN, s, B=2)[None]).to(card) for s in (40, 41))
    pe, se = graphs.own(params), opt.init(params)
    pg, sg = graphs.own(params), opt.init(params)
    graphed = tt.graph_train_step(step, card)
    for _ in range(3):
        pe, se, aux_e = step(pe, se, batch)
        pg, sg, aux_g = graphed(pg, sg, batch)
        assert all(torch.equal(aux_g[k], aux_e[k]) for k in aux_e)
    assert _leaves_equal(pg, pe) and _leaves_equal(sg, se) and len(graphed.graphs) == 1

    stepper = tt.make_device_data_steps(step, 1, L_TRAIN, 2)
    gen_e = torch.Generator(card).manual_seed(5)
    gen_g = torch.Generator(card).manual_seed(5)
    pe, se, pg, sg = graphs.own(params), opt.init(params), graphs.own(params), opt.init(params)
    for _ in range(2):
        pe, se, _ = tt.make_device_data_steps(step, 1, L_TRAIN, 2)(pe, se, gen_e)
        pg, sg, _ = stepper(pg, sg, gen_g)
    assert _leaves_equal(pg, pe) and _leaves_equal(sg, se)
    assert torch.equal(gen_g.get_state(), gen_e.get_state())


@pytest.mark.cuda
def test_mesh_step_stays_eager_on_the_card(small, card, monkeypatch):
    """A step with a mesh is not captured (its gloo all-reduces go through the
    host): make_device_data_steps runs it eagerly, and returns new trees."""
    import socket

    from cleanumamba_tpu_torch.parallel import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    mesh = make_mesh(card, backend="gloo")
    try:
        cfg, params = _card_model(small, card)
        opt = topt.make_optimizer(OptimizationConfig(n_iters=100, learning_rate=1e-3))
        step = tt.make_train_step(cfg, LossConfig(), opt, bf16=False, mesh=mesh)
        stepper = tt.make_device_data_steps(step, 1, L_TRAIN, 1, mesh=mesh)
        p, s, aux = stepper(params, opt.init(params), torch.Generator(card).manual_seed(0))
        assert not any(a is b for a, b in zip(tparams.tensor_leaves(p),
                                              tparams.tensor_leaves(params)))
        assert math.isfinite(float(aux["loss"]))
    finally:
        torch.distributed.destroy_process_group()
