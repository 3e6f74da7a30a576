"""The compiled dispatch of the port's offline paths (``graphs.ForwardGraphs``,
``train/distill.graph_kd_step``, the pruning pipeline's gradient, the
serving bench's rep) and the second-call capture of ``graphs.StepGraphs``.

On a CUDA device these replay CUDA graphs; on the CPU the same bodies run
eagerly, and that is what is held against the JAX package here:

- the forward owner's CPU path against ``jax.jit(forward)``, mamba and
  mamba2, within 1e-4 of max|ref| (fp32, ~30 matmuls deep);
- two steps of ``graph_kd_step``'s body against JAX's jitted
  ``make_kd_train_step``: the loss parts within 1e-4 relative, every leaf
  of params and adapters within 1e-4 of max(its leaf's largest value, 1e-3
  of the model's largest), Adam with eps 1.0 (``test_torch_distill.py``
  says why);
- the pruning pipeline's gradient body (``prune.driver.make_loss_and_grad``
  through the owner) against ``jax.value_and_grad`` of the JAX driver's
  ``loss_of``, at the start widths and after one prune: the loss within
  1e-5 relative, every gradient leaf within 2e-4 of max(its max|ref|, 1e-3
  of the model's largest gradient);
- ``StepGraphs`` refuses a CPU device; ``graph_kd_step`` refuses a second
  teacher tree.

The cases marked ``cuda`` hold each graph against its eager body on the
card, bit for bit (the gradients under torch's deterministic algorithms),
and skip without a CUDA device.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JCfg
from cleanumamba_tpu.config import LossConfig as JLoss
from cleanumamba_tpu.config import OptimizationConfig as JOpt
from cleanumamba_tpu.config import STFTLossConfig as JSTFT
from cleanumamba_tpu.losses import loss_fn as jax_loss_fn
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.prune import groups as jgroups
from cleanumamba_tpu.prune import pruner as jpruner
from cleanumamba_tpu.train import distill as jd
from cleanumamba_tpu.train.trainer import make_optimizer as jax_make_optimizer
from cleanumamba_tpu_torch import graphs
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
from cleanumamba_tpu_torch.config import STFTLossConfig
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.prune import driver as tdriver
from cleanumamba_tpu_torch.prune import pruner as tpruner
from cleanumamba_tpu_torch.train import distill as td
from cleanumamba_tpu_torch.train.optim import make_optimizer

TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32)
TEACHER = dict(TINY, channels_H=16, max_H=32, tsfm_d_model=32, tsfm_d_inner=64)
STFT = dict(fft_sizes=(256,), hop_sizes=(64,), win_lengths=(128,))
L = 2048
STEP_LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops run on one thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """numpy leaves in one (sorted-key) order for either package's tree."""
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _audio(B, n, seed):
    return (np.random.default_rng(seed).normal(size=(B, n)) * 0.3).astype(np.float32)


def _batch(seed):
    clean = _audio(2, L, seed)
    noisy = (clean + 0.1 * _audio(2, L, seed + 1)).astype(np.float32)
    return clean, noisy


def _model(family="mamba", seed=0, **kw):
    """(JAX config, numpy params, port config)."""
    jcfg = JCfg(bottleneck=family, **TINY, **kw)
    pn = _np(jax.jit(jm.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg))
    return jcfg, pn, CleanUMambaConfig(**dataclasses.asdict(jcfg))


def _close_leaves(got, want, tol):
    """Each leaf within ``tol`` of max(its max|ref|, 1e-3 of the largest)."""
    assert len(got) == len(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), floor)


# --- on the CPU, against the JAX package ---

@pytest.mark.parametrize("family", ["mamba", "mamba2"])
def test_forward_owner_matches_jax_jit(family):
    jcfg, pn, cfg = _model(family, seed=3)
    x = _audio(2, L, 11)
    fwd = graphs.ForwardGraphs(lambda p, v: tm.forward(p, v, cfg), "cpu")
    params = tparams.from_numpy(pn, "cpu")
    with torch.no_grad():
        got = fwd(params, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda p, v: jm.forward(p, v, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, pn), jnp.asarray(x)))
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert len(fwd) == 0 and fwd.pool is None  # the CPU captures nothing


def test_kd_step_body_two_steps_matches_jax():
    s_j, student, s_cfg = _model(seed=1)
    t_j = JCfg(**TEACHER)
    teacher = _np(jax.jit(jm.init_params, static_argnums=1)(jax.random.PRNGKey(0), t_j))
    t_cfg = CleanUMambaConfig(**dataclasses.asdict(t_j))
    adapters = _np(jd.make_kd_adapters(jax.random.PRNGKey(2), s_j, t_j))
    batches = [_batch(20), _batch(22)]
    opt_kw = dict(n_iters=1000, learning_rate=STEP_LR, eps=1.0)

    opt = make_optimizer(OptimizationConfig(**opt_kw), schedule=lambda s: STEP_LR)
    kd_step = td.graph_kd_step(td.make_kd_train_step(
        s_cfg, t_cfg, LossConfig(kd_p=1.0, stft_config=STFTLossConfig(**STFT)), opt), "cpu")
    p, a = tparams.from_numpy(student, "cpu"), tparams.from_numpy(adapters, "cpu")
    state, teacher_t = opt.init((p, a)), tparams.from_numpy(teacher, "cpu")
    for clean, noisy in batches:
        p, a, state, aux_t = kd_step(p, a, state, teacher_t,
                                     (torch.from_numpy(clean), torch.from_numpy(noisy)))
    with pytest.raises(ValueError, match="teacher of the first call"):
        kd_step(p, a, state, tparams.from_numpy(teacher, "cpu"),
                (torch.from_numpy(clean), torch.from_numpy(noisy)))

    jopt = jax_make_optimizer(JOpt(**opt_kw), schedule=lambda s: STEP_LR)
    jstep = jax.jit(jd.make_kd_train_step(s_j, t_j, JLoss(kd_p=1.0, stft_config=JSTFT(**STFT)),
                                          jopt))
    pj, aj = jax.tree_util.tree_map(jnp.asarray, (student, adapters))
    sj, tj = jopt.init((pj, aj)), jax.tree_util.tree_map(jnp.asarray, teacher)
    for clean, noisy in batches:
        pj, aj, sj, aux_j = jstep(pj, aj, sj, tj, (jnp.asarray(clean), jnp.asarray(noisy)))

    assert int(state["count"]) == 2
    for k in ("loss", "kd_loss", "reconstruct", "stft_sc", "stft_mag"):
        want = float(aux_j[k])
        assert abs(float(aux_t[k]) - want) <= 1e-4 * abs(want), k
    _close_leaves(_leaves(tparams.to_numpy([p, a])), _leaves([_np(pj), _np(aj)]), 1e-4)


def _jax_value_and_grad(jcfg, loss_cfg):
    """The JAX driver's gradient (``prune/driver.py`` ``make_loss_and_grad``)."""
    def loss_of(p, clean, noisy):
        den = jm.forward(p, noisy, jcfg)
        loss, _ = jax_loss_fn(den.astype(jnp.float32), clean.astype(jnp.float32), loss_cfg)
        return loss

    return jax.jit(jax.value_and_grad(loss_of))


@pytest.mark.parametrize("widths", ["start", "after one prune"])
def test_pruning_gradient_matches_jax_value_and_grad(widths):
    jcfg, pn, cfg = _model(seed=5)
    if widths != "start":  # 3 channels of every group (8 of a d_inner group) pruned
        rng = np.random.default_rng(5)
        selection = {g.name: sorted(rng.choice(g.n_channels, size=min(
            8 if g.name.startswith("d_inner") else 3, g.n_channels - 1),
            replace=False).tolist()) for g in jgroups.build_groups(pn, jcfg)}
        pt = tpruner.apply_pruning(tparams.from_numpy(pn, "cpu"), selection, cfg)[0]
        pn = _np(jpruner.apply_pruning(pn, selection, jcfg)[0])
        assert tm.count_params(pt) < tm.count_params(tparams.from_numpy(
            _model(seed=5)[1], "cpu"))
    else:
        pt = tparams.from_numpy(pn, "cpu")
    clean, noisy = _batch(30)
    grad_step = graphs.ForwardGraphs(tdriver.make_loss_and_grad(
        cfg, LossConfig(stft_config=STFTLossConfig(**STFT))), "cpu")
    loss_t, grads_t = grad_step(pt, torch.from_numpy(clean), torch.from_numpy(noisy))
    loss_j, grads_j = _jax_value_and_grad(jcfg, JLoss(stft_config=JSTFT(**STFT)))(
        jax.tree_util.tree_map(jnp.asarray, pn), jnp.asarray(clean), jnp.asarray(noisy))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    _close_leaves(_leaves(tparams.to_numpy(grads_t)), _leaves(_np(grads_j)), 2e-4)


def test_step_graphs_refuse_a_cpu_device():
    with pytest.raises(ValueError, match="need a CUDA device"):
        graphs.StepGraphs("cpu")
    assert td.graph_kd_step(lambda *a: a, "cpu").graphs is None


# --- on the card: each graph against its eager body ---

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms: the eager backward is not repeatable
    without them (cuDNN's weight gradients), so neither is graph ≡ eager."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _equal(a, b):
    la, lb = tparams.tensor_leaves(a), tparams.tensor_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mamba", "mamba2", "mamba_s4"])
def test_forward_graph_equals_eager_and_reads_the_callers_params(card, family):
    jcfg = JCfg(bottleneck=family, **TINY)
    init = jm.init_params if family == "mamba_s4" else jax.jit(jm.init_params, static_argnums=1)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    params = tm.prepare_for_length(tparams.from_numpy(_np(init(jax.random.PRNGKey(3), jcfg)),
                                                      card), cfg, L)
    kept = graphs.own(params)
    fwd = graphs.ForwardGraphs(lambda p, v: tm.forward(p, v, cfg), card)
    x = torch.from_numpy(_audio(2, L, 40))
    with torch.no_grad():
        want = tm.forward(params, x.to(card), cfg)
        first = fwd(params, x).clone()
        assert len(fwd) == 0  # a shape's first call runs eagerly
        second = fwd(params, x).clone()
        assert len(fwd) == 1  # its second is captured
        third = fwd(params, x).clone()
        for got in (first, second, third):
            assert torch.equal(got, want)
        assert _equal(params, kept)  # the caller's params were never written
        for t in tparams.tensor_leaves(params):  # changed in place: seen
            t.mul_(1.01)
        assert torch.equal(fwd(params, x), tm.forward(params, x.to(card), cfg))
        new = tparams.tree_map(lambda t: t * 0.98 if isinstance(t, torch.Tensor) else t, params)
        assert torch.equal(fwd(new, x), tm.forward(new, x.to(card), cfg))  # replaced: seen
        assert len(fwd) == 1


@pytest.mark.cuda
def test_kd_graph_equals_eager(card, deterministic):
    s_j, student, s_cfg = _model(seed=1)
    t_j = JCfg(**TEACHER)
    teacher = tparams.from_numpy(_np(jax.jit(jm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), t_j)), card)
    t_cfg = CleanUMambaConfig(**dataclasses.asdict(t_j))
    adapters = td.make_kd_adapters(torch.Generator().manual_seed(2), s_cfg, t_cfg, device=card)
    opt = make_optimizer(OptimizationConfig(n_iters=100, learning_rate=STEP_LR))
    step = td.make_kd_train_step(s_cfg, t_cfg, LossConfig(kd_p=1.0), opt, bf16=True)
    graphed = td.graph_kd_step(step, card)
    p0 = tparams.from_numpy(student, card)
    pe, ae, se = graphs.own(p0), graphs.own(adapters), opt.init((p0, adapters))
    pg, ag, sg = graphs.own(p0), graphs.own(adapters), opt.init((p0, adapters))
    batch = tuple(torch.from_numpy(b).to(card) for b in _batch(50))
    for i in range(3):
        pe, ae, se, aux_e = step(pe, ae, se, teacher, batch)
        pg, ag, sg, aux_g = graphed(pg, ag, sg, teacher, batch)
        assert len(graphed.graphs) == (1 if i else 0)
        assert all(torch.equal(aux_g[k], aux_e[k]) for k in aux_e)
    assert _equal([pg, ag, sg], [pe, ae, se])


@pytest.mark.cuda
def test_pruning_gradient_graphs_equal_eager_and_go_at_each_event(card, deterministic,
                                                                 monkeypatch):
    """Two prune events and two Adam steps (each width's gradient called
    twice: eager, then captured), graphed against the same pipeline with
    the gradient eager: the same params bit for bit; each event drops the
    old width's graphs."""
    jcfg, pn, cfg = _model(seed=5)
    owners, resets = [], []

    class Spy(graphs.ForwardGraphs):
        def __init__(self, fn, device):
            super().__init__(fn, device)
            owners.append(self)

        def reset(self):
            before = len(self)
            super().reset()
            resets.append((before, len(self), self.pool))

    phases = dict(training_samples=4, pruning_grad_samples=4, pruning_repeats=2, prune_steps=6,
                  steps_per_valid=1000, steps_per_ckpt=1000, perc_prune_channels_per_iter=0.02,
                  max_prune_importance_per_iter=None, min_channels_per_group=4,
                  calibration=False, min_total_channels=10)
    class Eager:
        def __init__(self, fn, device):
            self.fn = fn

        def __call__(self, params, *inputs):
            return self.fn(params, *inputs)

        def reset(self):
            pass

    runs = []
    for owner in (Spy, Eager):
        monkeypatch.setattr(tdriver, "ForwardGraphs", owner)

        def data():
            for seed in range(100, 200, 2):
                yield _batch(seed)

        runs.append(tdriver.pruning_pipeline(
            tparams.from_numpy(pn, card), cfg, LossConfig(), data(),
            tdriver.PruningConfig(**phases), batch_size=2, max_iters=6))
    (p_g, s_g, h_g, _), (p_e, s_e, h_e, _) = runs
    assert [h["n_iter"] for h in h_g] == [1, 3] and h_g == h_e
    assert _equal(p_g, p_e) and _equal(s_g["mu"], s_e["mu"])
    assert [r[:2] for r in resets] == [(1, 0), (1, 0)] and all(r[2] is None for r in resets)
    assert len(owners) == 1 and len(owners[0]) == 1  # the last width's graph alone


@pytest.mark.cuda
def test_serve_bench_rep_graph_equals_eager(card):
    from cleanumamba_tpu_torch.cli.serve import make_bench_run

    _, pn, cfg = _model()
    params = tparams.from_numpy(pn, card)
    run = make_bench_run(cfg, lambda p: p, 16, torch.float32)
    audio = torch.from_numpy(_audio(3, cfg.frame_length + 5 * 16 * cfg.total_stride, 60)).to(card)
    ticks = audio[:, cfg.frame_length:].reshape(3, 5, -1).transpose(0, 1).contiguous()
    with torch.no_grad():
        state, _ = ts.stream_prime(params, cfg, audio[:, :cfg.frame_length].contiguous(),
                                   torch.float32)
        kept = graphs.own(state)
        graphed = graphs.ForwardGraphs(run, card)
        for scale in (1.0, 1.001, 1.002):
            s = torch.tensor(scale)
            got = graphed((params, state), ticks, s).item()
            assert got == run((params, state), ticks, s.to(card)).item()
        assert len(graphed) == 1 and _equal(state, kept)  # every rep starts from the prime


@pytest.mark.cuda
def test_stream_many_captured_equals_the_eager_loop(card):
    _, pn, cfg = _model()
    params = tparams.from_numpy(pn, card)
    fl, tsr = cfg.frame_length, cfg.total_stride
    x = _audio(2, fl + 12 * tsr, 70)
    with torch.no_grad():
        state, _ = ts.stream_prime(params, cfg, torch.from_numpy(x[:, :fl]).to(card))
        g = graphs.StepGraphs(card)
        body = lambda st, blocks: ts.stream_many(params, cfg, st, blocks)  # noqa: E731
        sg, se = graphs.own(state), graphs.own(state)
        for k in range(3):
            blocks = torch.from_numpy(np.ascontiguousarray(
                x[:, fl + 4 * k * tsr: fl + 4 * (k + 1) * tsr].reshape(2, 4, tsr).transpose(
                    1, 0, 2)))
            sg, out_g = g("many", body, sg, blocks)
            se, out_e = ts.stream_many(params, cfg, se, blocks.to(card))
            assert torch.equal(out_g, out_e) and len(g) == (1 if k else 0)
        assert _equal(sg, se)
