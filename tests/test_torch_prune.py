"""The port's structured channel pruning (``cleanumamba_tpu_torch/prune/``)
and its telemetry forward, held against the JAX package on a tiny config.

Both packages get the same numpy weights and the same numpy gradients, so
group graphs, importances, selections and pruned trees (params, grads and
the Adam moments) must be equal bit for bit; the pruned model's fp32
forward and the telemetry taps are held to 1e-5 of their largest value.
The port runs before JAX in every test.
"""

import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.prune import groups as jgroups
from cleanumamba_tpu.prune import importance as jimp
from cleanumamba_tpu.prune import pruner as jpruner
from cleanumamba_tpu.prune.telemetry import TelemetryAccumulator as JAcc
from cleanumamba_tpu_torch import config as tconfig
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.config import LossConfig
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.prune import groups as tgroups
from cleanumamba_tpu_torch.prune import importance as timp
from cleanumamba_tpu_torch.prune import pruner as tpruner
from cleanumamba_tpu_torch.prune.telemetry import TelemetryAccumulator as TAcc
from cleanumamba_tpu_torch.train.trainer import make_grad_fn

TINY = dict(channels_H=16, max_H=32, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=32, tsfm_d_inner=64)
FAMILIES = {"mamba": TINY, "lstm": dict(TINY, bottleneck="lstm")}
L = 2048
METRIC = "taylor_squared_individual*n_filters/n_parameters"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool made these small ops 100x
    slower (this module took minutes in a six-worker run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return tconfig.CleanUMambaConfig(**dataclasses.asdict(jcfg))


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    clean = (rng.normal(size=(B, L)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    return clean, noisy


def _np_tree(tree):
    """numpy leaves in C order, as ``np.asarray`` gives a JAX array's."""
    return jax.tree_util.tree_map(np.ascontiguousarray, tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, numpy params, numpy grads) of the tiny mamba
    model; the gradient is the port's fp32 one on the CPU, handed to both
    packages as numpy."""
    jcfg = CleanUMambaConfig(**TINY)
    params = _np_tree(jm.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = _tcfg(jcfg)
    clean, noisy = _batch(0)
    grads, _ = make_grad_fn(tcfg, LossConfig(), bf16=False)(
        tparams.from_numpy(params, "cpu"), torch.from_numpy(clean[None]),
        torch.from_numpy(noisy[None]))
    return jcfg, tcfg, params, _np_tree(tparams.to_numpy(grads))


def _slices(g):
    return [dataclasses.asdict(s) for s in g.slices]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_groups_equal_jax(family):
    jcfg = CleanUMambaConfig(**FAMILIES[family])
    params = _np_tree(jm.init_params(jax.random.PRNGKey(1), jcfg))
    tg = tgroups.build_groups(tparams.from_numpy(params, "cpu"), _tcfg(jcfg))
    jg = jgroups.build_groups(params, jcfg)
    assert [(g.name, g.n_channels, _slices(g)) for g in tg] == \
        [(g.name, g.n_channels, _slices(g)) for g in jg]
    n_unet = 3 * jcfg.encoder_n_layers
    assert len(tg) == (n_unet if family != "mamba" else n_unet + 1 + 3 * jcfg.tsfm_n_layers)


def test_set_path_rebuilds_the_ports_containers(setup):
    _, _, params, _ = setup
    tree = tparams.from_numpy(params, "cpu")
    path = ("bottleneck", "layers", 1, "mixer", "x_proj")
    new = tgroups.set_path(tree, path, torch.zeros(3))
    assert tgroups.get_path(new, path).shape == (3,)
    assert tgroups.get_path(tree, path).shape == params["bottleneck"]["layers"][1]["mixer"][
        "x_proj"].shape
    assert isinstance(new["bottleneck"]["layers"], list)
    assert new["bottleneck"]["layers"] is not tree["bottleneck"]["layers"]
    assert new["encoder"] is tree["encoder"]  # untouched branches are shared


def test_host_array_takes_any_tensor():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for t in (x, x.to(torch.bfloat16), x.requires_grad_()):
        got = timp.host_array(t)
        assert got.dtype == np.float32 and np.array_equal(got, np.arange(6).reshape(2, 3))
    got = timp.host_array(x.t())  # C order, as np.asarray gives a JAX array
    assert got.flags["C_CONTIGUOUS"] and np.array_equal(got, np.arange(6).reshape(2, 3).T)
    assert np.array_equal(timp.host_array([1.0, 2.0]), np.array([1.0, 2.0]))


def test_importances_equal_jax(setup):
    """Every metric of every group from the same numpy params, grads and
    telemetry: exact equality."""
    jcfg, tcfg, params, grads = setup
    tp, tgr = tparams.from_numpy(params, "cpu"), tparams.from_numpy(grads, "cpu")
    rng = np.random.default_rng(3)
    groups = jgroups.build_groups(params, jcfg)
    telemetry = {s.telemetry_tap: np.abs(rng.normal(size=(
        s.n_heads * g.n_channels,))) for g in groups for s in g.slices if s.telemetry_tap}
    t_out = [timp.group_importances(tp, g, tgr, telemetry)
             for g in tgroups.build_groups(tp, tcfg)]
    j_out = [jimp.group_importances(params, g, grads, telemetry) for g in groups]
    for g, t, j in zip(groups, t_out, j_out):
        assert t.keys() == j.keys()
        for k in j:
            if isinstance(j[k], np.ndarray):
                assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), (g.name, k)
            else:
                assert t[k] == j[k], (g.name, k)
        for metric in (METRIC, "weight", "grad*2-taylor_group", "taylor_individual**0.5",
                       "weight/n_parameters+grad"):
            assert np.array_equal(timp.calc_importance(t, metric),
                                  jimp.calc_importance(j, metric)), (g.name, metric)


SELECTIONS = {
    "default": dict(perc_prune_channels_per_iter=0.05),
    "count": dict(n_prune_channels=24, min_channels_per_group=8),
    "importance_budget": dict(n_prune_channels=40, max_prune_importance_per_iter=1e-6,
                              min_channels_per_group=4),
    "calibrated": dict(n_prune_channels=20, calibration_scales={"d_inner0": 1e-3,
                                                                "encode_down_1": 50.0}),
    "act_var": dict(importance_metric="act_var", n_prune_channels=12, min_channels_per_group=4),
}


@pytest.mark.parametrize("case", sorted(SELECTIONS))
def test_get_prune_channels_equal_jax(setup, case):
    jcfg, tcfg, params, grads = setup
    kw = dict(SELECTIONS[case])
    metric = kw.pop("importance_metric", METRIC)
    rng = np.random.default_rng(4)
    groups = jgroups.build_groups(params, jcfg)
    telemetry = {s.telemetry_tap: np.abs(rng.normal(size=(
        s.n_heads * g.n_channels,))) for g in groups for s in g.slices if s.telemetry_tap}
    tp, tgr = tparams.from_numpy(params, "cpu"), tparams.from_numpy(grads, "cpu")
    tg = tgroups.build_groups(tp, tcfg)
    if metric == "act_var":  # only the groups with a telemetry point have it
        tg, groups = (_tapped(tg), _tapped(groups))
    got = timp.get_prune_channels(tg, tp, tgr, metric, telemetry=telemetry, **kw)
    want = jimp.get_prune_channels(groups, params, grads, metric, telemetry=telemetry, **kw)
    assert got == want
    sel = got[0]
    assert sum(len(v) for v in sel.values()) > 0
    assert all(len(v) % 8 == 0 for k, v in sel.items() if k.startswith("d_inner"))


def _tapped(groups):
    return [g for g in groups if any(s.telemetry_tap for s in g.slices)]


def _jax_adam(params, grads):
    """The JAX driver's optimizer chain after one update on ``grads``."""
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.scale_by_adam(),
                      optax.scale_by_learning_rate(lambda s: 1e-5))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    _, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
    return state


def _adam_of(state):
    """optax's ScaleByAdamState inside a chain's state tuple."""
    return next(s for s in state if isinstance(s, optax.ScaleByAdamState))


def _port_adam(state):
    """The port's Adam layout (``train/optim.py``) of an optax chain state."""
    adam = _adam_of(state)
    return {"count": int(adam.count), "mu": tparams.from_numpy(_np_tree(adam.mu), "cpu"),
            "nu": tparams.from_numpy(_np_tree(adam.nu), "cpu")}


def _selections(params, jcfg, grads):
    """A selection from ``get_prune_channels``, and one that prunes every
    group at once (x_proj's three groups in one call)."""
    groups = jgroups.build_groups(params, jcfg)
    sel, _, _ = jimp.get_prune_channels(groups, params, grads, METRIC,
                                        n_prune_channels=40, min_channels_per_group=4)
    rng = np.random.default_rng(5)
    every = {g.name: sorted(rng.choice(g.n_channels, size=min(8 if g.name.startswith(
        "d_inner") else 3, g.n_channels - 1), replace=False).tolist()) for g in groups}
    return {"selected": sel, "every_group": every}


@pytest.mark.parametrize("which", ["selected", "every_group"])
def test_apply_pruning_equal_jax(setup, which):
    """params, grads and the Adam moments pruned alike, bit for bit; the
    count kept; the trees handed in untouched."""
    jcfg, tcfg, params, grads = setup
    selection = _selections(params, jcfg, grads)[which]
    state = _jax_adam(params, grads)
    tp, tgr, tstate = (tparams.from_numpy(params, "cpu"), tparams.from_numpy(grads, "cpu"),
                       _port_adam(state))
    before = [x.clone() for x in tparams.tensor_leaves(tp)]
    p_t, g_t, s_t = tpruner.apply_pruning(tp, selection, tcfg, grads=tgr, opt_state=tstate)
    p_j, g_j, s_j = jpruner.apply_pruning(params, selection, jcfg, grads=grads,
                                          opt_state=state)
    adam_j = _adam_of(s_j)
    pairs = [(p_t, p_j), (g_t, g_j), (s_t["mu"], adam_j.mu), (s_t["nu"], adam_j.nu)]
    for t_tree, j_tree in pairs:
        t_leaves = jax.tree_util.tree_leaves(tparams.to_numpy(t_tree))
        j_leaves = jax.tree_util.tree_leaves(_np_tree(j_tree))
        assert len(t_leaves) == len(j_leaves)
        for a, b in zip(t_leaves, j_leaves):
            assert a.shape == b.shape and np.array_equal(a, b)
    assert s_t["count"] == int(adam_j.count) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, tparams.tensor_leaves(tp)))
    assert tm.count_params(p_t) == jm.count_params(p_j) < tm.count_params(tp)
    for g in tgroups.build_groups(p_t, tcfg):
        g.check(p_t)


def test_pruned_forward_matches_jax(setup):
    jcfg, tcfg, params, grads = setup
    selection = _selections(params, jcfg, grads)["every_group"]
    p_t, _, _ = tpruner.apply_pruning(tparams.from_numpy(params, "cpu"), selection, tcfg)
    _, noisy = _batch(7)
    with torch.no_grad():
        got = tm.forward(p_t, torch.from_numpy(noisy), tcfg).numpy()
    p_j, _, _ = jpruner.apply_pruning(params, selection, jcfg)
    want = np.asarray(jax.jit(lambda p, x: jm.forward(p, x, jcfg, scan_impl="xla"))(
        p_j, jnp.asarray(noisy)))
    assert got.shape == want.shape == noisy.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def telemetry_runs(setup):
    """Both packages' telemetry forward over three batches: (port runs as
    (output, taps, plain forward's output), JAX runs as (output, taps),
    {tap: conditioning}), the port's computed first.

    A tap's variance is ill-conditioned where a channel's mean dwarfs its
    spread (random weights: |mean| / std up to ~3,000 here): inputs that
    agree to a relative d move the variance by up to ~2 d |mean| std.  So
    each tap is held to 1e-5 of its largest value plus that term at
    d = 1e-7 (fp32 rounding), the largest over its channels and batches."""
    jcfg, tcfg, params, _ = setup
    tp = tparams.from_numpy(params, "cpu")
    xs = [_batch(10 + i)[1] for i in range(3)]
    port, cond = [], {}

    def moments(name, x):
        x = x.float().reshape(-1, x.shape[-1])
        term = float((2e-7 * x.mean(0).abs() * x.std(0, correction=0)).max())
        cond[name] = max(cond.get(name, 0.0), term)

    with torch.no_grad():
        for x in xs:
            y, taps = tm.forward_with_telemetry(tp, torch.from_numpy(x), tcfg)
            port.append((y, taps, tm.forward(tp, torch.from_numpy(x), tcfg)))
            tm.forward(tp, torch.from_numpy(x), tcfg, tap=moments)
    fn = jax.jit(lambda p, x: jm.forward_with_telemetry(p, x, jcfg))
    jax_out = [fn(params, jnp.asarray(x)) for x in xs]
    return port, [(np.asarray(y), _np_tree(t)) for y, t in jax_out], cond


def _tap_ok(got, want, cond):
    return np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + cond


def test_forward_with_telemetry_equals_forward_and_jax(setup, telemetry_runs):
    jcfg, _, _, _ = setup
    port, jax_out, cond = telemetry_runs
    for (y, taps, y_plain), (yj, tj) in zip(port, jax_out):
        assert torch.equal(y, y_plain)  # the taps change nothing on the main path
        assert np.abs(y.numpy() - yj).max() <= 1e-5 * np.abs(yj).max()
        assert taps.keys() == tj.keys()
        for name, v in taps.items():
            assert v.dtype == torch.float32 and v.shape == tj[name].shape, name
            assert _tap_ok(v.numpy(), tj[name], cond[name]), name
    names = set(port[0][1])
    D = jcfg.encoder_n_layers
    assert names == ({f"enc_conv_{i}" for i in range(D)} | {f"enc_out_{i}" for i in range(D)}
                     | {f"dec_mix_{j}" for j in range(D)} | {"d_model_in"}
                     | {f"d_inner_xz_{l}" for l in range(jcfg.tsfm_n_layers)})
    assert port[0][1]["d_inner_xz_0"].shape == (2 * jcfg.d_inner,)


def test_telemetry_accumulator_and_act_var_equal_jax(setup, telemetry_runs):
    """The running variances of both accumulators over the three batches
    agree as the taps do, and so does the act_var importance of every group
    (the selection by it, from the same accumulated telemetry, exactly)."""
    jcfg, tcfg, params, _ = setup
    port, jax_out, cond = telemetry_runs
    t_acc, j_acc = TAcc(), JAcc()
    for (_, taps, _), (_, tj) in zip(port, jax_out):
        t_acc.update(taps, n_samples=2)  # tensors: brought to the host inside
        j_acc.update(tj, n_samples=2)
    tv, jv = t_acc.as_dict(), j_acc.as_dict()
    assert tv.keys() == jv.keys() and t_acc.count == j_acc.count
    for k in jv:
        assert tv[k].dtype == np.float64 and _tap_ok(tv[k], jv[k], cond[k]), k
    tp = tparams.from_numpy(params, "cpu")
    for tg, jg in zip(tgroups.build_groups(tp, tcfg), jgroups.build_groups(params, jcfg)):
        a = timp.group_importances(tp, tg, telemetry=tv)["act_var"]
        b = jimp.group_importances(params, jg, telemetry=jv)["act_var"]
        assert (a is None) == (b is None), tg.name
        if b is not None:
            tap_cond = max(cond[s.telemetry_tap] for s in jg.slices if s.telemetry_tap)
            assert np.all(a >= 0) and _tap_ok(a, b, tap_cond), tg.name
    sel = timp.get_prune_channels(_tapped(tgroups.build_groups(tp, tcfg)), tp, None, "act_var",
                                  n_prune_channels=6, min_channels_per_group=4, telemetry=jv)
    assert sel == jimp.get_prune_channels(_tapped(jgroups.build_groups(params, jcfg)), params,
                                          None, "act_var", n_prune_channels=6,
                                          min_channels_per_group=4, telemetry=jv)
    t_acc.reset()
    assert t_acc.as_dict() == {} and t_acc.count == {}
