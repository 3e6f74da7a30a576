"""The port's prune-train driver (``cleanumamba_tpu_torch/prune/driver.py``)
and calibrator against the JAX package's, on the tiny config of
``tests/test_prune_driver.py``.

The pipeline runs two prune events and two Adam steps in each package on
the same weights and batches.  The selections there come from each
package's own gradient, which differ by ~1e-7: before the records are
compared, the test asserts that both packages order every importance value
the selection reads the same way, so that a flip shows as a near-tie and
not as a flake.  The port runs before JAX.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig
from cleanumamba_tpu.config import LossConfig as JLoss
from cleanumamba_tpu.config import STFTLossConfig as JSTFT
from cleanumamba_tpu.losses import loss_fn as jax_loss_fn
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.prune import calibrate as jcal
from cleanumamba_tpu.prune import driver as jd
from cleanumamba_tpu.prune import groups as jgroups
from cleanumamba_tpu.prune import importance as jimp
from cleanumamba_tpu_torch import config as tconfig
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.losses import loss_fn as torch_loss_fn
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.prune import calibrate as tcal
from cleanumamba_tpu_torch.prune import driver as td
from cleanumamba_tpu_torch.prune import groups as tgroups
from cleanumamba_tpu_torch.prune import importance as timp
from cleanumamba_tpu_torch.train.trainer import make_grad_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels_H=16, max_H=32, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=32, tsfm_d_inner=64)
L = 2048
STFT = dict(fft_sizes=(256,), hop_sizes=(64,), win_lengths=(128,))
# the JAX package's pipeline test (tests/test_prune_driver.py), with the
# calibration on: 2 batches of gradient per prune, events at iterations 1
# and 3, Adam steps at 4 and 5
PHASES = dict(training_samples=8, pruning_grad_samples=4, pruning_repeats=2, prune_steps=6,
              steps_per_valid=1000, steps_per_ckpt=1000, perc_prune_channels_per_iter=0.02,
              max_prune_importance_per_iter=None, min_channels_per_group=4, calibration=True,
              steps_per_calibration=1, min_total_channels=10)
MAX_ITERS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool made these small ops 100x
    slower (this module took minutes in a six-worker run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed):
    jcfg = CleanUMambaConfig(**TINY)
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tconfig.CleanUMambaConfig(**dataclasses.asdict(jcfg)), params


def _data(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        clean = (rng.normal(size=(2, L)) * 0.3).astype(np.float32)
        noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
        yield clean, noisy


# --- the phase machine ---

GRID = [(2, 8, 4, 2, 2, 4, 2), (2, 256, 32, 5, 10, 10, 20), (4, 16, 8, 3, 3, 6, 1),
        (1, 3, 2, 1, 4, 2, 5)]


@pytest.mark.parametrize("args", GRID, ids=lambda a: "-".join(map(str, a)))
def test_get_state_equals_jax(args):
    batch, train, grad, repeats, valid, ckpt, calib = args
    iters = 3 * (grad + train) * repeats // batch + 5
    for n in range(iters):
        assert td.get_state(n, *args) == jd.get_state(n, *args), n


@pytest.mark.parametrize("args,match", [
    ((0, 3, 9, 4, 2, 2, 4, 2), "pruning_grad_samples"),
    ((0, 2, 7, 4, 2, 2, 4, 2), "training_samples"),
    ((0, 2, 8, 4, 3, 2, 4, 2), "steps_per_valid"),
])
def test_get_state_rejects_misphased_configs(args, match):
    for get_state in (td.get_state, jd.get_state):
        with pytest.raises(ValueError, match=match):
            get_state(*args)


@pytest.mark.parametrize("config", ["prune_e8_synth", "prune_2m_synth"])
def test_calibration_never_finds_gradients_to_calibrate_on(config):
    """Shared with the reference: the calibrator runs only where a macro
    step's first iteration finds gradients accumulated, and the phase
    machine empties them at every prune before that iteration comes.  Over
    20,000 iterations of the shipped configs' phases (batch 2), neither
    package's get_state leaves one such iteration."""
    with open(os.path.join(ROOT, "configs", f"{config}.json")) as f:
        pc = td.PruningConfig(**json.load(f)["pruning_config"])
    for get_state in (td.get_state, jd.get_state):
        grad_batches = calibrations = 0
        for n in range(20_000):
            s = get_state(n, 2, pc.training_samples, pc.pruning_grad_samples,
                          pc.pruning_repeats, pc.steps_per_valid, pc.steps_per_ckpt,
                          pc.steps_per_calibration)
            calibrations += s["calibrate"] and grad_batches > 0
            if s["pruning"]:
                grad_batches = 0 if s["go_prune"] else grad_batches + 1
        assert calibrations == 0


# --- the pipeline against JAX's ---

def _spy(monkeypatch, driver, imp, store):
    """Record, at each prune event, every group's importance vector as the
    driver's get_prune_channels sees it."""
    real = driver.get_prune_channels

    def spy(groups, params, grads, metric, **kw):
        store.append({g.name: np.asarray(imp.calc_importance(
            imp.group_importances(params, g, grads), metric), np.float64) for g in groups})
        return real(groups, params, grads, metric, **kw)

    monkeypatch.setattr(driver, "get_prune_channels", spy)


def _assert_same_order(vt, vj, n_read):
    """Both packages order alike every value the selection reads: each
    group's ``n_read`` smallest by either vector.  Equal values (a dead
    channel's exact 0 in both) compare alike."""
    idx = {k: np.union1d(np.argsort(vj[k])[:n_read], np.argsort(vt[k])[:n_read]) for k in vj}
    a = np.concatenate([vt[k][i] for k, i in idx.items()])
    b = np.concatenate([vj[k][i] for k, i in idx.items()])
    flips = np.argwhere(np.sign(a[:, None] - a[None, :]) != np.sign(b[:, None] - b[None, :]))
    dev = np.abs(a - b).max() / np.abs(b).max()
    assert not len(flips), (
        f"near-tie at the cut: {len(flips) // 2} pairs of importances order differently in the "
        f"two packages (e.g. port {a[flips[0]]} vs JAX {b[flips[0]]}; largest deviation "
        f"{dev:.2e} of the largest value)")


def test_pipeline_matches_jax(monkeypatch, tmp_path):
    """Two prune events and two Adam steps: the same records (pruned counts,
    params, channels, phase counters), losses within 1e-4 relative, no
    calibration record in either, and every parameter within 1e-4 of
    max(its leaf's largest value, 1e-3 of the model's largest): a leaf
    that starts at 0 (the norms' biases) holds only its Adam updates, whose
    ratio m / sqrt(v) of small, sign-changing gradients moves ~1.5e-4 of
    its ~2e-5 between the packages' fp32 gradients."""
    jcfg, tcfg, params = _weights(0)
    logs = {"port": [], "jax": []}
    vecs = {"port": [], "jax": []}
    _spy(monkeypatch, td, timp, vecs["port"])
    _spy(monkeypatch, jd, jimp, vecs["jax"])
    p_t, s_t, h_t, stop_t = td.pruning_pipeline(
        tparams.from_numpy(params, "cpu"), tcfg,
        tconfig.LossConfig(stft_config=tconfig.STFTLossConfig(**STFT)), _data(),
        td.PruningConfig(**PHASES), batch_size=2, max_iters=MAX_ITERS,
        log_fn=logs["port"].append, log_every=1, ckpt_dir=str(tmp_path / "port"))
    p_j, s_j, h_j, stop_j = jd.pruning_pipeline(
        params, jcfg, JLoss(stft_config=JSTFT(**STFT)), _data(), jd.PruningConfig(**PHASES),
        batch_size=2, max_iters=MAX_ITERS, log_fn=logs["jax"].append, log_every=1)

    assert len(vecs["port"]) == len(vecs["jax"]) == 2
    for vt, vj in zip(vecs["port"], vecs["jax"]):
        total = sum(len(v) for v in vj.values())
        n_prune = max(4, int(total * PHASES["perc_prune_channels_per_iter"]))
        _assert_same_order(vt, vj, n_prune + 1)
    assert stop_t == stop_j is None
    assert len(h_t) == len(h_j) == 2
    for a, b in zip(h_t, h_j):
        assert {k: v for k, v in a.items() if k != "loss"} == \
            {k: v for k, v in b.items() if k != "loss"}
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    assert h_t[1]["params"] < h_t[0]["params"] < tm.count_params(tparams.from_numpy(params,
                                                                                     "cpu"))
    kinds = [[r["kind"] for r in logs[k]] for k in ("port", "jax")]
    assert kinds[0] == kinds[1] == ["prune", "prune", "train", "train"]
    for a, b in zip(logs["port"][2:], logs["jax"][2:]):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]) and a["lr"] == b["lr"]
    t_leaves = jax.tree_util.tree_leaves(tparams.to_numpy(p_t))
    j_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(p_j)]
    floor = 1e-3 * max(np.abs(x).max() for x in j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), floor)
    assert s_t["count"] == 2 and tparams.tensor_leaves(s_t["mu"])[0].shape == \
        tparams.tensor_leaves(p_t)[0].shape
    for g in tgroups.build_groups(p_t, tcfg):
        g.check(p_t)
    assert not (tmp_path / "port").exists()  # steps_per_ckpt not reached


def test_pipeline_calibrates_never_and_resumes(monkeypatch, tmp_path):
    """The port's loop over three macro steps with the calibration on at
    every one: the calibrator is never called; the selections get no
    scales (``{}``); a checkpoint at each macro step's end resumes with the
    Adam count it saved."""
    _, tcfg, params = _weights(2)
    calls, scales = [], []
    monkeypatch.setattr(tcal.Calibrator, "gather", lambda *a, **k: calls.append(1))
    real = td.get_prune_channels

    def spy(*a, **kw):
        scales.append(kw["calibration_scales"])
        return real(*a, **kw)

    monkeypatch.setattr(td, "get_prune_channels", spy)
    phases = dict(PHASES, training_samples=2, pruning_grad_samples=2, pruning_repeats=1,
                  steps_per_calibration=1, steps_per_ckpt=1, steps_per_valid=1)
    loss_cfg = tconfig.LossConfig(stft_config=tconfig.STFTLossConfig(**STFT))
    ck = str(tmp_path)
    valid = []
    _, state, hist, _ = td.pruning_pipeline(
        tparams.from_numpy(params, "cpu"), tcfg, loss_cfg, _data(1), td.PruningConfig(**phases),
        batch_size=2, max_iters=6, ckpt_dir=ck, run_id="r",
        validate_fn=lambda p: valid.append(tm.count_params(p)) or {"stoi": 1.0})
    assert calls == [] and scales == [{}, {}, {}] and len(hist) == 3
    assert sorted(os.listdir(ck)) == ["1.pkl", "3.pkl", "5.pkl"]
    assert len(valid) == 6  # every prune and every macro step's end (steps_per_valid 1)
    from cleanumamba_tpu_torch.train.checkpoint import load_checkpoint

    saved = load_checkpoint(os.path.join(ck, "3.pkl"), "cpu")
    assert saved["opt_state"]["count"] == 2 and saved["run_id"] == "r"
    _, state2, hist2, _ = td.pruning_pipeline(
        saved["params"], tcfg, loss_cfg, _data(1), td.PruningConfig(**phases), batch_size=2,
        max_iters=6, start_iter=4, opt_state=saved["opt_state"])
    assert state2["count"] == state["count"] == 3 and len(hist2) == 1


def test_log_macs_raises():
    _, tcfg, params = _weights(0)
    with pytest.raises(ValueError, match="log_macs"):
        td.pruning_pipeline(tparams.from_numpy(params, "cpu"), tcfg, tconfig.LossConfig(),
                            _data(), td.PruningConfig(), batch_size=2, log_macs=True)


# --- the calibrator ---

def test_calibrator_gather_matches_jax():
    """Four groups' loss-change scales, and their EMA over a second gather.
    A scale is (loss after - loss before) / importance, and a probe can move
    the loss by 4e-4 of itself, where the packages' fp32 losses (~1e-7
    apart) differ by ~3e-4 of the change: so both calibrators get the same
    loss function (the port's forward, on the tree each one probes) and
    must agree exactly, and JAX's own loss on the unpruned tree and on a
    pruned one is held to the port's within 1e-5 relative."""
    jcfg, tcfg, params = _weights(1)
    rng = np.random.default_rng(1)
    clean = (rng.normal(size=(2, L)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    loss_t = tconfig.LossConfig(stft_lambda=0.0)
    tp = tparams.from_numpy(params, "cpu")
    ct, nt = torch.from_numpy(clean), torch.from_numpy(noisy)
    grads, _ = make_grad_fn(tcfg, loss_t, bf16=False)(tp, ct[None], nt[None])
    grads = jax.tree_util.tree_map(np.ascontiguousarray, tparams.to_numpy(grads))

    def sampler_t(p):
        with torch.no_grad():
            return float(torch_loss_fn(tm.forward(p, nt, tcfg), ct, loss_t)[0])

    probed = []

    def sampler_j(p):  # the port's loss on the tree JAX's calibrator probes
        tree = jax.tree_util.tree_map(np.asarray, p)
        loss = sampler_t(tparams.from_numpy(tree, "cpu"))
        probed.append((tree, loss))
        return loss

    metric = "taylor_squared_individual*n_filters/n_parameters"
    cal_t, cal_j = tcal.Calibrator(ema_factor=0.5), jcal.Calibrator(ema_factor=0.5)
    groups_t = tgroups.build_groups(tp, tcfg)[:4]
    groups_j = jgroups.build_groups(params, jcfg)[:4]
    for _ in range(2):
        got = cal_t.gather(tp, tcfg, tparams.from_numpy(grads, "cpu"), groups_t, sampler_t,
                           metric)
        want = cal_j.gather(params, jcfg, grads, groups_j, sampler_j, metric)
        assert got == want and len(want) >= 3  # a group whose selection weighs 0 is skipped
    assert cal_t.as_dict() == cal_j.as_dict()
    assert all(v >= cal_t.min_scale for v in cal_t.scales.values())
    assert cal_t.scale_for("nope") == cal_j.scale_for("nope") == 36.0

    loss_j = JLoss(stft_lambda=0.0)
    jax_loss = jax.jit(lambda p: jax_loss_fn(jm.forward(p, jnp.asarray(noisy), jcfg),
                                             jnp.asarray(clean), loss_j)[0])
    for tree, port_loss in probed[:2]:  # the baseline and a pruned tree: one compile each
        assert abs(float(jax_loss(tree)) - port_loss) <= 1e-5 * abs(port_loss)
