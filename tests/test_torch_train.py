"""PyTorch port of the training path vs the JAX package, on a tiny config.

Both packages get the same weights (JAX ``init_params`` -> numpy -> torch)
and the same numpy batches: schedule, one optimizer update against optax,
the fp32 gradient of the whole micro-loss against ``jax.value_and_grad``,
a whole train step against JAX ``make_train_step``, then the port's own
properties (accumulation, non-finite skip, remat, checkpoints, on-device
data, the CLI).  The JAX compiles are module-scoped fixtures.
"""

import dataclasses
import json
import pickle

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig, LossConfig, OptimizationConfig
from cleanumamba_tpu.losses import loss_fn as jax_loss_fn
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.train import trainer as jt
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu.train.schedule import linear_warmup_cosine_decay as jax_schedule
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.cli import train as tcli
from cleanumamba_tpu_torch.data.synth_device import synth_batch
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.train import checkpoint as tck
from cleanumamba_tpu_torch.train import optim as topt
from cleanumamba_tpu_torch.train import trainer as tt
from cleanumamba_tpu_torch.train.schedule import linear_warmup_cosine_decay

TINY = CleanUMambaConfig(channels_H=4, max_H=8, encoder_n_layers=3, tsfm_n_layers=2,
                         tsfm_d_model=16, tsfm_n_head=2, tsfm_d_inner=32)
L = 4096
LR = 1e-3
LOSS = LossConfig()


def _batch(seed, accum=1, B=2, nan=False):
    rng = np.random.default_rng(seed)
    clean = (rng.normal(size=(accum, B, L)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    if nan:
        noisy[0, 0, 100] = np.nan
    return clean, noisy


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _leaves(tree):
    """numpy leaves in one (sorted-key) order for either package's tree."""
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def weights():
    pj = jax.jit(jm.init_params, static_argnums=1)(jax.random.PRNGKey(0), TINY)
    pj = jax.tree_util.tree_map(np.asarray, pj)
    return pj, tparams.from_numpy(pj, "cpu")


def _opt_cfg(**kw):
    return OptimizationConfig(n_iters=1000, learning_rate=LR, **kw)


# --- schedule and optimizer ---

@pytest.mark.parametrize("step", [0, 49, 50, 51, 500, 999, 1200])
def test_schedule_matches_jax(step):
    got = linear_warmup_cosine_decay(1e-4, 1000)(step)
    want = float(jax_schedule(1e-4, 1000)(step))
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-6 * want


def _opt_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "layers": [{"k": (rng.normal(size=(3, 4, 2)) * scale).astype(np.float32)}]}


@pytest.mark.parametrize("name,grad_scale", [("adam", 1.0), ("adam", 100.0), ("adamw", 1.0)])
def test_optimizer_updates_match_optax(name, grad_scale):
    """Two updates (bias correction, the schedule's step), weight decay on,
    and with grad_scale 100 the global-norm clip active."""
    cfg = _opt_cfg(optimizer=name, weight_decay=0.1)
    sched = lambda s: 1e-3 * (s + 1)  # noqa: E731
    params = _opt_tree(0)
    grads = [_opt_tree(1, grad_scale), _opt_tree(2, grad_scale)]
    jopt = jt.make_optimizer(cfg, schedule=sched)
    topt_ = topt.make_optimizer(cfg, schedule=sched)
    js, ts = jopt.init(params), topt_.init(tparams.from_numpy(params, "cpu"))
    jp, tp = params, tparams.from_numpy(params, "cpu")
    for g in grads:
        ju, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt_.update(tparams.from_numpy(g, "cpu"), ts, tp)
        tp = topt.apply_updates(tp, tu)
        for a, b in zip(_leaves(tparams.to_numpy(tu)), _leaves(ju)):
            # fp32 rounding: optax takes the bias corrections in fp32
            np.testing.assert_allclose(a, b, rtol=5e-5, atol=1e-8)
    for a, b in zip(_leaves(tparams.to_numpy(tp)), _leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert ts["count"] == 2


# --- the step against JAX ---

@pytest.fixture(scope="module")
def jax_micro_grad(weights):
    pj, _ = weights
    clean, noisy = _batch(1)

    def micro(p):
        den = jm.forward(p, jnp.asarray(noisy[0]), TINY)
        return jax_loss_fn(den, jnp.asarray(clean[0]), LOSS)

    (loss, aux), g = jax.jit(jax.value_and_grad(micro, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pj))
    return (clean, noisy), float(loss), g


def test_micro_loss_gradient_matches_jax(weights, jax_micro_grad):
    """fp32: every leaf of the gradient to 1e-4 of that leaf's max |g|."""
    _, pt = weights
    batch, loss, gj = jax_micro_grad
    grads, aux = tt.make_grad_fn(TINY, LOSS, bf16=False)(pt, *_t(batch))
    assert abs(float(aux["loss"]) - loss) <= 1e-5 * abs(loss)
    got, want = _leaves(tparams.to_numpy(grads)), _leaves(gj)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.abs(b).max() > 0
        assert _rel_err(a, b) <= 1e-4


@pytest.fixture(scope="module")
def jax_steps(weights):
    """One JAX train step in fp32 and in bf16 from the same start."""
    pj, _ = weights
    out = {}
    for bf16 in (False, True):
        opt = jt.make_optimizer(_opt_cfg(bf16=bf16), schedule=lambda s: LR)
        step = jax.jit(jt.make_train_step(TINY, LOSS, opt, bf16=bf16))
        p = jax.tree_util.tree_map(jnp.asarray, pj)
        new_p, _, aux = step(p, opt.init(p), tuple(jnp.asarray(x) for x in _batch(2)))
        out[bf16] = (jax.tree_util.tree_map(np.asarray, new_p),
                     {k: float(v) for k, v in aux.items()})
    return out


def _port_step(pt, bf16=False, **kw):
    opt = topt.make_optimizer(_opt_cfg(bf16=bf16), schedule=lambda s: LR)
    step = tt.make_train_step(TINY, LOSS, opt, bf16=bf16, **kw)
    return step, opt


def test_train_step_matches_jax(weights, jax_steps):
    """fp32 step: aux to 1e-4; params to 2*lr (Adam's first update is
    ~lr*sign(g), so a near-zero gradient may flip the sign of its update)."""
    _, pt = weights
    step, opt = _port_step(pt)
    new_p, state, aux = step(pt, opt.init(pt), _t(_batch(2)))
    want_p, want_aux = jax_steps[False]
    for k in ("loss", "reconstruct", "stft_sc", "stft_mag", "grad_norm"):
        assert abs(float(aux[k]) - want_aux[k]) <= 1e-4 * abs(want_aux[k]), k
    assert bool(aux["grads_finite"]) and state["count"] == 1
    for a, b in zip(_leaves(tparams.to_numpy(new_p)), _leaves(want_p)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR)


def test_bf16_train_step_loss_matches_jax(weights, jax_steps):
    """bf16: every fp32 leaf and noisy cast to bf16, loss in fp32 (2e-2)."""
    _, pt = weights
    step, opt = _port_step(pt, bf16=True)
    new_p, _, aux = step(pt, opt.init(pt), _t(_batch(2)))
    want = jax_steps[True][1]
    for k in ("loss", "reconstruct", "stft_sc", "stft_mag"):
        assert abs(float(aux[k]) - want[k]) <= 2e-2 * abs(want[k]), k
    assert all(x.dtype == torch.float32 for x in tparams.tree_leaves(new_p))


# --- the port's own properties ---

def test_accumulation_is_the_mean_of_micro_steps(weights):
    _, pt = weights
    grad_fn = tt.make_grad_fn(TINY, LOSS, bf16=False)
    clean, noisy = _t(_batch(3, accum=2, B=1))
    g2, aux2 = grad_fn(pt, clean, noisy)
    parts = [grad_fn(pt, clean[i:i + 1], noisy[i:i + 1]) for i in range(2)]
    assert abs(float(aux2["loss"]) - (float(parts[0][1]["loss"]) + float(parts[1][1]["loss"])) / 2
               ) <= 1e-6 * float(aux2["loss"])
    for a, b, c in zip(tparams.tree_leaves(g2), tparams.tree_leaves(parts[0][0]),
                       tparams.tree_leaves(parts[1][0])):
        torch.testing.assert_close(a, (b + c) / 2, rtol=1e-5, atol=1e-8)


def test_nonfinite_step_is_skipped(weights):
    _, pt = weights
    step, opt = _port_step(pt, skip_nonfinite_updates=True)
    state = opt.init(pt)
    p1, s1, aux = step(pt, state, _t(_batch(4, nan=True)))
    assert not bool(aux["grads_finite"])
    # the values of params and opt_state, count included (torch.where, no host read)
    assert all(torch.equal(a, b) for a, b in zip(tparams.tree_leaves(p1),
                                                  tparams.tree_leaves(pt)))
    assert all(torch.equal(a, b) for a, b in zip(tparams.tensor_leaves(s1),
                                                  tparams.tensor_leaves(state)))
    assert s1["count"] == 0
    p2, s2, aux2 = step(pt, state, _t(_batch(4)))
    assert bool(aux2["grads_finite"]) and s2["count"] == 1
    assert any(not torch.equal(a, b) for a, b in zip(tparams.tree_leaves(p2),
                                                      tparams.tree_leaves(pt)))


def test_remat_equals_plain(weights):
    _, pt = weights
    batch = _t(_batch(5))
    g0, a0 = tt.make_grad_fn(TINY, LOSS, bf16=False)(pt, *batch)
    g1, a1 = tt.make_grad_fn(TINY, LOSS, bf16=False, remat=True)(pt, *batch)
    assert float(a0["loss"]) == float(a1["loss"])
    for a, b in zip(tparams.tree_leaves(g0), tparams.tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_checkpoint_round_trip_and_jax_reads_it(weights, tmp_path):
    """Port save -> port load (params, opt_state, config) and JAX
    load_checkpoint + forward on the port's checkpoint == port forward."""
    _, pt = weights
    step, opt = _port_step(pt)
    p1, s1, _ = step(pt, opt.init(pt), _t(_batch(6)))
    path = tck.save_checkpoint(str(tmp_path), 7, p1, s1, TINY, run_id="r",
                               training_time_seconds=1.5)
    assert tck.find_max_epoch(str(tmp_path)) == 7
    ck = tck.load_latest(str(tmp_path), "cpu")
    assert ck["iter"] == 7 and ck["run_id"] == "r"
    assert dataclasses.asdict(ck["config"]) == dataclasses.asdict(TINY)
    assert ck["opt_state"]["count"] == 1
    for a, b in zip(_leaves(ck["opt_state"]["mu"]), _leaves(tparams.to_numpy(s1["mu"]))):
        np.testing.assert_array_equal(a, b)
    jck = jax_load_checkpoint(path)
    assert jck["config"] == TINY
    x = _batch(7)[1][0]
    want = np.asarray(jm.forward(jax.tree_util.tree_map(jnp.asarray, jck["params"]),
                                 jnp.asarray(x), jck["config"]))
    got = tm.forward(tparams.from_numpy(ck["params"], "cpu"), torch.from_numpy(x), TINY)
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_synth_batch_on_device():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    clean, noisy = synth_batch(gen(), 3, 8000, snr_lo=5.0, snr_hi=10.0)
    assert clean.shape == noisy.shape == (3, 8000) and clean.dtype == torch.float32
    assert torch.isfinite(noisy).all()
    c2, n2 = synth_batch(gen(), 3, 8000, snr_lo=5.0, snr_hi=10.0)
    assert torch.equal(clean, c2) and torch.equal(noisy, n2)
    peak = clean.abs().amax(dim=1)
    assert (peak >= 0.2 - 1e-4).all() and (peak <= 0.8 + 1e-4).all()
    snr = 10 * torch.log10(clean.square().mean(1) / (noisy - clean).square().mean(1))
    assert (snr >= 5.0 - 1e-3).all() and (snr <= 10.0 + 1e-3).all()


def test_device_data_steps_train(weights):
    _, pt = weights
    step, opt = _port_step(pt)
    stepper = tt.make_device_data_steps(step, 1, L, 2)
    p, s, aux = stepper(pt, opt.init(pt), torch.Generator().manual_seed(0))
    assert s["count"] == 2 and bool(aux["grads_finite"])


def _cli_files(tmp_path, **log):
    exp = tmp_path / "exp.json"
    exp.write_text(json.dumps({"network": "CleanUMamba", "exp_path": "tiny",
                               "network_config": TINY.to_reference_json()}))
    cfg = json.loads(open("configs/train_synth.json").read())
    cfg["train_config"]["log"] = {"directory": str(tmp_path / "logs"), "ckpt_iter": "max",
                                  "iters_per_ckpt": 2, "iters_per_valid": 1000, **log}
    cfg["train_config"]["optimization"]["autocast"] = False
    cfg["trainset_config"] = {"crop_length_sec": 0.25}  # read at the top level
    conf = tmp_path / "config.json"
    conf.write_text(json.dumps(cfg))
    return ["-c", str(conf), "-e", str(exp), "--synthetic", "--log-every", "1",
            "--device", "cpu"]


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    args = _cli_files(tmp_path)
    tcli.main(args + ["--max-iters", "2"])
    out = capsys.readouterr().out
    assert "iter 0: loss=" in out and "gnorm=" in out and "iter 1: loss=" in out
    ck_dir = tmp_path / "logs" / "tiny" / "checkpoint"
    assert tck.find_max_epoch(str(ck_dir)) == 1
    tcli.main(args + ["--max-iters", "3", "--device-data", "1"])
    out = capsys.readouterr().out
    assert "resumed from iter 1" in out and "iter 2: loss=" in out
    ck = tck.load_checkpoint(str(ck_dir / "2.pkl"), "cpu")
    assert ck["opt_state"]["count"] == 3
    assert dataclasses.asdict(ck["config"]) == dataclasses.asdict(TINY)
    with open(ck_dir / "2.pkl", "rb") as f:
        assert pickle.load(f)["iter"] == 2


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """``--model-parallel 3`` at a world of 2 exits with JAX's "does not
    divide" error, before any process group is joined."""
    args = _cli_files(tmp_path)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        tcli.main(args + ["--model-parallel", "3"])
    assert "--model-parallel 3 does not divide 2 devices" in capsys.readouterr().err


def test_cli_validates_mid_run_and_logs_to_the_metrics_sink(tmp_path, capsys):
    """iters_per_valid inside the run: valid rows at iterations 2 and 4 (the
    second after a resume) in metrics.jsonl beside the train rows, one run
    id across the resume, as the JAX CLI writes them."""
    from cleanumamba_tpu_torch.utils import read_history

    log = {"iters_per_valid": 2, "valid_max_items": 1}
    args = _cli_files(tmp_path, **log)
    tcli.main(args + ["--max-iters", "3"])
    out = capsys.readouterr().out
    assert "iter 2: valid " in out and "pesq_wb=" in out
    tcli.main(args + ["--max-iters", "5", "--device-data", "1"])
    assert "iter 4: valid " in capsys.readouterr().out
    path = tmp_path / "logs" / "tiny" / "metrics.jsonl"
    rows = read_history(str(path))
    assert len({r["_run_id"] for r in rows}) == 1
    assert [r["_kind"] for r in rows].count("config") == 1
    valid = [r for r in rows if r["_kind"] == "valid"]
    assert [r["_step"] for r in valid] == [2, 4]
    assert all(np.isfinite(r["pesq_wb"]) and np.isfinite(r["si_sdr"]) for r in valid)
    train = [r["_step"] for r in rows if r["_kind"] == "train"]
    assert train == [0, 1, 2, 3, 4] and "loss" in rows[1] and "grad_norm" in rows[1]
    ck = tck.load_checkpoint(str(tmp_path / "logs" / "tiny" / "checkpoint" / "4.pkl"), "cpu")
    assert ck["run_id"] == rows[0]["_run_id"]
