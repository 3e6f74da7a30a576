"""The port's prune, finetune and calibrate CLIs on the CPU, on a tiny
teacher: what each writes, a resume under one run id, and a pruned (ragged)
checkpoint that the JAX package loads and runs as the port does."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import config as tconfig
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.cli import calibrate as tcalibrate
from cleanumamba_tpu_torch.cli import finetune as tfinetune
from cleanumamba_tpu_torch.cli import prune as tprune
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.prune.groups import build_groups
from cleanumamba_tpu_torch.train import checkpoint as tck
from cleanumamba_tpu_torch.utils import read_history

TINY = dict(channels_H=16, max_H=32, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=32, tsfm_d_inner=64)
CROP = "0.25"
# a macro step of 4 iterations: 2 batches of gradient, a prune at the second,
# then 2 Adam steps; validation in prune step 1 (iterations 5 and 7)
PHASES = dict(training_samples=4, pruning_grad_samples=4, pruning_repeats=1, prune_steps=10,
              steps_per_valid=2, steps_per_ckpt=1000, perc_prune_channels_per_iter=0.05,
              max_prune_importance_per_iter=None, min_channels_per_group=4, stoi_stop=0.0,
              min_total_channels=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool made these small ops 100x
    slower (this module took minutes in a six-worker run, seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(tree):
    return [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def pruned(tmp_path_factory):
    """The prune CLI to iteration 2, then resumed to 8: (tmp dir, teacher
    path, the two runs' stdout, the final checkpoint's path)."""
    tmp = tmp_path_factory.mktemp("prune")
    cfg = tconfig.CleanUMambaConfig(**TINY)
    teacher = tck.save_checkpoint(str(tmp / "teacher"), 0,
                                  tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                                  None, cfg)
    exp = tmp / "exp.json"
    exp.write_text(json.dumps({"network": "CleanUMamba", "exp_path": "p",
                               "pruning_config": PHASES}))
    base = ["-t", teacher, "-e", str(exp), "--synthetic", "--crop-sec", CROP, "--out",
            str(tmp / "out"), "--device", "cpu"]
    outs = []
    for max_iters in (2, 8):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tprune.main(base + ["--max-iters", str(max_iters)])
        outs.append(buf.getvalue())
    ck_dir = tmp / "out" / "p" / "checkpoint"
    return tmp, teacher, outs, str(ck_dir / f"{tck.find_max_epoch(str(ck_dir))}.pkl")


def test_prune_cli_prunes_resumes_and_logs_one_run(pruned):
    tmp, teacher, outs, final = pruned
    assert "teacher:" in outs[0] and "resumed pruning from iter 1" in outs[1]
    ck_dir = os.path.dirname(final)
    assert sorted(os.listdir(ck_dir)) == ["1.pkl", "5.pkl"]  # each run's final prune
    rows = read_history(str(tmp / "out" / "p" / "metrics.jsonl"))
    assert len({r["_run_id"] for r in rows}) == 1
    kinds = [(r["_kind"], r.get("_step")) for r in rows if r["_kind"] != "config"]
    assert kinds == [("prune", 1), ("summary", None), ("prune", 5), ("valid", 5), ("valid", 7),
                     ("summary", None)]
    assert all(np.isfinite(r["si_sdr"]) for r in rows if r["_kind"] == "valid")
    summaries = [r for r in rows if r["_kind"] == "summary"]
    assert len(summaries) == 2 and summaries[0]["final_params"] > summaries[1]["final_params"]
    ck = tck.load_checkpoint(final, "cpu")
    assert ck["iter"] == 5 and ck["opt_state"]["count"] == 4  # Adam steps at 2, 3, 6, 7
    assert tm.count_params(ck["params"]) == summaries[1]["final_params"]


def test_pruned_checkpoint_loads_and_runs_in_jax(pruned):
    """The port's ragged checkpoint through JAX's ``load_checkpoint``: the
    same shapes and a forward within 1e-5 of the port's."""
    _, teacher, _, final = pruned
    cfg_t, p_t = tparams.load_checkpoint(final, "cpu")
    ck = jax_load_checkpoint(final)
    assert isinstance(ck["config"], CleanUMambaConfig) and ck["config"].bottleneck == "mamba"
    assert _shapes(tparams.to_numpy(p_t)) == _shapes(ck["params"])
    assert _shapes(ck["params"]) != _shapes(jax_load_checkpoint(teacher)["params"])
    for g in build_groups(p_t, cfg_t):
        g.check(p_t)
    x = (np.random.default_rng(3).normal(size=(1, 4000)) * 0.3).astype(np.float32)
    with torch.no_grad():
        got = tm.forward(p_t, torch.from_numpy(x), cfg_t).numpy()
    params = jax.tree_util.tree_map(jnp.asarray, ck["params"])
    want = np.asarray(jax.jit(lambda p, v: jm.forward(p, v, ck["config"], scan_impl="xla"))(
        params, jnp.asarray(x)))
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("extra", [["--iters", "2", "--log-every", "1"],
                                   ["--iters", "2", "--device-data", "2", "--log-every", "2"]],
                         ids=["loader", "device-data"])
def test_finetune_cli_keeps_every_ragged_shape(pruned, tmp_path, extra, capsys):
    _, _, _, final = pruned
    out = tmp_path / "ft" / "checkpoint"
    tfinetune.main(["--ckpt", final, "--synthetic", "--crop-sec", CROP, "--out", str(out),
                    "--device", "cpu"] + extra)
    assert "finetuning" in capsys.readouterr().out
    assert os.listdir(out) == ["1.pkl"]
    before, after = tck.load_checkpoint(final, "cpu"), tck.load_checkpoint(str(out / "1.pkl"),
                                                                          "cpu")
    assert _shapes(tparams.to_numpy(after["params"])) == \
        _shapes(tparams.to_numpy(before["params"]))
    assert after["opt_state"]["count"] == 2 and after["iter"] == 1
    changed = [not torch.equal(a, b) for a, b in zip(tparams.tensor_leaves(after["params"]),
                                                     tparams.tensor_leaves(before["params"]))]
    assert all(changed)
    assert _shapes(jax_load_checkpoint(str(out / "1.pkl"))["params"]) == \
        _shapes(tparams.to_numpy(after["params"]))
    rows = read_history(str(tmp_path / "ft" / "metrics.jsonl"))
    assert [r["_step"] for r in rows if r["_kind"] == "train"] == \
        ([0, 1] if "--device-data" not in extra else [1])
    assert all(np.isfinite(r["loss"]) for r in rows if r["_kind"] == "train")


def test_calibrate_cli_writes_its_rows(pruned, tmp_path, capsys):
    _, _, _, final = pruned
    tcalibrate.main(["--ckpt", final, "--n-batches", "1", "--crop-sec", CROP,
                     "--sample-size", "1", "--n-remove", "2", "--out", str(tmp_path),
                     "--device", "cpu"])
    cfg, params = tparams.load_checkpoint(final, "cpu")
    n_groups = len(build_groups(params, cfg))
    assert f"{n_groups} probes" in capsys.readouterr().out
    rows = read_history(str(tmp_path / "metrics.jsonl"))
    assert len(rows) == n_groups
    assert {r["_kind"] for r in rows} == {"calibration_experiment"}
    for r in rows:
        assert 1 <= len(r["remove_index"]) <= 2 and np.isfinite(r["loss_change"])
        assert r["weight_imp"] > 0 and r["taylor_ind_imp"] is not None
