"""The port's ``utils.py`` against the JAX package's: the metrics sink's JSONL
schema, appends, a torn last line and a resumed run's ``_runtime`` (the
sink cases of tests/test_metrics_sink.py), the records both packages write
and read alike, and the parameter and MAC counts."""

import json
import os

import numpy as np
import pytest

import jax
import torch

from cleanumamba_tpu import utils as jutils
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import utils as tutils


def test_schema_and_append(tmp_path):
    sink = tutils.MetricsLogger.for_run(str(tmp_path), config={"lr": 1e-4})
    sink.log({"loss": np.float32(1.5), "gnorm": torch.tensor(2.0)}, step=0)
    sink.log({"stoi": 0.9}, step=10, kind="valid")
    sink.close()
    path = os.path.join(str(tmp_path), "metrics.jsonl")
    rows = tutils.read_history(path)
    assert [r["_kind"] for r in rows] == ["config", "train", "valid"]
    for r in rows:
        assert r["_run_id"] == sink.run_id
        assert "_timestamp" in r and "_runtime" in r
    assert rows[0]["lr"] == 1e-4
    assert rows[1]["_step"] == 0 and rows[1]["loss"] == 1.5 and rows[1]["gnorm"] == 2.0
    assert tutils.read_history(path, kind="valid")[0]["stoi"] == 0.9


def test_torn_line_tolerated(tmp_path):
    sink = tutils.MetricsLogger.for_run(str(tmp_path))
    sink.log({"a": 1}, step=0)
    sink.close()
    path = os.path.join(str(tmp_path), "metrics.jsonl")
    with open(path, "a") as f:
        f.write('{"_run_id": "x", "b": ')  # a crash mid-write
    rows = tutils.read_history(path)
    assert len(rows) == 1 and rows[0]["a"] == 1


def test_resume_appends_same_run(tmp_path):
    s1 = tutils.MetricsLogger.for_run(str(tmp_path))
    s1.log({"a": 1}, step=0)
    s1.close()
    s2 = tutils.MetricsLogger.for_run(str(tmp_path), run_id=s1.run_id)
    s2.log({"a": 2}, step=1)
    s2.close()
    rows = tutils.read_history(os.path.join(str(tmp_path), "metrics.jsonl"), run_id=s1.run_id)
    assert [r.get("a") for r in rows] == [1, 2]
    assert rows[-1]["_runtime"] >= rows[0]["_runtime"]  # accumulates across the resume


def test_resume_dedupes_replayed_steps(tmp_path):
    """A resumed run replays the steps after its checkpoint; the last record
    of each (kind, step) is kept, in both packages' reading."""
    s1 = tutils.MetricsLogger.for_run(str(tmp_path))
    for step in range(3):
        s1.log({"loss": float(step)}, step=step)
    s1.close()
    s2 = tutils.MetricsLogger.for_run(str(tmp_path), run_id=s1.run_id)
    s2.log({"loss": 10.0}, step=2)
    s2.close()
    path = os.path.join(str(tmp_path), "metrics.jsonl")
    rows = tutils.read_history(path, kind="train")
    assert [(r["_step"], r["loss"]) for r in rows] == [(0, 0.0), (1, 1.0), (2, 10.0)]
    assert rows == jutils.read_history(path, kind="train")


@pytest.mark.parametrize("value", [1, 2.5, "s", None, True, [1, 2], {"k": 3},
                                   np.float32(1.5), np.arange(3), np.ones((1,))],
                         ids=lambda v: type(v).__name__)
def test_jsonable_equals_jax(value):
    assert tutils._jsonable(value) == jutils._jsonable(value)


@pytest.mark.parametrize("family", ["mamba", "mamba2", "mamba_s4", "lstm", "mha"])
def test_counts_equal_jax(family):
    """count_parameters skips the static tags (an S4 kernel's l_kernel) as
    JAX's does; the analytic MAC count is the JAX function's value."""
    jcfg = JaxConfig(bottleneck=family, channels_H=8, max_H=16, encoder_n_layers=4,
                     tsfm_n_layers=2, tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
    # mamba_s4's init draws host numpy from a traced key: it cannot be jitted
    init = jm.init_params if family == "mamba_s4" else jax.jit(jm.init_params, static_argnums=1)
    pj = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    pt = tparams.from_numpy(pj, "cpu")
    assert tutils.count_parameters(pt) == jutils.count_parameters(pj)
    for seconds in (1.0, 2.5):
        assert tutils.model_macs_torch_convention(pt, jcfg, seconds) == \
            jutils.model_macs_torch_convention(pj, jcfg, seconds)


def test_macs_of_the_pruned_checkpoint_equal_jax():
    from cleanumamba_tpu.train.checkpoint import load_checkpoint

    ref = load_checkpoint("artifacts/pruned_473k_finetuned.pkl")
    cfg, pt = tparams.load_checkpoint("artifacts/pruned_473k_finetuned.pkl", "cpu")
    assert tutils.model_macs_torch_convention(pt, cfg) == \
        jutils.model_macs_torch_convention(ref["params"], ref["config"])


def test_the_port_reads_the_jax_sinks_file(tmp_path):
    """Both packages write the same schema into one file; each reads the
    other's rows."""
    j = jutils.MetricsLogger.for_run(str(tmp_path), config={"a": 1})
    j.log({"loss": 1.0}, step=0)
    j.close()
    t = tutils.MetricsLogger.for_run(str(tmp_path), run_id=j.run_id)
    t.log({"loss": 0.5}, step=1)
    t.close()
    path = os.path.join(str(tmp_path), "metrics.jsonl")
    assert tutils.read_history(path) == jutils.read_history(path)
    with open(path) as f:
        kinds = [json.loads(line)["_kind"] for line in f]
    assert kinds == ["config", "train", "train"]  # the resume wrote no second config row
