"""Tensor parallelism of the port (``parallel/tensor.py``, the model axis of
``parallel/mesh.py`` and ``cli/train.py --model-parallel``) on the CPU,
against the JAX package's ``parallel/tensor.py``.

The layout functions are held to JAX's leaf for leaf, exactly, in process.
The forward, gradient and train step run at two gloo ranks, each a
subprocess of ``tests/torch_parallel_worker.py`` (no JAX there), started
once for the file; JAX's side runs here (``tests/conftest.py`` gives JAX 8
CPU devices).  Weights are made once by JAX's ``init_params``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JMesh

from cleanumamba_tpu.config import CleanUMambaConfig as JCfg
from cleanumamba_tpu.config import LossConfig as JLoss
from cleanumamba_tpu.config import OptimizationConfig as JOpt
from cleanumamba_tpu.losses import loss_fn as jax_loss_fn
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.parallel import tensor as jt
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu.train.trainer import make_optimizer as jax_make_optimizer
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.cli import train as tcli
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.parallel import mesh_layout
from cleanumamba_tpu_torch.parallel import tensor as tt
from cleanumamba_tpu_torch.train.optim import make_optimizer
from cleanumamba_tpu_torch.train.trainer import make_train_step
from torch_parallel_worker import ROOT, TIMEOUT, env, free_port, launch

TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32, normalize_input=False)
FAMILIES = {
    "mamba": {},
    "mamba2": {"bottleneck": "mamba2"},
    "mamba_s4": {"bottleneck": "mamba_s4"},
    "mha": {"bottleneck": "mha", "tsfm_n_head": 4},  # whole heads on 4 ranks too
    "mamba_bypass4_normalized": {"bypass_channels": 4, "normalize_input": True},
}
L = 801
L_TRAIN = 4096  # the default loss' STFT (512..2048-point) needs a longer crop
# the gradient check's loss: the squared error alone.  The STFT loss's log
# magnitudes amplify summation order: on this model one process of the port
# and JAX's differ by up to 7e-4 of a small leaf's max before any TP
GRAD_LOSS = dict(ell_p=2, stft_lambda=0.0)
# Adam with eps 1.0 (its first update lr * g / (|g| + eps) is smooth in g) and
# a learning rate at which one step moves the weights past the tolerance
OPT = dict(n_iters=100, learning_rate=3e-2, eps=1.0, bf16=False, clip_grad_norm_max=10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name):
    return JCfg(**{**TINY, **FAMILIES[name]})


def _weights(name, seed=0):
    """JAX's init (mamba_s4 attuned to L) as a numpy tree."""
    cfg = _jcfg(name)
    p = jm.init_params(jax.random.PRNGKey(seed), cfg)
    if cfg.bottleneck == "mamba_s4":
        p = jm.prepare_for_length(p, cfg, L)
    return jax.tree_util.tree_map(np.asarray, p)


def _pcfg(jcfg):
    return CleanUMambaConfig(**dataclasses.asdict(jcfg))


def _leaves(tree):
    """The array leaves of either package's tree, in JAX's (sorted-key) order."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)
            if isinstance(x, (np.ndarray, jax.Array))]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("model",))


# --------------------------------------------------------------------------
# Layout, in process
# --------------------------------------------------------------------------

def _spec_dims(specs):
    """JAX's PartitionSpecs as "the dim sharded on, or None"."""
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return [next((i for i, e in enumerate(s) if e is not None), None)
            for s in jax.tree_util.tree_leaves(specs, is_leaf=is_p)]


def _port_spec_dims(tree, specs):
    """The port's specs of the array leaves, in JAX's order."""
    pairs = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x, s: (x, s), tree, specs,
                               is_leaf=lambda x: x is None or isinstance(x, torch.Tensor)),
        is_leaf=lambda x: isinstance(x, tuple))
    return [s for x, s in pairs if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["mamba", "mamba2", "mamba_s4", "mha"])
def test_layout_functions_equal_jax_exactly(name, n):
    """tp_prepare (leaves and shard dims), tp_unprepare, tp_permute_like both
    ways and tp_opt_state_like both ways: every leaf bitwise JAX's, and the
    round trips give back the canonical tree."""
    jcfg, cfg = _jcfg(name), _pcfg(_jcfg(name))
    w = _weights(name)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    p = tparams.from_numpy(w, "cpu")

    j_tp, j_specs = jt.tp_prepare(jp, jcfg, n)
    t_tp, t_specs = tt.tp_prepare(p, cfg, n)
    for a, b in zip(_leaves(j_tp), _leaves(tparams.to_numpy(t_tp)), strict=True):
        assert np.array_equal(a, b)
    assert _spec_dims(j_specs) == _port_spec_dims(t_tp, t_specs)

    for inverse, src_j, src_t in ((False, jp, p), (True, j_tp, t_tp)):
        a = jt.tp_permute_like(src_j, jcfg, n, inverse)
        b = tt.tp_permute_like(src_t, cfg, n, inverse)
        for x, y in zip(_leaves(a), _leaves(tparams.to_numpy(b)), strict=True):
            assert np.array_equal(x, y)
    back = tparams.to_numpy(tt.tp_unprepare(t_tp, cfg, n))
    for x, y in zip(_leaves(back), _leaves(w), strict=True):
        assert np.array_equal(x, y)
    assert np.array_equal(_leaves(back)[0], _leaves(jt.tp_unprepare(j_tp, jcfg, n))[0])

    # the moments: random leaves in the params' structure, as in JAX's test
    rng = np.random.default_rng(6)
    rand = jax.tree_util.tree_map(
        lambda x: rng.normal(size=np.shape(x)).astype(np.float32)
        if isinstance(x, np.ndarray) else x, w)
    j_state = jax_make_optimizer(JOpt(n_iters=10)).init(jp)
    pdef = jax.tree_util.tree_structure(jp)
    is_pl = lambda x: jax.tree_util.tree_structure(x) == pdef  # noqa: E731
    j_state = jax.tree_util.tree_map(
        lambda x: jax.tree_util.tree_map(jnp.asarray, rand) if is_pl(x) else x, j_state,
        is_leaf=lambda x: is_pl(x) if not isinstance(x, jnp.ndarray) else False)
    r = tparams.from_numpy(rand, "cpu")
    t_state = {"count": 3, "mu": r, "nu": r}
    j_fwd = jt.tp_opt_state_like(j_state, jp, jcfg, n)
    t_fwd = tt.tp_opt_state_like(t_state, p, cfg, n)
    j_mu = next(x.mu for x in j_fwd if hasattr(x, "mu"))
    for x, y in zip(_leaves(j_mu), _leaves(tparams.to_numpy(t_fwd["mu"])), strict=True):
        assert np.array_equal(x, y)
    t_back = tt.tp_opt_state_like(t_fwd, t_tp, cfg, n, inverse=True)
    assert t_back["count"] == 3
    for x, y in zip(_leaves(tparams.to_numpy(t_back["nu"])), _leaves(rand), strict=True):
        assert np.array_equal(x, y)


def _refusal(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case", ["lstm", "groups", "kernel", "indivisible"])
def test_refusals_match_jax(case):
    """The same exception type and message as JAX's tp_prepare: LSTM, grouped
    encoder convs, K != 2S, and widths that do not split over the ranks."""
    kw, n = {"lstm": ({"bottleneck": "lstm"}, 2), "groups": ({"encoder_groups": 2}, 2),
             "kernel": ({"kernel_size": 6}, 2), "indivisible": ({}, 3)}[case]
    jcfg = JCfg(**{**TINY, **kw})
    w = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1), jcfg))
    want = _refusal(lambda: jt.tp_prepare(jax.tree_util.tree_map(jnp.asarray, w), jcfg, n))
    got = _refusal(lambda: tt.tp_prepare(tparams.from_numpy(w, "cpu"), _pcfg(jcfg), n))
    assert got == want
    assert want[0] is (ValueError if case == "indivisible" else NotImplementedError)


def test_group_layout_matches_jax_reshape():
    """At 4 ranks with a model axis of 2 (and of 4, 1): the model rows and
    data columns are the rows and columns of JAX's devices reshaped to
    (data, model), rank r at data r // M, model r % M."""
    for m in (1, 2, 4):
        devs = np.array(jax.devices()[:4]).reshape(4 // m, m)
        ids = np.vectorize(lambda d: d.id)(devs)
        rows, cols = mesh_layout(4, m)
        assert rows == ids.tolist() and cols == ids.T.tolist()
    with pytest.raises(ValueError, match="does not divide"):
        mesh_layout(4, 3)


# --------------------------------------------------------------------------
# Two ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, L)).astype(np.float32)
    clean = (rng.normal(size=(1, 2, L_TRAIN)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    models = {name: (dataclasses.asdict(_jcfg(name)), _weights(name)) for name in FAMILIES}
    spec = {"model_parallel": 2, "models": models, "x": x, "batch": (clean, noisy), "opt": OPT,
            "grad_loss": GRAD_LOSS}
    ranks = launch("tp", spec, str(tmp_path_factory.mktemp("tp")))
    return spec, ranks


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax(job, name):
    """tp_forward at two ranks against JAX's forward, 2e-5 of max|ref|
    (JAX's own bound, tests/test_tensor_parallel.py); both ranks agree."""
    spec, (r0, r1) = job
    w = jax.tree_util.tree_map(jnp.asarray, spec["models"][name][1])
    ref = jax.jit(lambda p, x: jm.forward(p, x, _jcfg(name)))(w, jnp.asarray(spec["x"]))
    got = r0["forward"][name]
    assert got.shape == ref.shape and _rel(got, ref) < 2e-5
    assert np.array_equal(got, r1["forward"][name])


def test_forward_matches_jax_tp_forward(job):
    """The mamba case against JAX's tp_forward on a 2-device CPU mesh."""
    spec, (r0, _) = job
    w = jax.tree_util.tree_map(jnp.asarray, spec["models"]["mamba"][1])
    ref = jax.jit(lambda p, x: jt.tp_forward(p, x, _jcfg("mamba"), _jmesh(2), scan_impl="xla"))(
        w, jnp.asarray(spec["x"]))
    assert _rel(r0["forward"]["mamba"], ref) < 2e-5


def _assert_leaves_close(got, want, rtol):
    """Each leaf within ``rtol`` of max(its largest |value|, 1e-3 of the
    tree's largest)."""
    floor = 1e-3 * max(np.abs(b).max() for b in want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), floor), i


def test_gradient_matches_jax(job):
    """The fp32 gradient of one micro-batch, gathered over the model group and
    back in the canonical layout, against ``jax.grad`` of the one-device
    loss (the squared error, ``GRAD_LOSS``): every leaf within 1e-4 of its
    max; the loss within 1e-5 relative; both ranks bitwise alike."""
    spec, (r0, r1) = job
    cfg = _jcfg("mamba")
    w = jax.tree_util.tree_map(jnp.asarray, spec["models"]["mamba"][1])
    clean, noisy = (jnp.asarray(x[0]) for x in spec["batch"])
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jm.forward(p, noisy, cfg), clean, JLoss(**GRAD_LOSS)),
        has_aux=True))(w)
    for a, b in zip(_leaves(r0["grads"]), _leaves(g), strict=True):
        assert _rel(a, b) < 1e-4
    assert _rel(r0["grad_aux"]["loss"], float(loss)) < 1e-5
    for a, b in zip(_leaves(r0["grads"]), _leaves(r1["grads"])):
        assert np.array_equal(a, b)


def test_train_step_matches_jax_make_tp_train_step(job):
    """One fp32 step (Adam, clip 10) against JAX's make_tp_train_step on a
    2-device mesh: worst leaf 2e-3, loss 1e-4, grad_norm 1e-4 relative
    (JAX's bounds, tests/test_tensor_parallel.py); the step moved some leaf
    by more than that tolerance."""
    spec, (r0, _) = job
    cfg = _jcfg("mamba")
    w = jax.tree_util.tree_map(jnp.asarray, spec["models"]["mamba"][1])
    make = jt.make_tp_train_step(cfg, JLoss(), JOpt(**OPT), _jmesh(2), bf16=False)
    p_tp, state, step = make(w)
    p_tp, _, aux = step(p_tp, state, tuple(jnp.asarray(x) for x in spec["batch"]))
    want = _leaves(jt.tp_unprepare(jax.device_get(p_tp), cfg, 2))
    run = r0["runs"]["step"]
    got = _leaves(run["params"])
    assert max(_rel(a, b) for a, b in zip(got, want, strict=True)) < 2e-3
    assert abs(run["aux"]["loss"] - float(aux["loss"])) < 1e-4
    assert _rel(run["aux"]["grad_norm"], float(aux["grad_norm"])) < 1e-4
    assert max(_rel(b, a) for a, b in zip(_leaves(spec["models"]["mamba"][1]), want)) > 2e-3
    assert run["count"] == 1 and run["aux"]["grads_finite"] == 1.0


def test_remat_accumulation_and_replicated_leaves(job):
    """remat changes no value; two accumulated micro-batches equal the
    port's one-process step over the same stack; after three steps the
    replicated leaves are bitwise equal on both ranks."""
    spec, (r0, r1) = job
    runs = r0["runs"]
    for a, b in zip(_leaves(runs["remat"]["params"]), _leaves(runs["step"]["params"])):
        assert _rel(a, b) < 1e-6
    assert runs["remat"]["aux"]["loss"] == pytest.approx(runs["step"]["aux"]["loss"], abs=1e-7)

    cfg = _pcfg(_jcfg("mamba"))
    w = tparams.from_numpy(spec["models"]["mamba"][1], "cpu")
    opt = make_optimizer(OptimizationConfig(**OPT))
    stack = tuple(torch.from_numpy(x.reshape(2, 1, -1)) for x in spec["batch"])
    p, _, aux = make_train_step(cfg, LossConfig(), opt, bf16=False)(w, opt.init(w), stack)
    got = _leaves(runs["accum"]["params"])
    want = _leaves(tparams.to_numpy(p))
    assert max(_rel(a, b) for a, b in zip(got, want, strict=True)) < 2e-3
    assert runs["accum"]["aux"]["loss"] == pytest.approx(float(aux["loss"]), abs=1e-4)
    assert _rel(runs["accum"]["aux"]["grad_norm"], float(aux["grad_norm"])) < 1e-4
    assert len(r0["replicated"]) == len(r1["replicated"]) > 0
    for a, b in zip(r0["replicated"], r1["replicated"]):
        assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# The training CLI under torchrun
# --------------------------------------------------------------------------

# the reference JSON has no normalize_input: a checkpoint's config has its default
CLI_CFG = JCfg(**{**TINY, "normalize_input": True})


def _cli_files(tmp_path):
    exp = tmp_path / "exp.json"
    exp.write_text(json.dumps({"network": "CleanUMamba", "exp_path": "tp",
                               "network_config": _pcfg(CLI_CFG).to_reference_json()}))
    with open(os.path.join(ROOT, "configs", "train_synth.json")) as f:
        cfg = json.load(f)
    cfg["train_config"]["log"] = {"directory": str(tmp_path / "logs"), "ckpt_iter": "max",
                                  "iters_per_ckpt": 2, "iters_per_valid": 1000}
    cfg["train_config"]["optimization"]["autocast"] = False
    cfg["trainset_config"] = {"crop_length_sec": 0.1}
    conf = tmp_path / "config.json"
    conf.write_text(json.dumps(cfg))
    return ["-c", str(conf), "-e", str(exp), "--synthetic", "--log-every", "1",
            "--device", "cpu", "--model-parallel", "2"]


def _torchrun(args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "cleanumamba_tpu_torch.cli.train", *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=env(), capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


def test_cli_model_parallel_banks_canonical_checkpoints_and_resumes(tmp_path):
    """``--model-parallel 2`` at two ranks trains, banks canonical-layout
    checkpoints that JAX's load_checkpoint reads and whose JAX forward
    matches the port's, and resumes from them (the moments re-permuted:
    the count goes on)."""
    args = _cli_files(tmp_path)
    out = _torchrun(args + ["--max-iters", "2"])
    assert "tensor parallel: weights over 2 ranks" in out and "batch/step: 2 x accum 1" in out
    assert out.count("iter 0: loss=") == 1
    out = _torchrun(args + ["--max-iters", "3"])
    assert "resumed from iter 1" in out and "iter 2: loss=" in out
    ck_dir = tmp_path / "logs" / "tp" / "checkpoint"
    assert sorted(os.listdir(ck_dir)) == ["1.pkl", "2.pkl"]
    ck = jax_load_checkpoint(str(ck_dir / "2.pkl"))
    assert ck["iter"] == 2 and ck["config"] == CLI_CFG
    assert ck["opt_state"]["count"] == 3
    first = jax_load_checkpoint(str(ck_dir / "1.pkl"))
    assert any(not np.array_equal(a, b)
               for a, b in zip(_leaves(ck["params"]), _leaves(first["params"])))
    x = np.random.default_rng(0).normal(size=(1, 1600)).astype(np.float32) * 0.1
    y = jm.forward(jax.tree_util.tree_map(jnp.asarray, ck["params"]), jnp.asarray(x), ck["config"])
    mine = tm.forward(tparams.from_numpy(ck["params"], "cpu"), torch.from_numpy(x),
                      _pcfg(ck["config"]))
    assert _rel(mine.numpy(), y) < 2e-5


def test_cli_refuses_device_data_with_model_parallel(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tcli.main(_cli_files(tmp_path) + ["--device-data", "1"])
    assert "--device-data and --model-parallel are exclusive" in capsys.readouterr().err
