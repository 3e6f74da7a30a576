"""Data parallelism of the port across processes (``parallel/``,
``train/trainer.py``'s ``mesh``, ``shard_train_step``,
``make_device_data_steps(mesh=)``, ``validate(mesh=)``, and the training
CLI under ``torchrun``) on the CPU: two gloo ranks, each a subprocess
(``tests/torch_dp_worker.py``, which imports no JAX), against one process
and against JAX's ``shard_train_step`` and sharded ``validate`` on
``make_mesh(2)`` (``tests/conftest.py`` gives JAX 8 CPU devices).

Every subprocess gets a free port and a time limit.  The port runs before
JAX in each test.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JCfg
from cleanumamba_tpu.config import LossConfig as JLoss
from cleanumamba_tpu.config import OptimizationConfig as JOpt
from cleanumamba_tpu.eval.validate import validate as jax_validate
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cleanumamba_tpu.train import trainer as jt
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
from cleanumamba_tpu_torch.data import (
    CleanNoisyPairDataset,
    SyntheticDenoiseDataset,
    make_training_loader,
)
from cleanumamba_tpu_torch.data.native_loader import NativeWavLoader
from cleanumamba_tpu_torch.data.wavio import write_wav
from cleanumamba_tpu_torch.eval.validate import validate
from cleanumamba_tpu_torch.train import trainer as tt
from cleanumamba_tpu_torch.train.optim import make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
            tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
L = 4096
LR = 1e-3
# Adam with eps 1.0, so that the first update, lr * g / (|g| + eps), is
# smooth in g.  With eps 1e-8 it is lr * sign(g): any update of size at most
# lr would agree within 2 lr, and a near-zero gradient's sign is fp32 noise.
EPS = 1.0
PAD = 8000
TIMEOUT = 300  # seconds for any one subprocess


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaves(tree):
    """numpy leaves in one (sorted-key) order for either package's tree."""
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _assert_leaves_close(got, want, rtol):
    """Each leaf within ``rtol`` of max(its largest |value|, 1e-3 of the
    tree's largest): leaves that are sums of cancelling terms (norm biases,
    per-channel shifts) are held to the tree's scale."""
    floor = 1e-3 * max(np.abs(b).max() for b in want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), floor), i


def _moved(before, after, rtol):
    """The step moved some leaf by more than the tolerance of
    :func:`_assert_leaves_close`, so that the comparison sees the update."""
    floor = 1e-3 * max(np.abs(b).max() for b in after)
    assert any(np.abs(b - a).max() > rtol * max(np.abs(b).max(), floor)
               for a, b in zip(before, after))


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               **{k: str(v) for k, v in kw.items()})
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    weights = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), JCfg(**TINY)))
    rng = np.random.default_rng(2)
    clean = (rng.normal(size=(1, 4, L)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=clean.shape)).astype(np.float32)
    ds = SyntheticDenoiseDataset(n_items=3, crop_length_sec=0.5, seed=5)
    items = [(np.asarray(ds[i][0]), np.asarray(ds[i][1])) for i in range(len(ds))]
    spec = {"cfg": TINY, "weights": weights, "batch": (clean, noisy), "lr": LR, "eps": EPS,
            "length": L, "valid_items": items, "pad_to": PAD}
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(spec, f)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dp_worker.py"), str(d / "job.pkl"),
         str(d)], env=_env(RANK=r, LOCAL_RANK=r, WORLD_SIZE=2, MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return spec, ranks


def test_ranks_are_bitwise_equal(job):
    _, (r0, r1) = job
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    for key in ("grads", "params"):
        a, b = _leaves(r0[key]), _leaves(r1[key])
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), key
    assert r0["aux"] == r1["aux"] and r0["count"] == r1["count"] == 1


def test_two_ranks_equal_one_process_over_the_same_items(job):
    """The ranks' averaged gradient and step against one process that takes
    the ranks' slices as two accumulation micro-batches (the STFT spectral
    convergence is a ratio of norms over a batch, so a mean over ranks is a
    mean over micro-batches, not one loss over the joint batch): every
    gradient leaf to 1e-5 of its largest value, the aux to 1e-6, the params
    to 1e-6 of max(leaf max, 1e-3 of the model's largest)."""
    spec, (r0, _) = job
    cfg = CleanUMambaConfig(**TINY)
    w = tparams.from_numpy(spec["weights"], "cpu")
    clean, noisy = (torch.from_numpy(x.reshape(2, 2, L)) for x in spec["batch"])
    grads, _ = tt.make_grad_fn(cfg, LossConfig(), bf16=False)(w, clean, noisy)
    for a, b in zip(_leaves(r0["grads"]), _leaves(tparams.to_numpy(grads))):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    opt = make_optimizer(OptimizationConfig(n_iters=1000, learning_rate=LR, eps=EPS),
                         schedule=lambda s: LR)
    p, _, aux = tt.make_train_step(cfg, LossConfig(), opt, bf16=False)(
        w, opt.init(w), (clean, noisy))
    for k in ("loss", "reconstruct", "stft_sc", "stft_mag", "grad_norm"):
        assert abs(r0["aux"][k] - float(aux[k])) <= 1e-6 * abs(float(aux[k])), k
    _assert_leaves_close(_leaves(r0["params"]), _leaves(tparams.to_numpy(p)), 1e-6)
    _moved(_leaves(spec["weights"]), _leaves(r0["params"]), 1e-6)


def _grad_keeper():
    """An optax transformation whose state is the gradient it was last given
    (and whose update is zero): a step built with it hands back, as its
    optimizer state, the gradient its optimizer saw."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


@pytest.fixture(scope="module")
def jax_sharded(job):
    """JAX's shard_train_step over make_mesh(2), batch sharded on axis 1:
    the pmean-ed gradient that its optimizer saw, and the Adam step's params
    and aux."""
    spec, _ = job
    jcfg = JCfg(**TINY)
    mesh = jax_make_mesh(2)
    batch = tuple(jnp.asarray(x) for x in spec["batch"])
    out = {}
    for name, opt in (("grads", _grad_keeper()),
                      ("adam", jt.make_optimizer(JOpt(n_iters=1000, learning_rate=LR, eps=EPS),
                                                 schedule=lambda s: LR))):
        step = jt.shard_train_step(
            jt.make_train_step(jcfg, JLoss(), opt, bf16=False, axis_name="data"), mesh)
        p = jax.tree_util.tree_map(jnp.asarray, spec["weights"])
        with mesh:
            out[name] = step(p, opt.init(p), batch)
    return {"grads": _leaves(jax.tree_util.tree_map(np.asarray, out["grads"][1])),
            "params": _leaves(jax.tree_util.tree_map(np.asarray, out["adam"][0])),
            "aux": {k: float(v) for k, v in out["adam"][2].items()}}


def test_two_ranks_gradient_matches_jax_shard_train_step(job, jax_sharded):
    """The ranks' averaged gradient against the pmean-ed one of JAX's
    sharded step, leaf by leaf: 1e-4 of max(leaf max, 1e-3 of the model's
    largest)."""
    _, (r0, _) = job
    _assert_leaves_close(_leaves(r0["grads"]), jax_sharded["grads"], 1e-4)


def test_two_ranks_match_jax_shard_train_step(job, jax_sharded):
    """JAX's Adam step (eps 1.0) over make_mesh(2): aux to 1e-4, params to
    1e-4 of max(leaf max, 1e-3 of the model's largest)."""
    spec, (r0, _) = job
    for k in ("loss", "reconstruct", "stft_sc", "stft_mag", "grad_norm"):
        want = jax_sharded["aux"][k]
        assert abs(r0["aux"][k] - want) <= 1e-4 * abs(want), k
    _assert_leaves_close(_leaves(r0["params"]), jax_sharded["params"], 1e-4)
    _moved(_leaves(spec["weights"]), jax_sharded["params"], 1e-4)


def test_device_data_batches_differ_by_rank_and_params_agree(job):
    _, (r0, r1) = job
    d0, d1 = r0["device_data"], r1["device_data"]
    assert d0["count"] == d1["count"] == 2 and len(d0["sums"]) == len(d1["sums"]) == 2
    for s0, s1 in zip(d0["sums"], d1["sums"]):
        assert s0 != s1  # each rank drew its own batch
    assert d0["sums"][0] != d0["sums"][1]  # and a new one each step
    for a, b in zip(_leaves(d0["params"]), _leaves(d1["params"])):
        assert np.array_equal(a, b)
    assert d0["loss"] == d1["loss"] and np.isfinite(d0["loss"])


def test_sharded_validate_matches_serial_and_jax(job):
    """Three utterances over two ranks (the last group padded): the means
    against the port's serial validate and JAX's mesh validate, rtol 1e-3,
    atol 1e-4 (JAX's tests/test_validate_sharded.py)."""
    spec, (r0, r1) = job
    assert r0["valid"] == r1["valid"]
    items = spec["valid_items"]
    serial = validate(tparams.from_numpy(spec["weights"], "cpu"), CleanUMambaConfig(**TINY),
                      items, pad_to=PAD)
    theirs = jax_validate(jax.tree_util.tree_map(jnp.asarray, spec["weights"]), JCfg(**TINY),
                          items, pad_to=PAD, mesh=jax_make_mesh(2))
    assert set(r0["valid"]) == set(serial) == set(theirs) and serial
    for k in serial:
        np.testing.assert_allclose(r0["valid"][k], serial[k], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(r0["valid"][k], theirs[k], rtol=1e-3, atol=1e-4)


def _wav_root(root, n_train=6, n_test=2, seconds=0.5):
    """A file-backed dataset: training pair i is the constant (i + 1) / 100
    (clean) and its negative (noisy), so a batch names the files it came
    from; test pairs are noise."""
    n = int(seconds * 16000)
    for sub in ("clean", "noisy"):
        os.makedirs(root / "training_set" / sub)
        os.makedirs(root / "datasets" / "test_set" / "synthetic" / "no_reverb" / sub)
    for i in range(n_train):
        v = (i + 1) / 100
        write_wav(str(root / "training_set" / "clean" / f"fileid_{i}.wav"), np.full(n, v), 16000)
        write_wav(str(root / "training_set" / "noisy" / f"fileid_{i}.wav"), np.full(n, -v), 16000)
    rng = np.random.default_rng(3)
    test = root / "datasets" / "test_set" / "synthetic" / "no_reverb"
    for i in range(n_test):
        x = rng.normal(size=n) * 0.1
        write_wav(str(test / "clean" / f"clean_fileid_{i}.wav"), x, 16000)
        write_wav(str(test / "noisy" / f"noisy_fileid_{i}.wav"), x + rng.normal(size=n) * 0.05,
                  16000)
    return root


@pytest.mark.parametrize("native", [True, False])
def test_training_loader_shards_draw_from_disjoint_files(tmp_path, native):
    """Rank r's loader (shard r of 2, seed r) of a file-backed set, native
    (C++ threads) and Python: every item it gives is one of shard r's files."""
    ds = CleanNoisyPairDataset(str(_wav_root(tmp_path)), "training", 0.25)
    for r in range(2):
        loader = make_training_loader(ds, 2, seed=r, n_threads=2, prefer_native=native,
                                      num_shards=2, shard_index=r)
        assert isinstance(loader, NativeWavLoader) == native
        mine = np.array([(i + 1) / 100 for i in range(r, 6, 2)])
        for _ in range(4):
            clean, noisy = next(loader)
            assert clean.shape == noisy.shape == (2, 4000)
            for c, n in zip(clean, noisy):
                assert np.ptp(c) == 0 and np.array_equal(n, -c)
                assert np.abs(mine - c[0]).min() < 1e-3, (r, c[0])
        if native:
            loader.close()


def _cli_files(tmp_path):
    exp = tmp_path / "exp.json"
    exp.write_text(json.dumps({"network": "CleanUMamba", "exp_path": "tiny",
                               "network_config": CleanUMambaConfig(**TINY).to_reference_json()}))
    with open(os.path.join(ROOT, "configs", "train_synth.json")) as f:
        cfg = json.load(f)
    cfg["train_config"]["log"] = {"directory": str(tmp_path / "logs"), "ckpt_iter": "max",
                                  "iters_per_ckpt": 2, "iters_per_valid": 1000}
    cfg["train_config"]["optimization"]["autocast"] = False
    cfg["trainset_config"] = {"crop_length_sec": 0.25}
    conf = tmp_path / "config.json"
    conf.write_text(json.dumps(cfg))
    return ["-c", str(conf), "-e", str(exp), "--synthetic", "--log-every", "1",
            "--device", "cpu"]


def _torchrun(args, n=2):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "cleanumamba_tpu_torch.cli.train", *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


def test_cli_two_ranks_train_resume_and_jax_reads_the_checkpoint(tmp_path):
    args = _cli_files(tmp_path)
    out = _torchrun(args + ["--max-iters", "2"])
    assert "ranks: 2" in out and out.count("iter 0: loss=") == 1  # rank 0 alone logs
    assert "batch/step: 4 x accum 1" in out  # batch_size_per_gpu 2 x 2 ranks
    out = _torchrun(args + ["--max-iters", "4", "--device-data", "1"])
    assert "resumed from iter 1" in out and "iter 3: loss=" in out
    ck_dir = tmp_path / "logs" / "tiny" / "checkpoint"
    assert sorted(os.listdir(ck_dir)) == ["1.pkl", "2.pkl", "3.pkl"]  # every 2, and the last
    rows = [json.loads(x) for x in open(tmp_path / "logs" / "tiny" / "metrics.jsonl")]
    assert [r["_step"] for r in rows if r["_kind"] == "train"] == [0, 1, 2, 3]
    assert len({r["_run_id"] for r in rows}) == 1
    ck = jax_load_checkpoint(str(ck_dir / "3.pkl"))
    assert ck["iter"] == 3 and ck["config"] == JCfg(**TINY)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 4000)).astype(np.float32) * 0.1)
    y = jm.forward(jax.tree_util.tree_map(jnp.asarray, ck["params"]), x, ck["config"])
    assert y.shape == x.shape and bool(jnp.isfinite(y).all())


def test_cli_two_ranks_on_a_file_backed_set(tmp_path):
    """Two ranks over WAV files (each rank's native loader on its shard),
    with rank 0 validating at iteration 2 while rank 1 waits in the next
    all-reduce."""
    root = _wav_root(tmp_path / "data")
    args = _cli_files(tmp_path)
    conf = json.loads(open(args[1]).read())
    conf["trainset_config"] = {"root": str(root), "crop_length_sec": 0.25}
    conf["train_config"]["log"].update(iters_per_valid=2, valid_max_items=2)
    open(args[1], "w").write(json.dumps(conf))
    args.remove("--synthetic")
    out = _torchrun(args + ["--max-iters", "4"])
    assert "ranks: 2" in out and "synthetic" not in out
    assert out.count(": valid ") == 1 and "iter 3: loss=" in out
    assert sorted(os.listdir(tmp_path / "logs" / "tiny" / "checkpoint")) == ["2.pkl", "3.pkl"]
