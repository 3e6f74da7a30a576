"""One rank of the tensor- and sequence-parallel checks of
``tests/test_torch_tp.py`` and ``tests/test_torch_sp.py``: run as ``python
tests/torch_parallel_worker.py tp|sp IN.pkl OUT_DIR`` by the test, with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set, on the CPU with gloo.  Imports the port only (no JAX).

IN.pkl holds the configs' fields, numpy weights made by the JAX package and
the inputs; the rank writes ``rank{r}.pkl`` with what it computed.

- tp: ``tp_forward`` of every case; the fp32 gradient of one micro-batch
  gathered back to the canonical layout; one Adam step (canonical params
  after it, its aux, and the rank's replicated leaves after three steps);
  the same step with ``remat`` and with two accumulated micro-batches.
- sp: ``sp_stream_denoise`` of every case over the two ranks.
"""

import os
import pickle
import socket
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cleanumamba_tpu_torch import params as tparams  # noqa: E402
from cleanumamba_tpu_torch.config import (  # noqa: E402
    CleanUMambaConfig,
    LossConfig,
    OptimizationConfig,
)
from cleanumamba_tpu_torch.parallel import make_mesh  # noqa: E402
from cleanumamba_tpu_torch.parallel import tensor as tpar  # noqa: E402
from cleanumamba_tpu_torch.parallel.sequence import sp_stream_denoise  # noqa: E402


def _cfg(fields):
    return CleanUMambaConfig(**fields)


def _canonical(mesh, local, specs, cfg):
    full = tpar.tp_gather(mesh, local, specs)
    return tparams.to_numpy(tpar.tp_unprepare(full, cfg, mesh.model_size))


def run_tp(job, mesh):
    out = {"forward": {}}
    torch.manual_seed(0)
    for name, (fields, weights) in job["models"].items():
        cfg = _cfg(fields)
        y = tpar.tp_forward(tparams.from_numpy(weights, "cpu"), torch.from_numpy(job["x"]), cfg,
                            mesh)
        out["forward"][name] = y.detach().numpy()

    fields, weights = job["models"]["mamba"]
    cfg = _cfg(fields)
    loss = LossConfig()
    w = tparams.from_numpy(weights, "cpu")
    clean, noisy = (torch.from_numpy(x) for x in job["batch"])  # (1, B, L)
    params_tp, specs = tpar.tp_prepare(w, cfg, mesh.model_size)
    local = tpar.tp_shard(params_tp, specs, mesh.model_size, mesh.model_rank)
    grads, aux = tpar.make_tp_grad_fn(cfg, LossConfig(**job["grad_loss"]), mesh, specs,
                                      bf16=False)(local, clean, noisy)
    out["grads"] = _canonical(mesh, grads, specs, cfg)
    out["grad_aux"] = {k: float(v) for k, v in aux.items()}

    opt = OptimizationConfig(**job["opt"])
    runs = {}
    stack = tuple(x.reshape(2, 1, -1) for x in (clean, noisy))  # two micro-batches
    for label, remat, batch in (("step", False, (clean, noisy)), ("remat", True, (clean, noisy)),
                                ("accum", False, stack)):
        make = tpar.make_tp_train_step(cfg, loss, opt, mesh, bf16=False, remat=remat)
        p, state, step = make(w)
        p, state, aux = step(p, state, batch)
        runs[label] = {"params": _canonical(mesh, p, specs, cfg), "count": state["count"],
                       "aux": {k: float(v) for k, v in aux.items()}}
        if label == "step":
            for _ in range(2):
                p, state, _ = step(p, state, batch)
            flat = tparams.tensor_leaves(p)
            spec_leaves = tpar.spec_leaves(p, specs)
            out["replicated"] = [x.numpy() for x, s in zip(flat, spec_leaves) if s is None]
    out["runs"] = runs
    return out


def run_sp(job, mesh):
    out = {}
    for name, (fields, weights, x) in job["cases"].items():
        y = sp_stream_denoise(tparams.from_numpy(weights, "cpu"), _cfg(fields), x, mesh)
        out[name] = y.numpy()
    return out


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds for any one subprocess


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env(**kw):
    """The environment of a subprocess: one thread, the repo importable."""
    e = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
             **{k: str(v) for k, v in kw.items()})
    e["PYTHONPATH"] = os.pathsep.join([ROOT, e.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return e


def launch(mode, job, directory, world=2):
    """Run ``world`` ranks of this script on ``job`` (pickled into
    ``directory``), each under TIMEOUT, and return their outputs in rank
    order; raises with a rank's log if it fails."""
    path = os.path.join(directory, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, path, directory],
        env=env(RANK=r, LOCAL_RANK=r, WORLD_SIZE=world, MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
    for r in range(world):
        with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def main(mode, inp, out_dir):
    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh("cpu", model_parallel=job.get("model_parallel", 1))
    out = {"rank": mesh.rank, "world": mesh.world,
           **(run_tp(job, mesh) if mode == "tp" else run_sp(job, mesh))}
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
