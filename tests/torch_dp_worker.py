"""One rank of the data-parallel checks of ``tests/test_torch_dp.py``: run
as ``python tests/torch_dp_worker.py IN.pkl OUT_DIR`` by the test, with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
set, on the CPU with gloo.  Imports the port only (no JAX).

IN.pkl holds the tiny config's fields, numpy weights, the global batch and
the validation items; the rank writes ``rank{r}.pkl`` with what it computed:
the averaged gradient and aux of its step, its params after one sharded
step, two steps of ``make_device_data_steps(mesh=)`` with the sums of the
batches it drew, and ``validate(mesh=)``.
"""

import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cleanumamba_tpu_torch import params as tparams  # noqa: E402
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig  # noqa: E402
from cleanumamba_tpu_torch.config import OptimizationConfig  # noqa: E402
from cleanumamba_tpu_torch.eval.validate import validate  # noqa: E402
from cleanumamba_tpu_torch.parallel import batch_sharding, make_mesh, pmean  # noqa: E402
from cleanumamba_tpu_torch.train import trainer as tt  # noqa: E402
from cleanumamba_tpu_torch.train.optim import make_optimizer  # noqa: E402


class _Items:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def main(inp, out_dir):
    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh("cpu")
    cfg = CleanUMambaConfig(**job["cfg"])
    loss = LossConfig()
    weights = tparams.from_numpy(job["weights"], "cpu")
    clean, noisy = (torch.from_numpy(x) for x in job["batch"])
    lr = job["lr"]
    out = {"rank": mesh.rank, "world": mesh.world}

    # the averaged gradient of the rank's slice
    grad_fn = tt.make_grad_fn(cfg, loss, bf16=False)
    grads, aux = grad_fn(weights, batch_sharding(mesh, clean, 1), batch_sharding(mesh, noisy, 1))
    g = tparams.tensor_leaves(grads)
    out["grads"] = tparams.to_numpy(tparams.tree_unflatten(grads, pmean(mesh, g)))

    # one sharded step from the same weights
    opt = make_optimizer(OptimizationConfig(n_iters=1000, learning_rate=lr, eps=job["eps"]),
                         schedule=lambda s: lr)
    step = tt.shard_train_step(tt.make_train_step(cfg, loss, opt, bf16=False, mesh=mesh), mesh)
    p, state, aux = step(weights, opt.init(weights), (clean, noisy))
    out["params"] = tparams.to_numpy(p)
    out["aux"] = {k: float(v) for k, v in aux.items()}
    out["count"] = state["count"]

    # on-device data: each rank's batches from (seed, rank)
    sums = []
    raw = tt.make_train_step(cfg, loss, opt, bf16=False, mesh=mesh)

    def spy(params, opt_state, batch):
        sums.append([float(batch[0].sum()), float(batch[1].sum())])
        return raw(params, opt_state, batch)

    stepper = tt.make_device_data_steps(spy, 1, job["length"], 2, mesh=mesh)
    p2, s2, aux2 = stepper(weights, opt.init(weights), torch.Generator().manual_seed(7))
    out["device_data"] = {"params": tparams.to_numpy(p2), "sums": sums, "count": s2["count"],
                          "loss": float(aux2["loss"])}

    # sharded validation
    items = [tuple(x) for x in job["valid_items"]]
    out["valid"] = validate(weights, cfg, _Items(items), pad_to=job["pad_to"], mesh=mesh)

    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
