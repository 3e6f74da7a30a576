"""The 1-D data mesh across processes (port of ``cleanumamba_tpu/parallel/mesh.py``).

JAX builds a ``Mesh`` over the devices one program sees.  Here each rank is
a process with one device, launched by ``torchrun`` (or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``); :class:`Mesh` holds its process group.
:func:`batch_sharding` and :func:`replicated_sharding` stand in for JAX's
shardings of the same names: a rank's slice of the batch axis, and a tree
broadcast from rank 0.  :func:`pmean` is ``jax.lax.pmean`` over the mesh,
with one all-reduce per dtype over a flat buffer.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from cleanumamba_tpu_torch.params import tensor_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data mesh: its process group, rank, the
    number of ranks and its device.  It is one axis, JAX's ``"data"``."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device


def make_mesh(device=None, backend: Optional[str] = None,
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """Join (or reuse) the default process group from the launcher's
    environment and return this rank's :class:`Mesh`.

    device: None (or "cuda") means ``cuda:{LOCAL_RANK}``, which must exist
    (raises otherwise); "cpu" for the CPU.  backend: None means NCCL for a CUDA
    device and gloo for the CPU.  NCCL takes one rank per card; several
    ranks on one card need gloo (which moves CUDA tensors through the host).
    timeout: how long a collective waits for the other ranks (None: torch's
    default for the backend).
    """
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"make_mesh: {', '.join(missing)} not set; launch with torchrun "
                           "(or set the process group's environment yourself)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    if device is None or torch.device(device) == torch.device("cuda"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= n:
            raise RuntimeError(
                f"rank {rank}: cuda:{local} does not exist ({n} CUDA device(s) here); start at "
                "most one rank per card, or pass device=\"cpu\" (--device cpu)")
        device = f"cuda:{local}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                                f"{env['MASTER_PORT']}", rank=rank, world_size=world,
                                timeout=timeout)
    elif dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError("make_mesh: the process group differs from RANK/WORLD_SIZE")
    return Mesh(dist.group.WORLD, rank, world, device)


def batch_sharding(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``axis``, which the ranks split in
    equal contiguous parts (rank r takes part r), as ``P("data")`` does."""
    n = x.shape[axis]
    if n % mesh.world:
        raise ValueError(f"batch axis of {n} does not split over {mesh.world} ranks")
    k = n // mesh.world
    return x.narrow(axis, mesh.rank * k, k).contiguous()


def _coalesced(mesh: Mesh, leaves: List[torch.Tensor], collective) -> List[torch.Tensor]:
    """Apply ``collective`` to one flat buffer per dtype of ``leaves`` and
    return the leaves read back from the buffers, in order."""
    out = list(leaves)
    by_dtype = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return out


def replicated_sharding(mesh: Mesh, tree):
    """``tree`` with every tensor leaf replaced by rank 0's (one broadcast
    per dtype); other leaves are kept."""
    leaves = _coalesced(mesh, tensor_leaves(tree),
                        lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return tree_unflatten(tree, leaves)


def pmean(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (``jax.lax.pmean``): one
    all-reduce per dtype, then a division by the number of ranks."""
    def reduce(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)

    return _coalesced(mesh, tensors, reduce)
