"""The device mesh across processes (port of ``cleanumamba_tpu/parallel/mesh.py``).

JAX builds a ``Mesh`` over the devices one program sees.  Here each rank is
a process with one device, launched by ``torchrun`` (or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``); :class:`Mesh` holds its process groups.  The mesh is 1-D
(JAX's ``"data"`` axis) or, with ``model_parallel`` M > 1, the 2-D
``(data, model)`` mesh of JAX's ``np.array(devices).reshape(world // M, M)``:
rank r has data index ``r // M`` and model index ``r % M``
(:func:`mesh_layout`).

:func:`batch_sharding` and :func:`replicated_sharding` stand in for JAX's
shardings of the same names: a rank's slice of the batch axis over the data
axis, and a tree broadcast from rank 0.  :func:`pmean` is ``jax.lax.pmean``
over the data axis and :func:`psum_leaves` ``jax.lax.psum`` over the model
axis, with one all-reduce per dtype over a flat buffer.
:func:`psum`, :func:`all_gather` and :func:`send_right` are ``lax.psum``,
``lax.all_gather`` and a ``ppermute`` to the next rank over one group, for
tensor and sequence parallelism.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from cleanumamba_tpu_torch.params import tensor_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: the world's process group, its rank, the
    number of ranks and its device; and, for a 2-D mesh, the groups of its
    model row and its data column.  A group of one rank is None: a
    collective over it is the identity."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device
    model_size: int = 1
    model_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def data_size(self) -> int:
        return self.world // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size


def mesh_layout(world: int, model_parallel: int) -> Tuple[List[List[int]], List[List[int]]]:
    """``(model rows, data columns)`` of ``world`` ranks laid out as
    ``np.arange(world).reshape(world // model_parallel, model_parallel)``:
    row d holds the ranks of data index d, column m those of model index m."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {world} ranks")
    dp = world // model_parallel
    rows = [[d * model_parallel + m for m in range(model_parallel)] for d in range(dp)]
    cols = [[d * model_parallel + m for d in range(dp)] for m in range(model_parallel)]
    return rows, cols


def make_mesh(device=None, backend: Optional[str] = None,
              timeout: Optional[datetime.timedelta] = None, model_parallel: int = 1) -> Mesh:
    """Join (or reuse) the default process group from the launcher's
    environment and return this rank's :class:`Mesh`.

    device: None (or "cuda") means ``cuda:{LOCAL_RANK}``, which must exist
    (raises otherwise); "cpu" for the CPU.  backend: None means NCCL for a CUDA
    device and gloo for the CPU.  NCCL takes one rank per card; several
    ranks on one card need gloo (which moves CUDA tensors through the host).
    timeout: how long a collective waits for the other ranks (None: torch's
    default for the backend).  model_parallel: the model axis' size M, which
    must divide the world; every rank creates every row's and column's group
    of more than one rank and fewer than all, rows first, in the same order
    (a group of all ranks is the world's).
    """
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"make_mesh: {', '.join(missing)} not set; launch with torchrun "
                           "(or set the process group's environment yourself)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    rows, cols = mesh_layout(world, model_parallel)
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
    mine = {}
    for axis, groups in (("model", rows), ("data", cols)):
        for ranks in groups:
            if len(ranks) == world > 1:
                mine[axis] = dist.group.WORLD
            elif len(ranks) > 1:
                g = dist.new_group(ranks, timeout=timeout, backend=dist.get_backend())
                if rank in ranks:
                    mine[axis] = g
    return Mesh(dist.group.WORLD, rank, world, device, model_parallel,
                mine.get("model"), mine.get("data"))


def batch_sharding(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``axis``, which the data axis splits
    in equal contiguous parts (data index d takes part d), as ``P("data")``
    does; the ranks of one model row take the same part."""
    n, parts = x.shape[axis], mesh.data_size
    if n % parts:
        raise ValueError(f"batch axis of {n} does not split over {parts} ranks")
    k = n // parts
    return x.narrow(axis, mesh.data_rank * k, k).contiguous()


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


def _reduce_leaves(mesh: Mesh, tensors: List[torch.Tensor], group, size: int):
    """The sum (size 1) or mean over ``group`` of each tensor: one all-reduce
    per dtype; the tensors as they are for a group of one rank (None)."""
    if group is None:
        return list(tensors)

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        if size > 1:
            flat.div_(size)

    return _coalesced(mesh, tensors, reduce)


def pmean(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the data axis of each tensor (``jax.lax.pmean(x,
    "data")``; on a 1-D mesh every rank): one all-reduce per dtype, then a
    division by the number of ranks."""
    return _reduce_leaves(mesh, tensors, mesh.data_group, mesh.data_size)


def psum_leaves(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the model axis of each tensor (``jax.lax.psum(x,
    "model")``): one all-reduce per dtype."""
    return _reduce_leaves(mesh, tensors, mesh.model_group, 1)


def _sum(x, group):
    """The sum of x over the group, in x's dtype; a bf16 or fp16 tensor is
    summed in fp32 and rounded once, on every backend."""
    y = x.to(torch.promote_types(x.dtype, torch.float32),
             memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _PSum(torch.autograd.Function):
    """Sum over a group; its adjoint is the same sum (``lax.psum``
    transposes to itself)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum(x)`` over ``group``, differentiable; the identity for None."""
    return x if group is None else _PSum.apply(x, group)


# gloo documents CUDA tensors for all_reduce and broadcast only, not for
# all_gather or send/recv; so the two below are built, on every backend, from
# one all_reduce in which each rank writes its slot of a zero buffer (exact:
# x + 0 = x).  Complex tensors travel as (re, im) pairs.

def all_gather(x: torch.Tensor, group, size: int, index: int) -> torch.Tensor:
    """``lax.all_gather``: (size, *x.shape), slot i the tensor of the
    group's i-th rank (``index`` is this rank's); not differentiable."""
    if x.is_complex():
        return torch.view_as_complex(all_gather(torch.view_as_real(x), group, size, index))
    buf = x.new_zeros((size, *x.shape))
    buf[index] = x
    if group is not None:
        dist.all_reduce(buf, group=group)
    return buf


def send_right(x: torch.Tensor, group, size: int, index: int) -> torch.Tensor:
    """``ppermute`` to the next rank of the group: rank i gets rank i - 1's
    ``x``, rank 0 zeros."""
    if index == 0:
        all_gather(x, group, size, index)  # every rank joins the collective
        return torch.zeros_like(x)
    return all_gather(x, group, size, index)[index - 1]
