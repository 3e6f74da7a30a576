"""Parallelism across processes (port of ``cleanumamba_tpu/parallel``).

The JAX package replaces the reference's hand-rolled NCCL DDP (rank-0
parameter broadcast, gradient all-reduce through autograd hooks, one
subprocess per GPU; reference train_distributed.py:44-181) with one program
over a device mesh.  The port goes back to one process per device under
``torchrun``: :class:`Mesh` holds the process groups of a 1-D data mesh or a
2-D (data, model) mesh.  Data parallelism: each rank keeps its slice of the
batch, and the train step averages the gradients with coalesced all-reduces
(``train/trainer.py``).  ``tensor.py`` shards the weights over the model axis
(Megatron-style, composable with DP); ``sequence.py`` splits the time axis
of one long waveform over the ranks (exact, by halo and SSM segment
composition).
"""

from cleanumamba_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    mesh_layout,
    pmean,
    replicated_sharding,
)
from cleanumamba_tpu_torch.parallel.sequence import sp_stream_denoise
from cleanumamba_tpu_torch.parallel.tensor import make_tp_train_step, tp_forward, tp_prepare

__all__ = ["Mesh", "make_mesh", "mesh_layout", "batch_sharding", "replicated_sharding", "pmean",
           "sp_stream_denoise", "tp_forward", "tp_prepare", "make_tp_train_step"]
