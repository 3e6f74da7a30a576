"""Data parallelism across processes (port of ``cleanumamba_tpu/parallel``,
its 1-D data mesh).

The JAX package replaces the reference's hand-rolled NCCL DDP (rank-0
parameter broadcast, gradient all-reduce through autograd hooks, one
subprocess per GPU; reference train_distributed.py:44-181) with one program
over a device mesh.  The port goes back to one process per device under
``torchrun``: :class:`Mesh` holds the process group, each rank keeps its
slice of the batch, and the train step averages the gradients with
coalesced all-reduces (``train/trainer.py``).  Tensor and sequence
parallelism (JAX ``parallel/tensor.py``, ``parallel/sequence.py``) are not
ported yet.
"""

from cleanumamba_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    pmean,
    replicated_sharding,
)

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated_sharding", "pmean"]
