"""CleanUMamba in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of the serving path of :mod:`cleanumamba_tpu` (offline denoising and
constant-memory streaming of the Mamba-bottleneck U-Net).  The JAX package
is the reference: this package consumes the same parameter pytree (same leaf
names, channels-last ``(B, L, C)`` layouts) as nested dicts/lists of torch
tensors, so every public function can be held against its JAX counterpart.

Kernels dispatch by device, in one place each: a CUDA tensor launches the
hand-written kernel (``ops/cuda``), a CPU tensor takes the plain PyTorch
version kept beside it.  This package never imports ``jax``.
"""

__version__ = "0.1.0"
