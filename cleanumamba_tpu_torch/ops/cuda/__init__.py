"""Hand-written Hopper kernels with their device dispatch.

Each wrapper launches its CUDA kernel for CUDA tensors and takes the plain
PyTorch version, kept in the same module, for CPU tensors.  Kernels are
built with ``nvcc`` at first use (:mod:`.build`); importing these modules
builds and loads nothing.
"""
