"""K1: the forward selective scan, dispatched by device.

``selective_scan`` launches the CUDA kernel ``csrc/selective_scan.cu``
(the port of ``cleanumamba_tpu/ops/pallas/selective_scan.py::pallas_selective_scan``)
for CUDA tensors and the plain chunked scan for CPU tensors.  Contract as in
:mod:`cleanumamba_tpu_torch.ops.scan`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cleanumamba_tpu_torch.ops import scan as plain_scan
from cleanumamba_tpu_torch.ops.cuda.build import (
    check,
    dtype_code,
    load_library,
    ptr,
    require_cuda,
    stream_ptr,
)

MAX_D_STATE = 256  # 16 lanes x 16 state elements per thread (csrc/selective_scan.cu)


def selective_scan_plain(u, dt, A, B, C, D=None, h0=None):
    """The plain version of K1: the chunked PyTorch scan."""
    return plain_scan.selective_scan(u, dt, A, B, C, D, h0)


@functools.cache
def _kernel():
    fn = load_library("selective_scan").selective_scan_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def selective_scan(u, dt, A, B, C, D=None, h0=None):
    """y, h_last = scan(u, dt, A, B, C, D, h0): the kernel for CUDA tensors,
    the plain chunked scan for CPU tensors.

    On CUDA: u, B, C fp32 or bf16 (one dtype); dt, A, D, h0 fp32; all
    contiguous; 1 <= d_state <= 256.  Anything else raises.
    """
    if u.device.type == "cpu":
        return selective_scan_plain(u, dt, A, B, C, D, h0)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device {u.device}")
    what = "selective_scan"
    Bsz, L, Di = u.shape
    Ds = A.shape[1]
    code = dtype_code(u, what)
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"{what}: u, B, C must share a dtype, got {u.dtype}, {B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if not 1 <= Ds <= MAX_D_STATE:
        raise ValueError(f"{what}: d_state={Ds} outside [1, {MAX_D_STATE}]")
    shapes = {"dt": (dt, (Bsz, L, Di)), "A": (A, (Di, Ds)), "B": (B, (Bsz, L, Ds)),
              "C": (C, (Bsz, L, Ds)), "D": (D, (Di,)), "h0": (h0, (Bsz, Di, Ds))}
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    require_cuda(what, u.device, u=u, dt=dt, A=A, B=B, C=C, D=D, h0=h0)

    if D is None:
        D = torch.zeros(Di, dtype=torch.float32, device=u.device)
    if h0 is None:
        h0 = torch.zeros((Bsz, Di, Ds), dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    h_last = torch.empty((Bsz, Di, Ds), dtype=torch.float32, device=u.device)
    if Bsz == 0 or Di == 0:
        return y, h_last
    if L == 0:
        return y, h_last.copy_(h0)
    status = _kernel()(code, ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D), ptr(h0),
                       ptr(y), ptr(h_last), Bsz, L, Di, Ds, stream_ptr(u.device))
    check(status, "selective_scan_fwd")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
