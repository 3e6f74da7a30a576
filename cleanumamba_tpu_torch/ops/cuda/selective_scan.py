"""K1 (forward selective scan) and K2 (its backward), dispatched by device.

``selective_scan`` launches the CUDA kernel K1 of ``csrc/selective_scan.cu``
(the port of ``cleanumamba_tpu/ops/pallas/selective_scan.py::pallas_selective_scan``)
for CUDA tensors and the plain chunked scan for CPU tensors;
``selective_scan_bwd`` does the same for K2 (the port of
``pallas_selective_scan_bwd``) and the plain reverse scan.  Contract as in
:mod:`cleanumamba_tpu_torch.ops.scan`.

``SelectiveScanFn`` is the scan's autograd: forward = K1 (or the plain scan)
saving each chunk's incoming state, backward = K2 (or the plain reverse
scan).  ``selective_scan_fn`` is what the model calls: it takes
``SelectiveScanFn`` when autograd records the call and the raw K1 wrapper
otherwise (serving, ``torch.no_grad()``).  The raw wrappers have no autograd
and raise if autograd would record them.
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

MAX_D_STATE = 256  # K1: 16 lanes x 16 state elements per thread (csrc/selective_scan.cu)
MAX_D_STATE_BWD = 128  # K2: h_{t-1} of a chunk must fit in shared memory
# Time steps per saved chunk state: K1 writes h_starts every SCAN_CHUNK steps
# (a multiple of its 16-step staging) and K2 keeps SCAN_CHUNK steps of
# h_{t-1} in shared memory (16 x 8 x 256 fp32 = 128 KB at d_state 128).
SCAN_CHUNK = 16
_THREADS, _LANES = 256, 16  # csrc/selective_scan.cu: kThreads, kLanes


def selective_scan_plain(u, dt, A, B, C, D=None, h0=None):
    """The plain version of K1: the chunked PyTorch scan."""
    return plain_scan.selective_scan(u, dt, A, B, C, D, h0)


def selective_scan_bwd_plain(u, dt, A, B, C, D, h_starts, gy, gh_last):
    """The plain version of K2: the chunked PyTorch reverse scan."""
    return plain_scan.selective_scan_bwd(u, dt, A, B, C, D, h_starts, gy, gh_last,
                                         chunk=SCAN_CHUNK)


@functools.cache
def _kernel():
    fn = load_library("selective_scan").selective_scan_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_bwd():
    fn = load_library("selective_scan").selective_scan_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _no_autograd(what, *tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no autograd: a gradient must go through SelectiveScanFn "
            "(selective_scan_fn), whose backward is K2")


def _check_inputs(what, u, dt, A, B, C, D, **state):
    """Dtypes, shapes and layout of the scan's inputs for the kernels."""
    Bsz, L, Di = u.shape
    Ds = A.shape[1]
    code = dtype_code(u, what)
    if B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"{what}: u, B, C must share a dtype, got {u.dtype}, {B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D), *state.items()):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    shapes = {"dt": (dt, (Bsz, L, Di)), "A": (A, (Di, Ds)), "B": (B, (Bsz, L, Ds)),
              "C": (C, (Bsz, L, Ds)), "D": (D, (Di,))}
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    require_cuda(what, u.device, u=u, dt=dt, A=A, B=B, C=C, D=D, **state)
    return code, Bsz, L, Di, Ds


def selective_scan(u, dt, A, B, C, D=None, h0=None, return_starts: bool = False):
    """y, h_last = scan(u, dt, A, B, C, D, h0): K1 for CUDA tensors, the
    plain chunked scan for CPU tensors.  With ``return_starts`` also the state
    entering each chunk of SCAN_CHUNK steps, h_starts (B, n_chunks, d_inner,
    d_state) fp32, which ``selective_scan_bwd`` needs.

    On CUDA: u, B, C fp32 or bf16 (one dtype); dt, A, D, h0 fp32; all
    contiguous; 1 <= d_state <= 256.  Anything else raises, as does a call
    that autograd would record.
    """
    _no_autograd("selective_scan (K1)", u, dt, A, B, C, D, h0)
    if u.device.type == "cpu":
        if return_starts:
            return plain_scan.selective_scan(u, dt, A, B, C, D, h0, chunk=SCAN_CHUNK,
                                             return_starts=True)
        return selective_scan_plain(u, dt, A, B, C, D, h0)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device {u.device}")
    what = "selective_scan"
    code, Bsz, L, Di, Ds = _check_inputs(what, u, dt, A, B, C, D, h0=h0)
    if not 1 <= Ds <= MAX_D_STATE:
        raise ValueError(f"{what}: d_state={Ds} outside [1, {MAX_D_STATE}]")
    if h0 is not None and tuple(h0.shape) != (Bsz, Di, Ds):
        raise ValueError(f"{what}: h0 has shape {tuple(h0.shape)}, expected {(Bsz, Di, Ds)}")

    if D is None:
        D = torch.zeros(Di, dtype=torch.float32, device=u.device)
    if h0 is None:
        h0 = torch.zeros((Bsz, Di, Ds), dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    h_last = torch.empty((Bsz, Di, Ds), dtype=torch.float32, device=u.device)
    n_chunks = -(-L // SCAN_CHUNK)
    h_starts = (torch.empty((Bsz, n_chunks, Di, Ds), dtype=torch.float32, device=u.device)
                if return_starts else None)
    out = (y, h_last, h_starts) if return_starts else (y, h_last)
    if Bsz == 0 or Di == 0:
        return out
    if L == 0:
        h_last.copy_(h0)
        return out
    status = _kernel()(code, ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D), ptr(h0),
                       ptr(y), ptr(h_last), ptr(h_starts), Bsz, L, Di, Ds, SCAN_CHUNK,
                       stream_ptr(u.device))
    check(status, "selective_scan_fwd")
    selective_scan.launches += 1
    return out


selective_scan.launches = 0


def selective_scan_bwd(u, dt, A, B, C, D, h_starts, gy, gh_last):
    """(gu, gdt, gA, gB, gC, gD, gh0), the VJP of the scan: K2 for CUDA
    tensors, the plain reverse scan for CPU tensors.  ``h_starts`` is what
    ``selective_scan(..., return_starts=True)`` returned on the same inputs.

    gu, gB, gC come back in the dtype of u, B, C; gdt, gA, gD, gh0 in fp32;
    gD is None when D is.  On CUDA: gy in u's dtype; dt, A, D, h_starts,
    gh_last fp32; all contiguous; 1 <= d_state <= 128.  Anything else raises.
    """
    _no_autograd("selective_scan_bwd (K2)", u, dt, A, B, C, D, gy, gh_last)
    if u.device.type == "cpu":
        return selective_scan_bwd_plain(u, dt, A, B, C, D, h_starts, gy, gh_last)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_bwd: no kernel for device {u.device}")
    what = "selective_scan_bwd"
    code, Bsz, L, Di, Ds = _check_inputs(what, u, dt, A, B, C, D, h_starts=h_starts,
                                         gh_last=gh_last)
    if not 1 <= Ds <= MAX_D_STATE_BWD:
        raise ValueError(f"{what}: d_state={Ds} outside [1, {MAX_D_STATE_BWD}]")
    if gy.dtype != u.dtype:
        raise TypeError(f"{what}: gy must have u's dtype {u.dtype}, got {gy.dtype}")
    n_chunks = -(-L // SCAN_CHUNK)
    shapes = {"gy": (gy, (Bsz, L, Di)), "gh_last": (gh_last, (Bsz, Di, Ds)),
              "h_starts": (h_starts, (Bsz, n_chunks, Di, Ds))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    require_cuda(what, u.device, gy=gy)
    if Bsz == 0 or L == 0 or Di == 0:
        raise ValueError(f"{what}: empty input {(Bsz, L, Di)}")

    dev, f32 = u.device, torch.float32
    Dv = torch.zeros(Di, dtype=f32, device=dev) if D is None else D
    n_groups = -(-Di // (_THREADS // _LANES))
    gu = torch.empty_like(u)
    gdt = torch.empty((Bsz, L, Di), dtype=f32, device=dev)
    gB = torch.empty_like(B)
    gC = torch.empty_like(C)
    gA = torch.empty((Di, Ds), dtype=f32, device=dev)
    gD = torch.empty(Di, dtype=f32, device=dev)
    gh0 = torch.empty((Bsz, Di, Ds), dtype=f32, device=dev)
    # per-block partials, summed in a second launch in one fixed order
    gB_part = torch.empty((Bsz, n_groups, L, Ds), dtype=f32, device=dev)
    gC_part = torch.empty_like(gB_part)
    gA_part = torch.empty((Bsz, Di, Ds), dtype=f32, device=dev)
    gD_part = torch.empty((Bsz, Di), dtype=f32, device=dev)
    status = _kernel_bwd()(
        code, ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(Dv), ptr(h_starts), ptr(gy),
        ptr(gh_last), ptr(gu), ptr(gdt), ptr(gB), ptr(gC), ptr(gA), ptr(gD), ptr(gh0),
        ptr(gB_part), ptr(gC_part), ptr(gA_part), ptr(gD_part), Bsz, L, Di, Ds, SCAN_CHUNK,
        stream_ptr(dev))
    check(status, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return gu, gdt, gA, gB, gC, (None if D is None else gD), gh0


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """(y, h_last) = scan(u, dt, A, B, C, D, h0) with a memory-bounded
    backward (port of ``selective_scan_auto``'s custom VJP): the forward
    saves only each chunk's incoming state, and the backward recomputes h
    chunk by chunk.  The device picks the path, in the two wrappers: K1/K2
    for CUDA tensors, the plain scans for CPU tensors.  It never autograds
    through the chunked scan, which would save every level of its pair scan.
    """

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, h0):
        y, h_last, h_starts = selective_scan(u, dt, A, B, C, D, h0, return_starts=True)
        ctx.save_for_backward(u, dt, A, B, C, D, h_starts)
        ctx.has_h0 = h0 is not None
        return y, h_last

    @staticmethod
    def backward(ctx, gy, gh_last):
        u, dt, A, B, C, D, h_starts = ctx.saved_tensors
        gu, gdt, gA, gB, gC, gD, gh0 = selective_scan_bwd(
            u, dt, A, B, C, D, h_starts, gy.to(u.dtype).contiguous(),
            gh_last.float().contiguous())
        return (gu, gdt.to(dt.dtype), gA.to(A.dtype), gB, gC,
                None if gD is None else gD.to(D.dtype), gh0 if ctx.has_h0 else None)


def selective_scan_fn(u, dt, A, B, C, D=None, h0=None):
    """The scan the model calls: ``SelectiveScanFn`` when autograd records
    this call, the raw K1 wrapper (no saved states) otherwise."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (u, dt, A, B, C, D, h0)):
        return SelectiveScanFn.apply(u, dt, A, B, C, D, h0)
    return selective_scan(u, dt, A, B, C, D, h0)
