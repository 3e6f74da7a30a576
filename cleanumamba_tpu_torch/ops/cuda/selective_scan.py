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
from typing import NamedTuple, Optional, Tuple

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
MAX_D_STATE_BWD = 128  # K2: 16 lanes x 8, so that a chunk of h_{t-1} fits in shared memory
_THREADS = 256  # csrc/selective_scan.cu: kThreads, kBwdThreads
_STAGE = 16  # its kSteps: K1 stages, and both kernels unroll, 16 time steps
LANE_CHOICES = (4, 8, 16)  # threads that share one channel's d_state
_MAX_NPT, _MAX_NPT_BWD = 16, 8  # state elements a thread may hold in K1, in K2
# 128 blocks of 256 threads put work on 128 of the card's 132 SMs: the fewest
# lanes that still give as many blocks make a thread's step the cheapest
_MIN_BLOCKS = 128
# channels whose gB/gC one cluster of K2 sums on chip, at most; on the card
# the wrapper halves the cluster until it costs no further wave (fit_cluster)
_CLUSTER_CHANNELS = 128
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


class ScanPlan(NamedTuple):
    """How a launch splits the work: ``lanes`` threads per channel with
    ``npt`` state elements each (lanes * npt >= d_state), ``256 // lanes``
    channels a block; K2's ``cluster`` blocks sum gB/gC together."""
    lanes: int
    npt: int
    blocks: int
    cluster: int

    @property
    def channels(self) -> int:
        return _THREADS // self.lanes


def scan_plan(Bsz: int, Di: int, Ds: int, bwd: bool = False) -> ScanPlan:
    """The split K1 (or, with ``bwd``, K2) is launched with: the fewest lanes
    per channel that leave at least 128 blocks and fit d_state in a thread's
    registers, else the most blocks (16 lanes)."""
    max_npt = _MAX_NPT_BWD if bwd else _MAX_NPT
    if not 1 <= Ds <= LANE_CHOICES[-1] * max_npt:
        raise ValueError(f"d_state={Ds} outside [1, {LANE_CHOICES[-1] * max_npt}]")
    for lanes in LANE_CHOICES:
        npt = 1 << max(-(-Ds // lanes) - 1, 0).bit_length()
        groups = -(-Di // (_THREADS // lanes))
        if npt <= max_npt and (Bsz * groups >= _MIN_BLOCKS or lanes == LANE_CHOICES[-1]):
            break
    per_cluster = max(_CLUSTER_CHANNELS // (_THREADS // lanes), 1)
    cluster = 1 << (min(per_cluster, max(groups, 1)).bit_length() - 1)
    return ScanPlan(lanes, npt, Bsz * groups, cluster)


def scan_chunk(Bsz: int, Di: int, Ds: int) -> int:
    """Time steps per saved chunk state for this shape: K1 writes h_starts
    every ``scan_chunk`` steps and K2 keeps that many steps of h_{t-1} in
    shared memory, 128 KB at most (256 threads x npt fp32 a step): 16 steps
    at 8 elements a thread, 32 below.  A multiple of the 16-step stage."""
    if Ds > MAX_D_STATE_BWD:  # forward only: K2 does not take it
        return _STAGE
    return _STAGE if scan_plan(Bsz, Di, Ds, bwd=True).npt == _MAX_NPT_BWD else 2 * _STAGE


def bwd_smem_bytes(lanes: int, npt: int, chunk: int, esize: int) -> int:
    """Shared memory K2 asks for (csrc/selective_scan.cu: bwd_smem_bytes)."""
    ch, sp = _THREADS // lanes, lanes * npt
    return (chunk * _THREADS * npt * 4  # h_{t-1} of the chunk
            + 2 * chunk * 2 * sp * 4  # the block's gB/gC sums, two chunks
            + 2 * chunk * ch * 4  # gu, gdt on their way out
            + 2 * chunk * ch * 4  # dt, two stages
            + 2 * 2 * chunk * sp * esize  # B, C, two stages
            + 2 * 2 * chunk * ch * esize)  # u, gy, two stages


def bwd_scratch_shapes(Bsz: int, L: int, Di: int, Ds: int, plan: ScanPlan | None = None) -> dict:
    """fp32 scratch of one K2 call: the clusters' gB/gC partials and the
    per-batch gA, gD, summed by K2's second launch."""
    plan = plan or scan_plan(Bsz, Di, Ds, bwd=True)
    n_clusters = -(-(plan.blocks // Bsz) // plan.cluster)
    return {"part": (2, Bsz, n_clusters, L, Ds), "gA_part": (Bsz, Di, Ds),
            "gD_part": (Bsz, Di)}


def selective_scan_plain(u, dt, A, B, C, D=None, h0=None):
    """The plain version of K1: the chunked PyTorch scan."""
    return plain_scan.selective_scan(u, dt, A, B, C, D, h0)


def selective_scan_bwd_plain(u, dt, A, B, C, D, h_starts, gy, gh_last):
    """The plain version of K2: the chunked PyTorch reverse scan."""
    Bsz, _, Di = u.shape
    return plain_scan.selective_scan_bwd(u, dt, A, B, C, D, h_starts, gy, gh_last,
                                         chunk=scan_chunk(Bsz, Di, A.shape[1]))


@functools.cache
def _kernel():
    fn = load_library("selective_scan").selective_scan_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_bwd():
    fn = load_library("selective_scan").selective_scan_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def clusters_at_once(code: int, Ds: int, chunk: int, lanes: int, cluster: int) -> int:
    """K2's clusters of this size that the card holds at once."""
    fn = load_library("selective_scan").selective_scan_bwd_clusters_at_once
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    n = fn(code, Ds, chunk, lanes, cluster)
    if n < 0:
        raise RuntimeError(f"selective_scan_bwd_clusters_at_once: CUDA error {-n}")
    return n


def fit_cluster(plan: ScanPlan, Bsz: int, code: int, Ds: int, chunk: int) -> ScanPlan:
    """The plan with the largest cluster that costs no wave more than blocks
    alone would: a cluster must find all its SMs free at once in one part of
    the card, and at the training shape clusters of four did not all fit
    (two waves, twice the time) where clusters of two did."""
    def waves(cluster):
        at_once = clusters_at_once(code, Ds, chunk, plan.lanes, cluster)
        needed = Bsz * -(-(plan.blocks // Bsz) // cluster)
        return -(-needed // at_once) if at_once > 0 else float("inf")

    cluster, least = plan.cluster, waves(1)
    while cluster > 1 and waves(cluster) > least:
        cluster //= 2
    return plan._replace(cluster=cluster)


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
    entering each chunk of ``scan_chunk(B, d_inner, d_state)`` steps, h_starts
    (B, n_chunks, d_inner, d_state) fp32, which ``selective_scan_bwd`` needs.

    On CUDA: u, B, C fp32 or bf16 (one dtype); dt, A, D, h0 fp32; all
    contiguous; 1 <= d_state <= 256.  Anything else raises, as does a call
    that autograd would record.  The call goes through the custom op
    ``torch.ops.cleanumamba.selective_scan``, so ``torch.export`` traces it
    as one node on either device.
    """
    _no_autograd("selective_scan (K1)", u, dt, A, B, C, D, h0)
    y, h_last, h_starts = _scan_op(u, dt, A, B, C, D, h0, return_starts)
    return (y, h_last, h_starts) if return_starts else (y, h_last)


# launches on the card: a launch recorded into a CUDA graph counts at each
# replay (graphs.StepGraphs), not at the capture
selective_scan.launches = 0


def _check_fwd(u, dt, A, B, C, D, h0):
    what = "selective_scan"
    code, Bsz, L, Di, Ds = _check_inputs(what, u, dt, A, B, C, D, h0=h0)
    if not 1 <= Ds <= MAX_D_STATE:
        raise ValueError(f"{what}: d_state={Ds} outside [1, {MAX_D_STATE}]")
    if h0 is not None and tuple(h0.shape) != (Bsz, Di, Ds):
        raise ValueError(f"{what}: h0 has shape {tuple(h0.shape)}, expected {(Bsz, Di, Ds)}")
    return code, Bsz, L, Di, Ds


def _fwd_outputs(u, Ds, return_starts):
    """Empty (y, h_last, h_starts) of K1's shapes; h_starts has no chunk
    when it is not asked for (a custom op returns tensors, not None)."""
    Bsz, L, Di = u.shape
    n_chunks = -(-L // scan_chunk(Bsz, Di, Ds)) if return_starts else 0
    f32 = dict(dtype=torch.float32, device=u.device)
    return (torch.empty_like(u), torch.empty((Bsz, Di, Ds), **f32),
            torch.empty((Bsz, n_chunks, Di, Ds), **f32))


@torch.library.custom_op("cleanumamba::selective_scan", mutates_args=(), device_types="cpu")
def _scan_op(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: Optional[torch.Tensor], h0: Optional[torch.Tensor],
             return_starts: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain chunked scan (its chunk states
    at K1's chunk, which K2's plain version reads)."""
    Bsz, L, Di = u.shape
    Ds = A.shape[1]
    if return_starts:
        y, h_last, h_starts = plain_scan.selective_scan(
            u, dt, A, B, C, D, h0, chunk=scan_chunk(Bsz, Di, Ds), return_starts=True)
    else:
        (y, h_last), h_starts = selective_scan_plain(u, dt, A, B, C, D, h0), \
            u.new_empty((Bsz, 0, Di, Ds), dtype=torch.float32)
    # an op's output is a tensor of its own, as its fake implementation says:
    # not h0 (L == 0), nor a view into the last chunk's states
    return y, h_last.clone(memory_format=torch.contiguous_format), h_starts


@_scan_op.register_kernel("cuda")
def _scan_op_cuda(u, dt, A, B, C, D, h0, return_starts):
    """The op's CUDA implementation: K1 through its ctypes entry point."""
    code, Bsz, L, Di, Ds = _check_fwd(u, dt, A, B, C, D, h0)
    y, h_last, h_starts = _fwd_outputs(u, Ds, return_starts)
    if Bsz == 0 or Di == 0:
        return y, h_last, h_starts
    if L == 0:
        if h0 is None:
            h_last.zero_()
        else:
            h_last.copy_(h0)
        return y, h_last, h_starts
    # an absent D or h0 goes in as a null pointer: the kernel reads zeros
    status = _kernel()(code, ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D), ptr(h0),
                       ptr(y), ptr(h_last), ptr(h_starts) if return_starts else None,
                       Bsz, L, Di, Ds, scan_chunk(Bsz, Di, Ds),
                       scan_plan(Bsz, Di, Ds).lanes, stream_ptr(u.device))
    check(status, "selective_scan_fwd")
    selective_scan.launches += 1
    return y, h_last, h_starts


@_scan_op.register_fake
def _scan_op_fake(u, dt, A, B, C, D, h0, return_starts):
    """Shapes and dtypes of the op's outputs, for tracing (``torch.export``)."""
    if u.device.type == "cuda":
        _check_fwd(u, dt, A, B, C, D, h0)
    return _fwd_outputs(u, A.shape[1], return_starts)


def selective_scan_bwd(u, dt, A, B, C, D, h_starts, gy, gh_last, cluster: int | None = None):
    """(gu, gdt, gA, gB, gC, gD, gh0), the VJP of the scan: K2 for CUDA
    tensors, the plain reverse scan for CPU tensors.  ``h_starts`` is what
    ``selective_scan(..., return_starts=True)`` returned on the same inputs.

    gu, gB, gC come back in the dtype of u, B, C; gdt, gA, gD, gh0 in fp32;
    gD is None when D is.  On CUDA: gy in u's dtype; dt, A, D, h_starts,
    gh_last fp32; all contiguous; 1 <= d_state <= 128.  Anything else raises.
    ``cluster`` (1, 2, 4 or 8) overrides the plan's cluster size on CUDA, for
    measurements; the gradients are the same sums in another grouping.
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
    chunk = scan_chunk(Bsz, Di, Ds)
    n_chunks = -(-L // chunk)
    shapes = {"gy": (gy, (Bsz, L, Di)), "gh_last": (gh_last, (Bsz, Di, Ds)),
              "h_starts": (h_starts, (Bsz, n_chunks, Di, Ds))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    require_cuda(what, u.device, gy=gy)
    if Bsz == 0 or L == 0 or Di == 0:
        raise ValueError(f"{what}: empty input {(Bsz, L, Di)}")

    dev, f32 = u.device, torch.float32
    plan = scan_plan(Bsz, Di, Ds, bwd=True)
    plan = (fit_cluster(plan, Bsz, code, Ds, chunk) if cluster is None
            else plan._replace(cluster=cluster))
    gu = torch.empty_like(u)
    gdt = torch.empty((Bsz, L, Di), dtype=f32, device=dev)
    gB = torch.empty_like(B)
    gC = torch.empty_like(C)
    gA = torch.empty((Di, Ds), dtype=f32, device=dev)
    gD = torch.empty(Di, dtype=f32, device=dev)
    gh0 = torch.empty((Bsz, Di, Ds), dtype=f32, device=dev)
    # partial sums, added up by K2's second launch in one fixed order
    scratch = {name: torch.empty(shape, dtype=f32, device=dev)
               for name, shape in bwd_scratch_shapes(Bsz, L, Di, Ds, plan).items()}
    status = _kernel_bwd()(
        code, ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D), ptr(h_starts), ptr(gy),
        ptr(gh_last), ptr(gu), ptr(gdt), ptr(gB), ptr(gC), ptr(gA), ptr(gD), ptr(gh0),
        ptr(scratch["part"]), ptr(scratch["gA_part"]), ptr(scratch["gD_part"]), Bsz, L, Di, Ds,
        chunk, plan.lanes, plan.cluster, stream_ptr(dev))
    check(status, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return gu, gdt, gA, gB, gC, (None if D is None else gD), gh0


# as selective_scan.launches
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
