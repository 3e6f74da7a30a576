"""K7, rows of many tensors copied in one launch, dispatched by device.

A multiplexer's tick (``serve.py``) gathers the rows it steps from every
batch-leading leaf of its state pool (:func:`gather_rows`) and writes the
stepped rows back (:func:`scatter_rows`).  One int64 vector names the rows:
a row the tick serves as its index ``r``, a padding row, which rides the
step but is not written back, as ``~r`` (-1 - r).  On CUDA each call is one
launch of ``csrc/row_copy.cu`` (its own library) for up to ``MAX_SEGMENTS``
leaves; on the CPU the plain versions, one ``index_select`` or
``index_copy_`` a leaf.  A row outside the pool makes the plain versions
raise; the kernel copies nothing for it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cleanumamba_tpu_torch.ops.cuda.build import check, load_library, stream_ptr


MAX_SEGMENTS = 96  # the tensor pairs one launch takes (kMaxSegments, csrc/row_copy.cu)


@functools.cache
def _kernel():
    fn = load_library("row_copy").row_copy
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    return fn


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Whether each row of ``t`` (along dim 0) is one contiguous run."""
    return t[:1].is_contiguous() or t.shape[0] == 0


def _check(what, dsts, srcs, rows, pool):
    if len(dsts) != len(srcs):
        raise ValueError(f"{what}: {len(dsts)} destinations for {len(srcs)} sources")
    if len(dsts) > MAX_SEGMENTS:
        raise ValueError(f"{what}: {len(dsts)} tensors, more than the {MAX_SEGMENTS} a launch "
                         "takes")
    if rows.ndim != 1 or rows.dtype != torch.long:
        raise ValueError(f"{what}: rows is {tuple(rows.shape)} {rows.dtype}, expected a "
                         "vector of int64")
    n = pool[0].shape[0] if pool else 0
    for k, (d, s) in enumerate(zip(dsts, srcs)):
        if d.dtype != s.dtype or d.shape[1:] != s.shape[1:]:
            raise ValueError(f"{what}: pair {k} is {tuple(s.shape)} {s.dtype} into "
                             f"{tuple(d.shape)} {d.dtype}")
        p, t = (s, d) if pool is srcs else (d, s)
        if p.ndim == 0 or p.shape[0] != n or t.shape[0] != rows.shape[0]:
            raise ValueError(f"{what}: pair {k} is {tuple(s.shape)} into {tuple(d.shape)} for "
                             f"{rows.shape[0]} rows of a pool of {n}")


def _launch(what, dsts, srcs, rows, scatter):
    pool = dsts if scatter else srcs
    _check(what, dsts, srcs, rows, pool)
    if not dsts or dsts[0].device.type == "cpu":
        return False
    dev = dsts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    for name, t in [("dst", d) for d in dsts] + [("src", s) for s in srcs] + [("rows", rows)]:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")
    if not all(_rows_contiguous(d) for d in dsts):
        raise ValueError(f"{what}: each row of a destination must be contiguous")
    srcs = [s if _rows_contiguous(s) else s.contiguous() for s in srcs]
    n = len(dsts)
    arr, lla = ctypes.c_void_p * n, ctypes.c_longlong * n
    status = _kernel()(
        n, arr(*[s.data_ptr() for s in srcs]), arr(*[d.data_ptr() for d in dsts]),
        lla(*[s.stride(0) * s.element_size() for s in srcs]),
        lla(*[d.stride(0) * d.element_size() for d in dsts]),
        lla(*[d[:1].numel() * d.element_size() if d.shape[0] else 0 for d in dsts]),
        rows.data_ptr(), rows.shape[0], pool[0].shape[0], int(scatter), stream_ptr(dev))
    check(status, what)
    return True


def gather_rows(dsts, srcs, rows) -> None:
    """Row i of each ``dsts[k]`` = row ``rows[i]`` of ``srcs[k]`` (row ``~rows[i]``
    where it is negative).  The sources (the pool) share their number of
    rows; each destination has ``len(rows)``.  On CUDA one launch."""
    if _launch("gather_rows", dsts, srcs, rows, scatter=False):
        gather_rows.launches += 1
    elif dsts:
        gather_rows_ref(dsts, srcs, rows)


def scatter_rows(dsts, srcs, rows) -> None:
    """Row ``rows[i]`` of each ``dsts[k]`` = row i of ``srcs[k]``, for every
    ``rows[i] >= 0`` (distinct); the other rows of the destinations keep
    theirs.  The destinations (the pool) share their number of rows; each
    source has ``len(rows)``.  On CUDA one launch."""
    if _launch("scatter_rows", dsts, srcs, rows, scatter=True):
        scatter_rows.launches += 1
    elif dsts:
        scatter_rows_ref(dsts, srcs, rows)


def gather_rows_ref(dsts, srcs, rows) -> None:
    """The plain version of :func:`gather_rows`, for any device."""
    idx = torch.where(rows >= 0, rows, ~rows)
    for d, s in zip(dsts, srcs):
        d.copy_(s.index_select(0, idx))


def scatter_rows_ref(dsts, srcs, rows) -> None:
    """The plain version of :func:`scatter_rows`, for any device (the
    negative rows found on the host)."""
    keep = rows >= 0
    at = keep.nonzero()[:, 0]
    for d, s in zip(dsts, srcs):
        d.index_copy_(0, rows[keep], s.index_select(0, at))


# launches of the kernel; a launch recorded into a CUDA graph counts at each
# replay (graphs.StepGraphs)
gather_rows.launches = 0
scatter_rows.launches = 0
