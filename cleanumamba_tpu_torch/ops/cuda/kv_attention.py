"""K6, one token of causal multi-head attention over per-row KV rings,
dispatched by device.

``kv_attention`` launches the CUDA kernel of ``csrc/kv_attention.cu`` for
CUDA tensors and runs :func:`kv_attention_ref`, its plain version, for CPU
tensors.  The mha bottleneck's streaming step calls it once a layer
(``models/bottleneck_mha.py``); a multiplexer's tick runs it inside its
graph.  The kernel has its own library, so only a model with an mha
bottleneck builds it.
"""

from __future__ import annotations

import functools
import math

import torch

from cleanumamba_tpu_torch.ops.cuda.build import (
    check,
    dtype_code,
    load_library,
    require_cuda,
    stream_ptr,
)

# the d_k the kernel is built for: CleanUNet's and E8's 64, the released
# small geometry's 8, the test configurations' 8 and 16
HEAD_WIDTHS = (8, 16, 64)


def max_window(dk: int) -> int:
    """The longest ring the kernel takes at heads of ``dk``: a block of at
    most 1024 threads holds ceil(W / 8) slots of dk / min(dk, 16) threads
    each (``csrc/kv_attention.cu``)."""
    return 8 * (1024 // (dk // min(dk, 16)))


@functools.cache
def _kernel():
    import ctypes

    fn = load_library("kv_attention").kv_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _check(q, k, v, k_ring, v_ring, pos, n_head):
    B, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"kv_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} differ")
    if k_ring.shape != v_ring.shape or k_ring.shape[0] != B or k_ring.shape[2] != d:
        raise ValueError(f"kv_attention: rings {tuple(k_ring.shape)} / {tuple(v_ring.shape)} "
                         f"for q {tuple(q.shape)}")
    if k_ring.stride() != v_ring.stride() or k_ring.stride()[1:] != (d, 1):
        raise ValueError("kv_attention: each ring row must be W contiguous slots of d values, "
                         "the two rings alike")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"kv_attention: pos is {tuple(pos.shape)} {pos.dtype}, "
                         f"expected ({B},) int32")
    if d % n_head:
        raise ValueError(f"kv_attention: d_model {d} is not a multiple of {n_head} heads")


def kv_attention(q, k, v, k_ring, v_ring, pos, n_head: int):
    """One attention step of every row, the rings written in place.

    q, k, v: (B, d) this token's query, key and value; k_ring, v_ring: (B, W,
    d) the rows' rings (a view of a larger cache will do: each row W
    contiguous slots); pos: (B,) int32, the tokens each row has written.  For
    every row: k and v written at slot ``pos mod W``, and the output is the
    softmax attention of q over the row's ``min(pos + 1, W)`` valid slots,
    computed in fp32.  Returns (B, d) in q's dtype; ``pos`` is left to the
    caller to advance.
    """
    _check(q, k, v, k_ring, v_ring, pos, n_head)
    if q.device.type == "cpu":
        return kv_attention_ref(q, k, v, k_ring, v_ring, pos, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"kv_attention: no kernel for device {q.device}")
    B, W, d = k_ring.shape
    dk = d // n_head
    if dk not in HEAD_WIDTHS or W > max_window(dk):
        raise ValueError(f"kv_attention: heads of {dk} (one of {HEAD_WIDTHS}) and a ring of {W} "
                         f"slots (at most {max_window(dk) if dk in HEAD_WIDTHS else '-'})")
    dt = dtype_code(q, "kv_attention")
    esize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("k_ring", k_ring), ("v_ring", v_ring)):
        if t.dtype != q.dtype:
            raise TypeError(f"kv_attention: {name} is {t.dtype}, q {q.dtype}")
        if t.data_ptr() % 16 or (t.stride(0) * esize) % 16 or (dk * esize) % 16:
            raise ValueError(f"kv_attention: every row of {name} and each head in it must start "
                             "on 16 bytes")
    dev = q.device
    require_cuda("kv_attention", dev, q=q, k=k, v=v, pos=pos)
    if k_ring.device != dev or v_ring.device != dev:
        raise ValueError(f"kv_attention: the rings must lie on {dev}")
    out = torch.empty_like(q)
    status = _kernel()(dt, q.data_ptr(), k.data_ptr(), v.data_ptr(), k_ring.data_ptr(),
                       v_ring.data_ptr(), k_ring.stride(0), pos.data_ptr(), out.data_ptr(), B,
                       n_head, W, d, stream_ptr(dev))
    check(status, "kv_attention")
    kv_attention.launches += 1
    return out


def kv_attention_ref(q, k, v, k_ring, v_ring, pos, n_head: int):
    """The plain version of :func:`kv_attention`, for any device."""
    B, W, d = k_ring.shape
    dk = d // n_head
    slot = (pos % W).long()
    rows = torch.arange(B, device=q.device)
    k_ring[rows, slot] = k
    v_ring[rows, slot] = v
    valid = torch.arange(W, device=q.device)[None, :] < torch.clamp(pos + 1, max=W)[:, None]
    logits = torch.einsum("bhc,bshc->bhs", q.reshape(B, n_head, dk).float(),
                          k_ring.reshape(B, W, n_head, dk).float()) / math.sqrt(dk)
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    out = torch.einsum("bhs,bshc->bhc", torch.softmax(logits, dim=-1),
                       v_ring.reshape(B, W, n_head, dk).float()).reshape(B, d)
    return out.to(q.dtype)


# launches of the kernel; a launch recorded into a CUDA graph counts at each
# replay (graphs.StepGraphs)
kv_attention.launches = 0
