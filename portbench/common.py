"""Helpers the drivers share: the real-time wait, tails, the device record,
the output comparison."""

from __future__ import annotations

import gc
import time

import numpy as np


def wait_until(t: float) -> None:
    """Return at host-clock time ``t``, spinning: a client that sleeps between
    hops lets its core idle, and the next feed then starts cold (a live
    call's tail spread 2x between runs of one seed that slept)."""
    while time.perf_counter() < t:
        pass


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def device_record(device) -> dict:
    """The ``device`` object of the result line of a one-card cell (the peak
    since the process started, on the card)."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def release(device) -> None:
    """Give the program's freed memory back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| / max |ref|; inf when the shapes differ or a value is
    not finite."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def backlog_grows(lateness, hop_s: float) -> bool:
    """True when the last third of the window's hops ran later than the first
    third by more than one hop: the queue grew."""
    n = len(lateness)
    if n < 6:
        return False
    a, b = np.median(lateness[: n // 3]), np.median(lateness[-(n // 3):])
    return bool(b - a > hop_s)
