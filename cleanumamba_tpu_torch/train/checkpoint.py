"""Training checkpoints (port of ``cleanumamba_tpu/train/checkpoint.py``).

The payload is the JAX package's: a pickled dict with ``iter``, ``run_id``,
``network_config`` (reference JSON), ``bottleneck``, ``params`` (numpy
leaves, bf16 widened to fp32), ``opt_state`` and ``training_time_seconds``,
saved as ``{iter}.pkl``.  So the JAX package's ``load_checkpoint`` reads a
checkpoint the port wrote, and the reverse.  ``opt_state`` is in the port's
layout (``train/optim.py``): it resumes within the port.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.params import from_numpy, payload_config, resolve_device, to_numpy


def find_max_epoch(path: str) -> int:
    """Latest ``{n}.pkl`` iteration in a directory, -1 if none."""
    if not os.path.isdir(path):
        return -1
    epoch = -1
    for f in os.listdir(path):
        if f.endswith(".pkl"):
            try:
                epoch = max(epoch, int(f[:-4]))
            except ValueError:
                continue
    return epoch


def save_checkpoint(directory: str, step: int, params: Any, opt_state: Any = None,
                    cfg: Optional[CleanUMambaConfig] = None, run_id: Optional[str] = None,
                    training_time_seconds: float = 0.0, extra: Optional[dict] = None) -> str:
    """Write ``{directory}/{step}.pkl`` atomically; returns its path."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "iter": step,
        "run_id": run_id,
        "network_config": cfg.to_reference_json() if cfg is not None else None,
        "bottleneck": cfg.bottleneck if cfg is not None else None,
        "params": to_numpy(params),
        "opt_state": _host_opt_state(opt_state) if opt_state is not None else None,
        "training_time_seconds": training_time_seconds,
    }
    if extra:
        payload.update(extra)
    path = os.path.join(directory, f"{step}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def _host_opt_state(opt_state):
    """The optimizer state as numpy leaves, its step ``count`` (a device
    tensor in ``train/optim.py``) as the Python int the payload has always
    held."""
    state = to_numpy(opt_state)
    if isinstance(state, dict) and "count" in state:
        state["count"] = int(state["count"])
    return state


def load_checkpoint(path: str, device=None) -> dict:
    """The payload with ``params`` and ``opt_state`` as torch tensors on
    ``device`` (None: ``params.default_device()``), plus ``config`` (a
    CleanUMambaConfig) when it has a network_config.  Only load checkpoints
    this project wrote: unpickling runs code."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    for key in ("params", "opt_state"):
        if payload.get(key) is not None:
            payload[key] = from_numpy(payload[key], device)
    if payload.get("network_config") is not None:
        payload["config"] = payload_config(payload)
    return payload


def load_latest(directory: str, device=None) -> Optional[dict]:
    step = find_max_epoch(directory)
    if step < 0:
        return None
    return load_checkpoint(os.path.join(directory, f"{step}.pkl"), device)
