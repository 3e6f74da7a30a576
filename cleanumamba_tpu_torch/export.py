"""Ahead-of-time serving export: the traced model as a portable artifact
(port of ``cleanumamba_tpu/export.py``).

The offline forward and the streaming prime and step are traced with
``torch.export.export`` into ``.pt2`` archives, so a serving process runs
them without the model-definition code: it needs the weight tree, this
bundle and the kernels' op library.

- **Weights stay call arguments**, not constants baked into the graph: one
  artifact serves every checkpoint of the same geometry, and it stays small.
  A ragged pruned checkpoint has its shapes traced into the artifact.
- **The streaming step is stateless**: ``(params, state, samples) ->
  (state', out)`` with the state tree in the open, so the serving loop owns
  each session's state and one artifact serves many streams.  An mha
  model's step is not (it writes its KV rings in place, through K6, which
  is no custom op), so :func:`export_stream` refuses it; its offline
  forward exports.
- **Tied to the op library, as the JAX bundle is to libtpu.**  The selective
  scan enters the graph as the custom op ``cleanumamba::selective_scan``
  (``ops/cuda/selective_scan.py``): on CUDA its implementation launches K1,
  on the CPU it runs the plain scan.  :func:`load_bundle` imports that one
  module to register the op and imports no model code.  A bundle records the
  device it was traced on and runs there.
- A JAX bundle (StableHLO, ``.shlo``) cannot be loaded by this package, nor
  this package's bundle by JAX: the schema of ``bundle.json`` is the same,
  the programs are not.

Bundle layout (a directory)::

    bundle.json   config fields, torch version, the function table (file,
                  device, input shapes), batch and block
    offline.pt2   forward(params, x) for a fixed (batch, length)
    prime.pt2     stream_prime(params, frame)
    step.pt2      stream_step(params, state, new_samples) at block 1, or
                  stream_step_block at block N

A loaded function re-runs the traced graph: on the CPU it equals the eager
call bit for bit (``tests/test_torch_export.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional

import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.params import tensor_leaves

_BUNDLE_VERSION = 1


class _Traced(torch.nn.Module):
    """``fn`` as a module with no parameters of its own: every weight comes
    in as an argument."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export_fn(fn: Callable, *args) -> torch.export.ExportedProgram:
    """Trace ``fn(*args)`` for inference.  ``args`` are example inputs on the
    device to trace for (their values are not baked in)."""
    with torch.no_grad():
        return torch.export.export(_Traced(fn), args)


def _device_of(params) -> torch.device:
    return tensor_leaves(params)[0].device


def export_offline(params, cfg: CleanUMambaConfig, length: int,
                   batch: int = 1) -> torch.export.ExportedProgram:
    """``forward(params, x)`` for a fixed (batch, length) fp32 input, on the
    params' device.  A mamba_s4 model's kernels must already cover the
    length (``prepare_for_length``)."""
    from cleanumamba_tpu_torch.models.cleanumamba import forward

    x = torch.zeros((batch, length), dtype=torch.float32, device=_device_of(params))
    return _export_fn(lambda p, a: forward(p, a, cfg), params, x)


def export_stream(params, cfg: CleanUMambaConfig, batch: int = 1, block: int = 1):
    """Export (prime, step) for streaming serving, on the params' device.

    prime takes the first ``frame_length`` raw samples and returns
    ``(state, out)``; step takes ``block * total_stride`` new samples and
    returns ``(state', out)``: ``stream_step`` at block 1,
    ``stream_step_block`` (one selective scan per layer over the block) above.
    An mha model is refused: its step writes the state's KV rings in place.
    """
    from cleanumamba_tpu_torch.streaming import stream_prime, stream_step, stream_step_block

    if cfg.bottleneck == "mha":
        raise ValueError("export_stream: an mha model's step writes its KV rings in place "
                         "(K6), so it has no stateless step to export; serve it from the live "
                         "functions (SessionMultiplexer, Streamer)")
    dev = _device_of(params)
    frame = torch.zeros((batch, cfg.frame_length), dtype=torch.float32, device=dev)
    prime_exp = _export_fn(lambda p, f: stream_prime(p, cfg, f), params, frame)
    with torch.no_grad():
        state, _ = stream_prime(params, cfg, frame)
    step = stream_step if block == 1 else stream_step_block
    new = torch.zeros((batch, block * cfg.total_stride), dtype=torch.float32, device=dev)
    step_exp = _export_fn(lambda p, s, n: step(p, cfg, s, n), params, state, new)
    return prime_exp, step_exp


def _user_inputs(exp: torch.export.ExportedProgram):
    """The traced values of the program's inputs, flattened in call order."""
    names = set(exp.graph_signature.user_inputs)
    return [n.meta["val"] for n in exp.graph.nodes if n.op == "placeholder" and n.name in names]


def save_bundle(path: str, cfg: CleanUMambaConfig,
                exported: Dict[str, torch.export.ExportedProgram],
                extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a bundle directory: one ``.pt2`` per function + ``bundle.json``."""
    os.makedirs(path, exist_ok=True)
    table = {}
    for name, exp in exported.items():
        fname = f"{name}.pt2"
        torch.export.save(exp, os.path.join(path, fname))
        vals = _user_inputs(exp)
        table[name] = {
            "file": fname,
            "device": str(vals[-1].device),
            "in_shapes": [f"{str(v.dtype).removeprefix('torch.')}{list(v.shape)}"
                          for v in vals],
        }
    meta = {
        "bundle_version": _BUNDLE_VERSION,
        "torch_version": torch.__version__,
        "config": dataclasses.asdict(cfg),
        "functions": table,
    }
    # batch/block are schema fields (SessionMultiplexer.from_bundle sizes its
    # slot pool from them), derived from the traced shapes: the last input of
    # each function is its raw audio, step's (batch, block * total_stride),
    # prime's frame and offline's x (batch, ...)
    for name in ("step", "prime", "offline"):
        if name in exported:
            b, width = _user_inputs(exported[name])[-1].shape
            meta["batch"] = int(b)
            if name == "step":
                meta["block"] = int(width) // cfg.total_stride
            break
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, "bundle.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_bundle(path: str):
    """Load a bundle: returns ``(cfg, {name: callable})``.

    The callables take the arguments the functions were traced with, e.g.
    ``fns["step"](params, state, new_samples)``, on the device the bundle
    was traced on.  No model-definition code is imported: only the op
    library of the kernels (``ops/cuda/selective_scan.py``) is registered.
    """
    # registers cleanumamba::selective_scan, which the programs call
    import cleanumamba_tpu_torch.ops.cuda.selective_scan  # noqa: F401

    with open(os.path.join(path, "bundle.json")) as f:
        meta = json.load(f)
    if meta["bundle_version"] != _BUNDLE_VERSION:
        raise ValueError(f"unsupported bundle version {meta['bundle_version']}")
    cfg = CleanUMambaConfig(**meta["config"])
    fns = {}
    for name, entry in meta["functions"].items():
        fns[name] = torch.export.load(os.path.join(path, entry["file"])).module()
    return cfg, fns
