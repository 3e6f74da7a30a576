"""Concurrent denoise sessions through one batched streaming step
(port of ``cleanumamba_tpu/serve.py``).

``SessionMultiplexer`` serves up to ``slots`` independent sessions with one
batched state: the weights are read once per tick whatever the number of
sessions riding it.

- **The state pool is one batched tree.**  Every streaming-state leaf is
  batch-leading (``streaming.py`` keeps even the normalisation EMA and its
  frame counter per session, (B, 1)), so admitting a session is one splice of
  row ``sid`` of a batched prime into the pool.  A leaf that does not lead
  with the batch (mamba_s4's discretised system) is the same for every
  session and is kept as it is.  The mha bottleneck's ring position is one
  for the whole batch, so an mha model cannot be served so (nor can it in
  the JAX package, whose splice fails on that leaf).
- **Sessions are mutually exact.**  Every op of prime and step is batch
  parallel: a session beside any other traffic gives the audio it gives
  alone.
- **Ticks never wait for a starved session.**  A tick consumes
  ``block * total_stride`` samples from every session that has them; the
  others ride the step on zeros, their output rows are dropped and their
  state rows are put back from a copy taken before the step (JAX keeps the
  old pool for free, its arrays being immutable; here the paused rows are
  copied, so nothing depends on whether the step writes into its input).
- Block 1 runs ``stream_step``; a larger block ``stream_step_block``, whose
  mamba bottleneck is one selective scan (K1 on CUDA) at batch = slots.  No
  level packs and no whole-frame kernel: the multiplexer steps the model as
  the JAX package's does.  The output comes to the host once per tick.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.params import (
    prepare_weight_view,
    resolve_device,
    to_device,
    tree_leaves,
    tree_unflatten,
)
from cleanumamba_tpu_torch.streaming import stream_prime, stream_step, stream_step_block


def _map_rows(fn, slots, a, b):
    """``fn`` over the paired leaves of two state trees of one structure that
    lead with the batch of ``slots``; any other leaf of ``a`` is kept."""
    return tree_unflatten(a, [fn(x, y) if x.ndim and x.shape[0] == slots else x
                              for x, y in zip(tree_leaves(a), tree_leaves(b))])


class SessionMultiplexer:
    """Serve up to ``slots`` concurrent denoise sessions from one model.

    slots:   batch width of the step (fixed at construction; pick it for the
             expected peak concurrency).
    block:   frames per tick.  1 = lowest latency; a larger block trades
             latency for throughput as ``Streamer``'s block path does.
    dtype:   state and activation dtype.
    weights: "fp32" | "bf16" | "int8" storage precision
             (``params.prepare_weight_view``; the view is applied in every
             prime and step call).
    device:  where the model runs; None means ``params.default_device()``.
    """

    def __init__(self, params, cfg: CleanUMambaConfig, slots: int = 8, block: int = 1,
                 dtype=torch.float32, weights: str = "fp32", device=None):
        if slots < 1 or block < 1:
            raise ValueError("slots and block must be >= 1")
        if cfg.bottleneck == "mha":
            raise ValueError("SessionMultiplexer: the mha bottleneck's KV ring position is one "
                             "for the whole batch, so its sessions cannot be multiplexed")
        self.cfg = cfg
        self.slots = slots
        self.block = block
        self.dtype = dtype
        self.tick_samples = block * cfg.total_stride
        self.device = resolve_device(device)
        self.params, self.view = prepare_weight_view(to_device(params, self.device), weights,
                                                     dtype)
        self.pool = None  # batched state tree, made at the first admission
        # host-side per-slot bookkeeping
        self._open = [False] * slots
        self._primed = [False] * slots
        self._buf: List[np.ndarray] = [np.zeros(0, np.float32)] * slots
        self._out: List[List[np.ndarray]] = [[] for _ in range(slots)]
        self._fed = [0] * slots
        self._emitted = [0] * slots
        self.ticks = 0

    # -- session lifecycle --------------------------------------------------

    def open(self) -> int:
        """Reserve a free slot; returns the session id (its slot index)."""
        for sid in range(self.slots):
            if not self._open[sid]:
                self._open[sid] = True
                self._primed[sid] = False
                self._buf[sid] = np.zeros(0, np.float32)
                self._out[sid] = []
                self._fed[sid] = 0
                self._emitted[sid] = 0
                return sid
        raise RuntimeError(f"all {self.slots} slots busy")

    def close(self, sid: int) -> None:
        """Release a slot.  Its state rows are stepped over zeros (finite)
        until the slot is admitted again, when the splice overwrites them."""
        self._check(sid)
        self._open[sid] = False
        self._primed[sid] = False
        self._buf[sid] = np.zeros(0, np.float32)
        self._out[sid] = []

    def feed(self, sid: int, samples: np.ndarray) -> np.ndarray:
        """Buffer raw samples for session ``sid``, advance the pool as far as
        the sessions' buffers allow, and return this session's denoised
        samples produced so far (possibly none: the output lags the input by
        the model's lookahead, as in ``Streamer``)."""
        self._check(sid)
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf[sid] = np.concatenate([self._buf[sid], samples])
        self._fed[sid] += samples.shape[0]
        self._pump()
        return self._drain(sid)

    def flush(self, sid: int) -> np.ndarray:
        """Zero-pad session ``sid`` until its whole input has been emitted
        (``Streamer.flush``), trimmed to the fed length.  Terminal: close the
        session afterwards.  Starved sessions pause; fed ones advance beside
        the padding ticks."""
        self._check(sid)
        want = self._fed[sid] - self._emitted[sid] - self._pending_out(sid)
        if want > 0:
            pad = self.cfg.frame_length + self.tick_samples
            self._buf[sid] = np.concatenate([self._buf[sid], np.zeros(pad, np.float32)])
            self._pump()
        out = self._drain(sid)
        keep = self._fed[sid] - self._emitted[sid] + out.shape[0]
        if keep < out.shape[0]:
            out = out[:max(0, keep)]
            self._emitted[sid] = self._fed[sid]
        return out

    @classmethod
    def from_bundle(cls, path: str, params) -> "SessionMultiplexer":
        """Serving from an exported bundle comes with the export port."""
        raise NotImplementedError(
            "SessionMultiplexer.from_bundle: exported bundles come with ROADMAP Queue 1 item 9b "
            "(export)")

    # -- internals ----------------------------------------------------------

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.slots and self._open[sid]):
            raise ValueError(f"session {sid} is not open")

    def _pending_out(self, sid: int) -> int:
        return sum(o.shape[0] for o in self._out[sid])

    def _drain(self, sid: int) -> np.ndarray:
        outs = self._out[sid]
        self._out[sid] = []
        if not outs:
            return np.zeros(0, np.float32)
        out = np.concatenate(outs)
        self._emitted[sid] += out.shape[0]
        return out

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit_ready(self) -> None:
        """Prime every buffering session that has a full first frame."""
        fl = self.cfg.frame_length
        for sid in range(self.slots):
            if not (self._open[sid] and not self._primed[sid]
                    and self._buf[sid].shape[0] >= fl):
                continue
            frames = np.zeros((self.slots, fl), np.float32)
            frames[sid] = self._buf[sid][:fl]
            self._buf[sid] = self._buf[sid][fl:]
            state, out = stream_prime(self.view(self.params), self.cfg, self._tensor(frames),
                                      self.dtype)
            if self.pool is None:
                self.pool = state
            else:  # batch-leading: one splice admits the session
                row = self._rows([sid])
                self.pool = _map_rows(lambda pool, one: pool.index_copy(0, row, one[sid:sid + 1]),
                                      self.slots, self.pool, state)
            self._out[sid].append(out[sid].float().cpu().numpy())
            self._primed[sid] = True

    def _rows(self, sids):
        return torch.tensor(sids, dtype=torch.long, device=self.device)

    def _pump(self) -> None:
        self._admit_ready()
        tick = self.tick_samples
        step = stream_step if self.block == 1 else stream_step_block
        while True:
            ready = [s for s in range(self.slots)
                     if self._primed[s] and self._buf[s].shape[0] >= tick]
            if not ready:
                return
            # primed but starved sessions must not advance: their rows ride the
            # step on zeros and are put back from a copy taken before it
            paused = [s for s in range(self.slots) if self._primed[s] and s not in ready]
            if paused:
                idx = self._rows(paused)
                saved = _map_rows(lambda t, _: t.index_select(0, idx), self.slots, self.pool,
                                  self.pool)
            new = np.zeros((self.slots, tick), np.float32)
            for s in ready:
                new[s] = self._buf[s][:tick]
                self._buf[s] = self._buf[s][tick:]
            self.pool, out = step(self.view(self.params), self.cfg, self.pool,
                                  self._tensor(new), self.dtype)
            if paused:
                self.pool = _map_rows(lambda post, pre: post.index_copy(0, idx, pre),
                                      self.slots, self.pool, saved)
            out = out.float().cpu().numpy()  # the tick's one copy to the host
            for s in ready:
                self._out[s].append(out[s])
            self.ticks += 1
            self._admit_ready()
