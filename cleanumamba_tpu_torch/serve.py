"""Concurrent denoise sessions through one batched streaming step
(port of ``cleanumamba_tpu/serve.py``).

``SessionMultiplexer`` serves up to ``slots`` independent sessions with one
batched state: the weights are read once per tick whatever the number of
sessions riding it.

- **The state pool is one batched tree.**  Every streaming-state leaf is
  batch-leading (``streaming.py`` keeps even the normalisation EMA and its
  frame counter per session, (B, 1); the mha bottleneck's KV rings and each
  row's position), so admitting a session is one splice of row ``sid`` of a
  batched prime into the pool.  A leaf that does not lead with the batch
  (mamba_s4's discretised system) is the same for every session and is kept
  as it is.  (The JAX package cannot serve mha: its ring position is one
  for the whole batch.)
- **Sessions are mutually exact.**  Every op of prime and step is batch
  parallel: a session beside any other traffic gives the audio it gives
  alone, within the tests' 1e-5 (a row's sums may follow the width of the
  tick it rode in: a matrix product at 1 row and at 4 need not round
  alike).
- **A tick steps only the rows it serves.**  A tick consumes ``block *
  total_stride`` samples from every session that has them (its ``n`` live
  rows) and runs the step at width ``w``: the smallest power of two >= n,
  or ``slots`` where that is larger (at most ceil(log2 slots) + 1 widths);
  a bundle's callables (``fns``), traced at batch = slots, tick at
  ``slots``.  Every tick gathers its rows of every batch-leading leaf of
  the pool: the live rows and ``w - n`` rows outside the tick (paused
  sessions, free slots), which ride the step on zeros.  It writes back the
  live rows alone (``graphs.Rows``: a padding row is named ``~row``, which
  the write-back skips), so every other row, padding rows included, is
  bitwise what it was, an mha row's rings too (the step writes the
  gathered copy); the gather and the write-back are one launch each on a
  card (K7, ``ops/cuda/row_copy.py``).  ``rows_stepped`` sums the widths
  run.
- **One graph a width on a card.**  On a CUDA device prime (at batch =
  slots) and each width's tick run as CUDA graphs (``graphs.StepGraphs``,
  one memory pool a multiplexer; each eager at its first call, captured at
  its second: the tick's row indices are an input, so each width is its
  own key); the pool is the graphs' static state, written in place by each
  tick, and admitting a session is one ``index_copy_`` of its row into it,
  outside the graphs.
  On the CPU both run eagerly, and a tick writes into a copy of the pool:
  a new pool tree, the one it read left alone.
- Block 1 runs ``stream_step`` with every encoder and decoder level that
  ``pack_stream_params`` packs as the fused level kernels (K3/K4 on CUDA,
  their plain versions on the CPU) at the tick's width, inside the tick's
  graph; each pack's scratch is sized for ``slots`` rows when the levels
  are packed, so no later width regrows one under a captured graph.
  The packs compute in ``dtype`` and keep each weight as stored (bf16
  weights stay bf16 in an fp32 pack); the weights the step reads beside
  them are held in ``dtype`` where that is fp32 (``streaming.step_weights``:
  no tick casts a weight); int8 weights pack only where
  ``dtype`` is bf16, as an int8 pack computes in bf16.  A larger block runs
  ``stream_step_block``, whose mamba bottleneck is one selective scan (K1 on
  CUDA) at the tick's width, with no packs.  No whole-frame kernel.  The
  output comes to the host once per tick, ``w`` rows.
- **Artifact-driven.**  ``SessionMultiplexer.from_bundle`` serves the prime
  and step of an exported bundle (``export.py``): the serving process
  imports no model code; the live-function constructor is the development
  path.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cleanumamba_tpu_torch import tracing
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.graphs import Rows, StepGraphs, own, step_in_place
from cleanumamba_tpu_torch.ops.cuda.row_copy import gather_rows
from cleanumamba_tpu_torch.params import (
    prepare_weight_view,
    resolve_device,
    to_device,
    tree_leaves,
    tree_unflatten,
)


def _map_rows(fn, slots, a, b):
    """``fn`` over the paired leaves of two state trees of one structure that
    lead with the batch of ``slots``; any other leaf of ``a`` is kept."""
    return tree_unflatten(a, [fn(x, y) if x.ndim and x.shape[0] == slots else x
                              for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tick_width(n: int, slots: int) -> int:
    """The width a tick of ``n`` live rows runs at: the smallest power of two
    >= n, or ``slots`` where that is larger."""
    return min(1 << (n - 1).bit_length(), slots)


class SessionMultiplexer:
    """Serve up to ``slots`` concurrent denoise sessions from one model.

    slots:   batch width of the step (fixed at construction; pick it for the
             expected peak concurrency).
    block:   frames per tick.  1 = lowest latency; a larger block trades
             latency for throughput as ``Streamer``'s block path does.
    dtype:   state and activation dtype.
    weights: "fp32" | "bf16" | "int8" storage precision
             (``params.prepare_weight_view``; the int8 view dequantizes in
             every prime and step call); must be "fp32" when ``fns`` is
             given.  Where ``dtype`` is fp32, every bf16 weight outside the
             level packs is widened to fp32 once, at construction
             (``streaming.step_weights``: exact, so no tick casts a weight).
    device:  where the model runs; None means ``params.default_device()``.
    fns:     optional ``{"prime": f, "step": g}`` in place of the live
             functions, e.g. the callables of an exported bundle whose traced
             batch and block are ``slots`` and ``block`` (:meth:`from_bundle`);
             they take ``(params, frame)`` and ``(params, state, samples)``.
             Not for an mha model, which has no bundle.

    ``packed_levels``: the encoder and decoder levels every tick runs
    through the fused level kernels (0 on the per-op path).  ``kv_window``:
    the tokens an mha session attends to (``bottleneck_mha.mha_max_len``; 0
    for the other bottlenecks).  ``widened``: the weight leaves held in the
    compute dtype instead of cast in every tick (0 for fp32 or int8 weights,
    bf16 state and a bundle's callables).  Counters, on the host: ``ticks``;
    ``rows_stepped``, the widths the ticks ran at, summed (``ticks`` x
    ``slots`` for a bundle's callables); for an mha model ``kv_positions``,
    the window lengths the live rows attended to, summed over the tokens of
    every tick.
    """

    def __init__(self, params, cfg: CleanUMambaConfig, slots: int = 8, block: int = 1,
                 dtype=torch.float32, weights: str = "fp32", device=None,
                 fns: Optional[Dict[str, Callable]] = None):
        if slots < 1 or block < 1:
            raise ValueError("slots and block must be >= 1")
        self.cfg = cfg
        self.slots = slots
        self.block = block
        self.dtype = dtype
        self.tick_samples = block * cfg.total_stride
        self.device = resolve_device(device)
        self.packed_levels = 0
        self.kv_window = 0
        if cfg.bottleneck == "mha":
            from cleanumamba_tpu_torch.models.bottleneck_mha import mha_max_len

            self.kv_window = mha_max_len(cfg)
        if fns is not None:
            if weights != "fp32":
                raise ValueError(f"SessionMultiplexer: weights={weights!r} with fns: the "
                                 "functions take the params as given")
            if cfg.bottleneck == "mha":
                raise ValueError("SessionMultiplexer: an mha model has no bundle "
                                 "(export_stream refuses it): serve it from the live "
                                 "functions")
            self.params = self._step_params = to_device(params, self.device)
            self.widened = 0
            self._prime, self._step = fns["prime"], fns["step"]
            self._packs = None
        else:
            from cleanumamba_tpu_torch.ops.cuda.stream_fused import (
                pack_stream_params,
                reserve_scratch,
            )
            from cleanumamba_tpu_torch.streaming import (
                stream_prime,
                stream_step,
                step_weights,
                stream_step_block,
            )

            self.params, view = prepare_weight_view(to_device(params, self.device), weights,
                                                    dtype)
            # an int8 pack computes in bf16
            packs = None
            if (block == 1 and dtype in (torch.float32, torch.bfloat16)
                    and (weights != "int8" or dtype == torch.bfloat16)):
                packs = pack_stream_params(self.params, cfg, dtype)
                packs = None if packs[1] is None else packs
            if packs is not None:
                self.packed_levels = sum(m is not None for m in packs[1]["enc"] + packs[1]["dec"])
                # before any capture: no width regrows a scratch
                reserve_scratch(packs, slots)
            self._packs = packs
            # the prime reads the resident tree, a packed tick the same without
            # its packed levels (their weights are in the packs)
            self.params, self._step_params, self.widened = step_weights(
                self.params, None if packs is None else packs[1], dtype)
            self._prime = lambda p, f: stream_prime(view(p), cfg, f, dtype)
            if block == 1:
                self._step = lambda p, s, n: stream_step(view(p), cfg, s, n, dtype, packs=packs)
            else:
                self._step = lambda p, s, n: stream_step_block(view(p), cfg, s, n, dtype)
        self.pool = None  # batched state tree, made at the first admission
        self._graphs = StepGraphs(self.device) if self.device.type == "cuda" else None
        self._full_width = fns is not None  # a bundle's step was traced at batch = slots
        # host-side per-slot bookkeeping
        self._open = [False] * slots
        self._primed = [False] * slots
        self._buf: List[np.ndarray] = [np.zeros(0, np.float32)] * slots
        self._out: List[List[np.ndarray]] = [[] for _ in range(slots)]
        self._fed = [0] * slots
        self._emitted = [0] * slots
        self._tokens = [0] * slots  # bottleneck tokens each session has attended with
        self.ticks = 0
        self.rows_stepped = 0
        self.kv_positions = 0

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
        """Release a slot.  Its state rows are kept as they are until the slot
        is admitted again, when the splice overwrites them (an mha row's
        rings and position too, so its next session starts from an empty
        window); no tick reads them meanwhile."""
        self._check(sid)
        self._open[sid] = False
        self._primed[sid] = False
        self._buf[sid] = np.zeros(0, np.float32)
        self._out[sid] = []
        self._tokens[sid] = 0

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
        """Serve from an exported bundle (``export.py``), on the device it was
        traced on.  The bundle's traced batch becomes ``slots`` and its traced
        step width ``block``; ``params`` is the weight tree of the matching
        geometry."""
        from cleanumamba_tpu_torch.export import load_bundle

        cfg, fns = load_bundle(path)
        with open(os.path.join(path, "bundle.json")) as f:
            meta = json.load(f)
        if "batch" not in meta or "block" not in meta:
            raise ValueError(
                f"{path}/bundle.json lacks batch/block: re-export with the current "
                "export.save_bundle (they are schema fields derived from the traced shapes)")
        return cls(params, cfg, slots=meta["batch"], block=meta["block"],
                   device=meta["functions"]["step"]["device"],
                   fns={"prime": fns["prime"], "step": fns["step"]})

    # -- internals ----------------------------------------------------------

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.slots and self._open[sid]):
            raise ValueError(f"session {sid} is not open")

    def _pending_out(self, sid: int) -> int:
        return sum(o.shape[0] for o in self._out[sid])

    def _drain(self, sid: int) -> np.ndarray:
        with tracing.span("mux.drain", sid):
            outs = self._out[sid]
            self._out[sid] = []
            if not outs:
                return np.zeros(0, np.float32)
            out = np.concatenate(outs)
            self._emitted[sid] += out.shape[0]
            return out

    def _admit_ready(self) -> None:
        """Prime every buffering session that has a full first frame."""
        fl = self.cfg.frame_length
        for sid in range(self.slots):
            if not (self._open[sid] and not self._primed[sid]
                    and self._buf[sid].shape[0] >= fl):
                continue
            with tracing.span("mux.admit", sid):
                frames = np.zeros((self.slots, fl), np.float32)
                frames[sid] = self._buf[sid][:fl]
                self._buf[sid] = self._buf[sid][fl:]
                frames = torch.from_numpy(frames)
                if self._graphs is None:
                    state, out = self._prime(self.params, frames.to(self.device))
                else:  # the graph's outputs: read before its next replay
                    state, out = self._graphs("prime", self._prime_body, None, frames)
                if self.pool is None:
                    self.pool = own(state)
                else:  # batch-leading: one splice admits the session
                    row = self._rows([sid])

                    def splice(pool, new):
                        _map_rows(lambda a, b: a.index_copy_(0, row, b[sid:sid + 1]),
                                  self.slots, pool, new)

                    kv = "bottleneck" if self.kv_window else None
                    splice({k: v for k, v in self.pool.items() if k != kv},
                           {k: v for k, v in state.items() if k != kv})
                    if kv:
                        with tracing.span("mux.admit_kv", sid):  # the row's rings and position
                            splice(self.pool[kv], state[kv])
                self._out[sid].append(out[sid].float().cpu().numpy())
                self._primed[sid] = True
                self._tokens[sid] = 1  # the prime's token

    def _rows(self, sids):
        return torch.tensor(sids, dtype=torch.long, device=self.device)

    def _prime_body(self, frames):
        return self._prime(self.params, frames)

    def _step_body(self, pool, rows, samples):
        """The tick at the width of ``rows`` (w,), each a row of the pool, or
        ``~row`` for a padding row: those rows of every batch-leading leaf
        gathered (``gather_rows``: one launch on CUDA), all stepped and
        returned as :class:`graphs.Rows` of the pool, whose ``write_back``
        copies the rows of the tick alone, one launch for the lot, so that a
        padding row is never written.  The gathered rings are a copy: the
        step writes its rows' slots there, and a second run on the same pool
        gathers and writes the same, as the graphs' warm-up runs need."""
        leaves = tree_leaves(pool)
        batch = [x.ndim > 0 and x.shape[0] == self.slots for x in leaves]
        rows_of = [x for x, b in zip(leaves, batch) if b]
        got = [x.new_empty((rows.shape[0], *x.shape[1:])) for x in rows_of]
        gather_rows(got, rows_of, rows)
        it = iter(got)
        sub = tree_unflatten(pool, [next(it) if b else x for x, b in zip(leaves, batch)])
        new, out = self._step(self._step_params, sub, samples)
        return tree_unflatten(pool, [Rows(rows, n) if b else n
                                     for n, b in zip(tree_leaves(new), batch)]), out

    def _count_kv(self, ready) -> None:
        """The counters of a tick's attention: each live row's ``block``
        tokens attend to min(tokens so far, window) slots each."""
        W = self.kv_window
        for s in ready:
            n0 = self._tokens[s]
            self._tokens[s] = n0 + self.block
            self.kv_positions += sum(min(n + 1, W) for n in range(n0, n0 + self.block))

    def _pump(self) -> None:
        self._admit_ready()
        tick = self.tick_samples
        while True:
            ready = [s for s in range(self.slots)
                     if self._primed[s] and self._buf[s].shape[0] >= tick]
            if not ready:
                return
            w = self.slots if self._full_width else tick_width(len(ready), self.slots)
            with tracing.span("mux.tick", w):
                with tracing.span("mux.pack"):
                    # the tick's rows: the live ones, then rows outside the
                    # tick (starved sessions, free slots) up to its width, which
                    # ride the step on zeros and are not written back (~row)
                    rows = sorted(ready + [s for s in range(self.slots)
                                           if s not in ready][:w - len(ready)])
                    rows = [s if s in ready else ~s for s in rows]
                    new = np.zeros((w, tick), np.float32)
                    for i, s in enumerate(rows):
                        if s >= 0:
                            new[i] = self._buf[s][:tick]
                            self._buf[s] = self._buf[s][tick:]
                    inputs = (torch.tensor(rows), torch.from_numpy(new))
                if self._graphs is not None:
                    self.pool, out = self._graphs("step", self._step_body, self.pool, *inputs)
                else:  # eager: the tick writes a copy, the pool it read is left alone
                    pool = own(self.pool)
                    out = step_in_place(self._step_body, pool,
                                        *[x.to(self.device) for x in inputs])
                    self.pool = pool
                with tracing.span("mux.copy_out"):
                    out = out.float().cpu().numpy()  # the tick's one copy to the host
                for i, s in enumerate(rows):
                    if s >= 0:
                        self._out[s].append(out[i])
                self.ticks += 1
                self.rows_stepped += w
                if self.kv_window:
                    self._count_kv(ready)
            self._admit_ready()
