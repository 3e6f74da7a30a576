"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs a streaming step, a serving tick, a train step and an
offline forward as one compiled dispatch each.  Here such a call is
captured as a CUDA graph per shape and replayed, on a CUDA device; on the
CPU the same bodies run eagerly (and that is what the tests hold against
JAX).  Two owners:

- :class:`StepGraphs`, ``jax.jit`` with donated buffers, for a step
  ``fn(state, *inputs) -> (new_state, out)`` that leaves its arguments as
  they were, or writes a state leaf in place only idempotently: running
  the step twice on the same state and inputs must leave that leaf as
  running it once does, and give the same ``out``.  (The mha bottleneck's
  step writes the key and value of every row into slot ``pos mod W`` of
  its ring and returns the rings themselves; it reads that slot from the
  new key and value, and ``pos`` is advanced only in the returned state,
  so a warm-up run writes what the replay writes.)  It keeps, for
  one owner (a ``Streamer``, a ``SessionMultiplexer``, a trainer):

  - **the static state**: the tree of tensors the owner's steps read and
    write.  The captured body writes the new state into it with ``copy_``
    as its last ops (the rows alone of a :class:`Rows` leaf: a
    multiplexer's tick steps a few rows of its pool), the counterpart of
    ``donate_argnums``: after a call the state a caller passed in holds the
    new values, and any other reference it kept to the old ones is not
    valid, as with a donated JAX buffer;
  - **static inputs**, one set a graph, that each call copies its
    arguments into before the replay;
  - **the graphs**, keyed by (tag, the inputs' shapes and dtypes) as jit's
    cache is, in one memory pool.  A graph's ``out`` lives in that pool and
    is overwritten by the graph's next replay: read it (or copy it) before.

- :class:`ForwardGraphs`, ``jax.jit`` without donation, for a read-only
  ``fn(params, *inputs) -> out`` (the offline forward, the pruning
  gradient, the serving bench's ticks).  It never writes the caller's
  params: each call copies them into a private static copy (one
  ``_foreach_copy_`` a dtype), so a replay computes with the caller's
  current values whether they were replaced by new tensors or changed in
  place; a param whose shape, dtype or static tag changed drops every graph
  and their pool, as jit recompiles.

**A shape is captured at its second call.**  The first call of a key runs
the body eagerly on the card (with a state: :func:`step_in_place`, the
same write-back a replay does), so a shape that comes once (a one-shot
feed, a file of its own length) costs one eager run and nothing more.  At
the second call the body runs three times on a side stream, outside any
capture: the first run does every lazy first-call effect (kernels built,
shared-memory attributes raised, cluster plans and K5's weight buffer made
with its one ``.cpu()``, cuBLAS, cuDNN and cuFFT set up), the other two
under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync hidden in
the body raises there, with its stack, rather than breaking the capture.
Then the capture, and its first replay.  A capture that fails raises with
the graph's key; nothing falls back to the eager path.  The warm-up runs
discard their results, so a capture changes no state but what an
idempotent in-place write puts there, which the replay then writes again;
a registered generator is put back as it was.

The kernel wrappers count their launches in Python (``selective_scan.
launches`` and the others of :func:`launch_counters`).  An eager call
counts its launches as it runs.  A capture records how far each count
moved while the graph was recorded and puts every count back as it was
before the warm-up; each replay adds the recorded launches, so the counts
say what the steps ran on the card (the warm-up runs, like a compile, are
not counted).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from cleanumamba_tpu_torch import tracing
from cleanumamba_tpu_torch.ops.cuda.kv_attention import kv_attention
from cleanumamba_tpu_torch.ops.cuda.row_copy import gather_rows, scatter_rows
from cleanumamba_tpu_torch.ops.cuda.selective_scan import selective_scan, selective_scan_bwd
from cleanumamba_tpu_torch.ops.cuda.stream_fused import fused_decoder_level, fused_encoder_level
from cleanumamba_tpu_torch.ops.cuda.stream_mega import mega_stream_step
from cleanumamba_tpu_torch.params import tensor_leaves, tree_leaves, tree_map

WARMUP_RUNS = 3


def launch_counters():
    """(wrapper, attribute) of every kernel launch count."""
    return ((selective_scan, "launches"), (selective_scan_bwd, "launches"),
            (fused_encoder_level, "launches"), (fused_encoder_level, "int8_launches"),
            (fused_decoder_level, "launches"), (fused_decoder_level, "int8_launches"),
            (mega_stream_step, "launches"), (kv_attention, "launches"),
            (gather_rows, "launches"), (scatter_rows, "launches"))


def _counts():
    return [getattr(fn, attr) for fn, attr in launch_counters()]


def _shape_key(inputs):
    return tuple((tuple(x.shape), x.dtype) for x in inputs)


class Rows:
    """A new value for some rows of a state leaf: row i of ``values``
    (len(index), ...) for row ``index[i]`` along the leading dimension, for
    every ``index[i] >= 0`` (a 1-d int64 tensor; its rows distinct); a
    negative ``index[i]`` writes nothing, and the other rows keep theirs.
    :func:`write_back` copies only those rows, so a step that advances a
    few rows of a large batched state returns no whole-width leaf."""

    __slots__ = ("index", "values")

    def __init__(self, index: torch.Tensor, values: torch.Tensor):
        self.index, self.values = index, values


def write_back(static, new) -> None:
    """Copy every tensor leaf of ``new`` into the same leaf of ``static`` (a
    tree of the same structure, shapes and dtypes; raises otherwise).  A
    leaf of ``new`` that is its target is skipped; one that shares memory
    with any leaf of ``static`` is cloned first, so no copy reads a leaf an
    earlier copy wrote.  Contiguous pairs of one dtype are copied by one
    ``torch._foreach_copy_`` (a few launches for the lot), the others one
    by one.  :class:`Rows` leaves write their rows alone, after the
    whole-leaf copies: those of one index in one ``row_copy.scatter_rows``
    (one launch on CUDA)."""
    dst, src = tree_leaves(static), tree_leaves(new)
    if len(dst) != len(src):
        raise ValueError(f"write_back: {len(src)} new leaves for {len(dst)} state leaves")
    owned = {t.untyped_storage().data_ptr() for t in dst if isinstance(t, torch.Tensor)}
    pairs, rows = [], []
    for i, (d, s) in enumerate(zip(dst, src)):
        if not isinstance(d, torch.Tensor):
            continue
        part = isinstance(s, Rows)
        t = s.values if part else s
        if not isinstance(t, torch.Tensor) or t.dtype != d.dtype or (
                t.shape[1:] != d.shape[1:] if part else t.shape != d.shape):
            got = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else type(t)
            raise ValueError(f"write_back: leaf {i} is {got}{' rows' if part else ''}, the "
                             f"state's {(tuple(d.shape), d.dtype)}")
        if t is d:
            continue
        if t.untyped_storage().data_ptr() in owned:
            t = t.clone()
        if part:
            rows.append((d, s, t))
        else:
            pairs.append((d, t))
    groups: Dict[torch.dtype, tuple] = {}
    for d, s in pairs:
        if d.is_contiguous() and s.is_contiguous() and d.device == s.device:
            dsts, srcs = groups.setdefault(d.dtype, ([], []))
            dsts.append(d)
            srcs.append(s)
        else:
            d.copy_(s)
    for dsts, srcs in groups.values():
        torch._foreach_copy_(dsts, srcs)
    sets: Dict[int, tuple] = {}
    for d, part, values in rows:
        dsts, srcs, _ = sets.setdefault(id(part.index), ([], [], part.index))
        dsts.append(d)
        srcs.append(values)
    for dsts, srcs, index in sets.values():
        scatter_rows(dsts, srcs, index)


def step_in_place(fn, state, *inputs):
    """What a captured graph runs, eagerly on any device: ``fn(state,
    *inputs) -> (new_state, out)``, the new state written into ``state``
    (:func:`write_back`); returns ``out``."""
    new_state, out = fn(state, *inputs)
    write_back(state, new_state)
    return out


def _distinct(tree):
    """``tree`` with a contiguous copy in place of every tensor leaf that
    shares memory with an earlier leaf, so that writing one leaf writes no
    other, or that is not contiguous (``write_back`` copies contiguous
    leaves together)."""
    seen = set()

    def fix(t):
        if not isinstance(t, torch.Tensor):
            return t
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen or not t.is_contiguous():
            return t.clone(memory_format=torch.contiguous_format)
        seen.add(ptr)
        return t

    return tree_map(fix, tree)


def _same_leaves(a, b) -> bool:
    return all(x is y for x, y in zip(tensor_leaves(a), tensor_leaves(b)))


@contextlib.contextmanager
def _sync_debug_errors():
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class StepGraphs:
    """One owner's CUDA graphs, their static state and inputs, and their
    memory pool.  ``generator``: a CUDA ``torch.Generator`` the bodies draw
    from, registered with every graph (each replay advances it as the eager
    body would)."""

    def __init__(self, device, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"StepGraphs: CUDA graphs need a CUDA device, not {self.device}")
        self.generator = generator
        self.state = None
        self.pool = None  # the first capture's pool, shared by the later ones
        self._graphs: Dict[tuple, tuple] = {}
        self._seen = set()  # keys called once, eagerly

    def __len__(self) -> int:
        """The number of graphs captured."""
        return len(self._graphs)

    def __call__(self, tag: str, fn: Callable, state, *inputs):
        """Run ``fn`` as this owner's graph ``tag`` at these inputs' shapes.

        With ``state``: ``fn(state, *inputs) -> (new_state, out)``; returns
        ``(self.state, out)``, ``self.state`` holding the new values.  The
        first state given becomes ``self.state`` (donated: its leaves are
        kept as they are, but for a leaf that shares memory with an earlier
        one or is not contiguous, which is copied); a later call given
        another tree copies its values in first.  Without (None):
        ``fn(*inputs) -> out``; returns ``out``.  The first call of a key
        runs ``fn`` eagerly on the card; the second captures it, and the
        later ones replay what was captured (``fn`` is not read again)."""
        key = (tag, _shape_key(inputs))
        if key not in self._graphs:
            if key not in self._seen:
                with tracing.span("graphs.eager", tag):
                    self._seen.add(key)
                    self._adopt(state)
                    inputs = [x.to(self.device) for x in inputs]
                    if state is None:
                        return fn(*inputs)
                    return self.state, step_in_place(fn, self.state, *inputs)
            with tracing.span("graphs.capture", tag):
                self._adopt(state)
                self._graphs[key] = self._capture(key, fn, state is not None, inputs)
        graph, static_in, out, moved = self._graphs[key]
        with tracing.span("graphs.copy_in", tag):
            self._adopt(state)
            for dst, src in zip(static_in, inputs):
                dst.copy_(src)
        with tracing.span("graphs.replay", tag):
            graph.replay()
            for (wrapper, attr), n in zip(launch_counters(), moved):
                setattr(wrapper, attr, getattr(wrapper, attr) + n)
        return (self.state, out) if state is not None else out

    def _adopt(self, state) -> None:
        """Make ``state`` the static state: the first one given is kept (its
        leaves donated), a later tree of other leaves is copied in."""
        if state is None:
            return
        if self.state is None:
            self.state = _distinct(state)
        elif not _same_leaves(state, self.state):
            write_back(self.state, state)

    def _capture(self, key, fn, stateful, inputs):
        static_in = [x.to(self.device, copy=True) for x in inputs]
        run = (lambda: fn(self.state, *static_in)) if stateful else (lambda: fn(*static_in))
        gen_state = self.generator.get_state() if self.generator is not None else None
        counts = _counts()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for i in range(WARMUP_RUNS):
                with _sync_debug_errors() if i else contextlib.nullcontext():
                    run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = (step_in_place(fn, self.state, *static_in) if stateful else run())
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {key} failed: {e}") from e
        finally:
            moved = [a - b for a, b in zip(_counts(), before)]
            for (wrapper, attr), n in zip(launch_counters(), counts):
                setattr(wrapper, attr, n)
        if self.generator is not None:
            self.generator.set_state(gen_state)
        if self.pool is None:
            self.pool = graph.pool()
        return graph, static_in, out, moved


def own(tree):
    """A tree whose tensor leaves are fresh copies of ``tree``'s: a state that
    no graph's memory and no other tree shares."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _layout(tree):
    """``tree`` with each tensor leaf replaced by its (shape, dtype, device)
    and the other leaves (static tags: an S4 kernel's ``l_kernel``, a
    pruned level's None) kept: equal layouts read alike in a graph."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype, t.device)
                    if isinstance(t, torch.Tensor) else t, tree)


class ForwardGraphs:
    """``fn(params, *inputs) -> out`` replayed as one CUDA graph per input
    shapes and dtypes: the counterpart of ``jax.jit(fn)``, which donates
    nothing.

    ``params`` is any tree; ``inputs`` are tensors on any device, copied
    into the graph's static inputs.  On a CUDA device each call copies the
    params into a private static copy that the graphs read (the caller's
    tensors are never written, and the caller may replace them or change
    them in place between calls), then runs the graph of the inputs'
    shapes: eagerly at a shape's first call, captured at its second,
    replayed after (:class:`StepGraphs`).  ``out`` lives in the graphs'
    pool and is overwritten at the next replay: read or copy it first.  A
    call whose params differ in structure, a shape, a dtype or a static
    tag from the last call's drops every graph first (:meth:`reset`).  The
    grad mode is the caller's, at capture as at replay: call under
    ``torch.no_grad()`` for a forward.  On the CPU a call is ``fn(params,
    *inputs)``.
    """

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.params = None  # the static copy the graphs read
        self._layout = None
        self._graphs = StepGraphs(self.device) if self.device.type == "cuda" else None

    def __len__(self) -> int:
        """The number of graphs captured."""
        return 0 if self._graphs is None else len(self._graphs)

    @property
    def pool(self):
        """The graphs' memory pool (None before the first capture)."""
        return None if self._graphs is None else self._graphs.pool

    def __call__(self, params, *inputs):
        if self._graphs is None:
            return self.fn(params, *inputs)
        with tracing.span("graphs.params_sync"):
            layout = _layout(params)
            if layout != self._layout:
                if self._layout is not None:
                    self.reset()
                self.params, self._layout = own(params), layout
            else:
                write_back(self.params, params)
        return self._graphs("forward", self._body, None, *inputs)

    def _body(self, *inputs):
        return self.fn(self.params, *inputs)

    def reset(self) -> None:
        """Drop every graph, the static copy and the graphs' memory pool (given
        back to the device once no output of theirs is referenced)."""
        if self._graphs is None:
            return
        captured = len(self._graphs) > 0
        self._graphs = StepGraphs(self.device)
        self.params = self._layout = None
        if captured:
            torch.cuda.empty_cache()
