"""Spans of the port's host work: where a tick, an admission or a graph call
spends the host's time, on the host's clock.

Off by default.  While off, :func:`span` returns one shared object whose
``with`` does nothing: it reads no clock, allocates nothing and records
nothing.  Between :func:`start` and :func:`stop` every span is kept in
memory as a tuple

    (name, id, parent_id, key, t0_ns, t1_ns)

``id`` counts the spans from 0 since :func:`start`; ``parent_id`` is the
span that was open when this one was entered (-1: none), which is the span
that caused it; ``key`` ties the spans of one request together (a session's
id, a graph's tag; -1 where there is none); the times are
``time.perf_counter_ns()`` at entry and exit.  A span that is raised
through still closes.  The store holds :data:`CAPACITY` spans; the ones
after that are counted (:func:`dropped`) and not kept.  The recorder
serves one thread: spans entered from two threads at once get each other
as parents.  There is one recorder a process, as there is one logging
tree: the spans sit deep inside call paths that take no recorder.

The spans, at each boundary where the port's host work changes hands:

============================  =============================================
``mux.admit`` (key: sid)      ``serve.SessionMultiplexer``: one session
                              admitted: its first frame packed, the prime's
                              graph call, the splice of its rows into the
                              pool (``index_copy_``), the primed output's
                              ``.cpu()``
``mux.admit_kv`` (key: sid,   an mha model's admission: the session's KV
in ``mux.admit``)             rings and position spliced into the pool's
                              row (``index_copy_``)
``mux.tick`` (key: width)     one tick: its rows and samples, the
                              graph call of its width, the output's copy
                              to the host, the rows handed to their sessions
``mux.pack`` (in the tick)    the tick's rows and ``new`` built
                              and the sessions' buffers sliced, on the host
``mux.copy_out`` (in the      ``out.float().cpu().numpy()``: the host waits
tick)                         here for the card to finish the tick
``mux.drain`` (key: sid)      a session's outputs joined for its caller
``graphs.eager`` (key: tag)   ``graphs.StepGraphs``: a key's first call,
                              run eagerly
``graphs.capture`` (key: tag) a key's second call: the warm-up runs and the
                              capture
``graphs.copy_in`` (key: tag) a call's state adopted (when given another
                              tree) and its inputs copied into the graph's
                              static inputs
``graphs.replay`` (key: tag)  ``graph.replay()`` and the launch counts
``graphs.params_sync``        ``graphs.ForwardGraphs``: the params' layout
                              compared with the last call's and their
                              values copied into the graphs' static copy
============================  =============================================

The port's counters, beside the spans (plain integers on the owner,
counted on the host, always on):

==================================  =========================================
``SessionMultiplexer.ticks``        ticks run
``SessionMultiplexer.rows_stepped`` the widths the ticks ran at, summed: the
                                    rows stepped, live and padding
``SessionMultiplexer.kv_positions`` an mha model's attended window lengths:
                                    for every token a live row steps, the
                                    ring slots it attends to (min(its tokens
                                    so far, the window)), summed over ticks;
                                    the bytes K6 must read follow from it
launch counts (``graphs.            each kernel wrapper's launches, a graph's
launch_counters``)                  counted at every replay
==================================  =========================================

The ``graphs.*`` spans serve every owner of graphs: the multiplexer's
prime (tag ``prime``) and tick (``step``), ``Streamer`` (``frame``,
``block``), ``trainer.graph_train_step`` (``train_step``), the device-data
steps, ``ForwardGraphs`` (``forward``: the offline forward, the pruning
gradient, the serving bench) and the distillation step.  No span is entered
inside a function that a graph captures: it would time the capture, not the
replay, and a replay runs no Python.  The stages inside one graph (a tick's
layers, a train step's forward, backward and optimizer) are not spans: read
them from a device trace by kernel name.

**Beside a** ``torch.profiler`` **trace.**  The spans time the host: a span
of a graph's replay ends when the launch returns, and the card runs the
graph after it.  A span that ends in a copy to the host (``mux.copy_out``,
the ``.cpu()`` in ``mux.admit``) ends when the card has finished the work
queued before it.  To lay the spans over a profile, read
``time.perf_counter_ns()`` just after a ``record_function`` range is
entered and just before it is left, and map the spans' times linearly from
those two readings onto that range's start and end in the profile; the
device's idle gaps are then named by the spans open at each gap.  A
recorded span costs two clock reads and a tuple (a fraction of a
microsecond); while recording, the profiler's own cost on the host shows
in the spans it overlaps.
"""

from __future__ import annotations

import time
from typing import List, Tuple

CAPACITY = 1 << 19

Span = Tuple[str, int, int, object, int, int]


class _Off:
    """The span while the recorder is off: a ``with`` that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """One span being recorded."""

    __slots__ = ("rec", "name", "key", "id", "parent", "t0")

    def __init__(self, rec: "Recorder", name: str, key):
        self.rec, self.name, self.key = rec, name, key

    def __enter__(self):
        rec = self.rec
        self.id, self.parent = rec._next, rec._open
        rec._next += 1
        rec._open = self.id
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._open = self.parent
        if len(rec.spans) < rec.capacity:
            rec.spans.append((self.name, self.id, self.parent, self.key, self.t0, t1))
        else:
            rec.dropped += 1
        return False


class Recorder:
    """A store of spans, off until :meth:`start`."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.on = False
        self.spans: List[Span] = []
        self.dropped = 0
        self._open = -1
        self._next = 0

    def span(self, name: str, key=-1):
        """A context manager that records the span ``name`` while the
        recorder is on, and the shared do-nothing one while it is off."""
        return _On(self, name, key) if self.on else _OFF

    def start(self) -> None:
        """Clear the store and the drop count, and record from now."""
        self.spans, self.dropped, self._open, self._next = [], 0, -1, 0
        self.on = True

    def stop(self) -> List[Span]:
        """Stop recording; returns the spans kept since :meth:`start`, in the
        order they closed."""
        self.on = False
        out, self.spans = self.spans, []
        return out


_RECORDER = Recorder()
span = _RECORDER.span
start = _RECORDER.start
stop = _RECORDER.stop


def dropped() -> int:
    """Spans not kept since the last :func:`start`: the store was full."""
    return _RECORDER.dropped
