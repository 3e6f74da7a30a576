"""The port's span recorder (``tracing.py``) and the spans the multiplexer and
the graph owners record.

On the CPU: off, a span is the shared do-nothing object and nothing is
kept; on, each span carries its name, its parent (the span open when it was
entered) and its key, and closes when raised through; the store's cap
counts what it drops; with the recorder on, every tick of a
``SessionMultiplexer`` is one ``mux.tick`` keyed by its width, holding one
``mux.pack`` and one ``mux.copy_out``, each admission one ``mux.admit`` keyed by its session,
and the outputs are bit for bit those with the recorder off.

The cases marked ``cuda`` hold the ``graphs.*`` spans on the card: a key's
calls give ``graphs.eager``, then ``graphs.capture``, then one
``graphs.copy_in`` and one ``graphs.replay`` a call; nothing is recorded
from inside a captured body; ``ForwardGraphs`` gives one
``graphs.params_sync`` a call.  They skip without a CUDA device.
"""

import numpy as np
import pytest
import torch

from cleanumamba_tpu_torch import tracing
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models.cleanumamba import init_params
from cleanumamba_tpu_torch.serve import SessionMultiplexer

NAME, ID, PARENT, KEY, T0, T1 = range(6)


@pytest.fixture
def recording():
    """The process's recorder, on for the test and off after it."""
    tracing.start()
    yield
    tracing.stop()


def test_off_span_is_the_shared_no_op_and_nothing_is_kept():
    tracing.stop()
    a, b = tracing.span("mux.tick"), tracing.span("mux.admit", 3)
    assert a is b
    with a as entered:
        with b:
            pass
    assert entered is a
    assert tracing.stop() == []


def test_on_spans_nest_with_parents_keys_and_times(recording):
    with tracing.span("outer"):
        with tracing.span("inner", 7):
            pass
        with tracing.span("inner", "step"):
            with tracing.span("leaf"):
                pass
    with tracing.span("after"):
        pass
    spans = {(s[NAME], s[KEY]): s for s in tracing.stop()}
    assert len(spans) == 5
    outer, a, b = spans[("outer", -1)], spans[("inner", 7)], spans[("inner", "step")]
    leaf, after = spans[("leaf", -1)], spans[("after", -1)]
    assert outer[PARENT] == -1 and after[PARENT] == -1
    assert a[PARENT] == outer[ID] and b[PARENT] == outer[ID] and leaf[PARENT] == b[ID]
    assert len({s[ID] for s in spans.values()}) == 5
    for s in spans.values():
        assert s[T0] <= s[T1]
    assert outer[T0] <= a[T0] <= a[T1] <= b[T0] <= leaf[T0] <= leaf[T1] <= b[T1] <= outer[T1]
    assert outer[T1] <= after[T0]


def test_span_raised_through_still_closes(recording):
    with pytest.raises(KeyError):
        with tracing.span("outer"):
            with tracing.span("failing", 2):
                raise KeyError("x")
    with tracing.span("next"):
        pass
    spans = {s[NAME]: s for s in tracing.stop()}
    assert set(spans) == {"outer", "failing", "next"}
    assert spans["failing"][PARENT] == spans["outer"][ID]
    assert spans["next"][PARENT] == -1  # the failed spans are no longer open


def test_store_cap_counts_what_it_drops():
    rec = tracing.Recorder(capacity=3)
    with rec.span("off"):
        pass
    rec.start()
    for i in range(5):
        with rec.span("s", i):
            pass
    assert rec.dropped == 2
    assert [s[KEY] for s in rec.stop()] == [0, 1, 2]
    rec.start()
    assert rec.dropped == 0 and rec.stop() == []


# --- the multiplexer on the CPU ---

TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32, normalize_input=True)


@pytest.fixture(scope="module")
def model():
    cfg = CleanUMambaConfig(**TINY)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _serve(cfg, params):
    """Three sessions admitted at different times, fed unevenly, one paused
    while the others tick, one flushed; returns every output returned."""
    fl, tsr = cfg.frame_length, cfg.total_stride
    rng = np.random.default_rng(1)
    audio = [(rng.normal(size=fl + 12 * tsr) * 0.2).astype(np.float32) for _ in range(3)]
    mux = SessionMultiplexer(params, cfg, slots=4, device="cpu")
    a, b = mux.open(), mux.open()
    outs = [mux.feed(a, audio[0][:fl + 2 * tsr]), mux.feed(b, audio[1][:fl - 3])]
    c = mux.open()
    outs += [mux.feed(b, audio[1][fl - 3:fl + 3 * tsr]), mux.feed(c, audio[2][:fl + tsr]),
             mux.feed(a, audio[0][fl + 2 * tsr:fl + 5 * tsr]), mux.flush(b),
             mux.feed(c, audio[2][fl + tsr:fl + 4 * tsr])]
    return outs, (mux.ticks, mux.rows_stepped), (a, b, c)


def test_multiplexer_spans_each_tick_and_admission(model):
    cfg, params = model
    want, counts_off, _ = _serve(cfg, params)
    tracing.start()
    try:
        got, (ticks, rows_stepped), sids = _serve(cfg, params)
    finally:
        spans = tracing.stop()
    assert (ticks, rows_stepped) == counts_off and ticks > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    ticks_seen = [s for s in spans if s[NAME] == "mux.tick"]
    assert len(ticks_seen) == ticks
    for t in ticks_seen:
        children = [s[NAME] for s in spans if s[PARENT] == t[ID]]
        assert sorted(children) == ["mux.copy_out", "mux.pack"]
        assert t[PARENT] == -1 and t[KEY] in (1, 2, 4)  # the tick's width
    assert sum(t[KEY] for t in ticks_seen) == rows_stepped
    admits = [s for s in spans if s[NAME] == "mux.admit"]
    assert sorted(s[KEY] for s in admits) == sorted(sids)
    drains = [s for s in spans if s[NAME] == "mux.drain"]
    assert len(drains) == len(got) and {s[KEY] for s in drains} == set(sids)
    assert {s[NAME] for s in spans} == {"mux.tick", "mux.pack", "mux.copy_out", "mux.admit",
                                        "mux.drain"}  # on the CPU no graph runs
    by_id = {s[ID]: s for s in spans}
    for s in spans:
        if s[NAME] in ("mux.pack", "mux.copy_out"):
            assert by_id[s[PARENT]][NAME] == "mux.tick"


# --- on the card ---

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda:0")


def _top_level(spans, prefix):
    return [s for s in sorted(spans, key=lambda s: s[T0]) if s[NAME].startswith(prefix)]


@pytest.mark.cuda
def test_step_graph_calls_give_eager_capture_then_copy_in_and_replay(card):
    from cleanumamba_tpu_torch.graphs import StepGraphs

    graphs = StepGraphs(card)

    def body(state, x):
        return {"acc": state["acc"] + x}, state["acc"] * 2

    state = {"acc": torch.zeros(4, device=card)}
    tracing.start()
    try:
        for i in range(4):
            state, out = graphs("acc", body, state, torch.full((4,), float(i)))
        torch.cuda.synchronize(card)
    finally:
        spans = tracing.stop()
    assert torch.equal(state["acc"].cpu(), torch.full((4,), 6.0))
    names = [s[NAME] for s in _top_level(spans, "graphs.")]
    assert names == ["graphs.eager", "graphs.capture", "graphs.copy_in", "graphs.replay",
                     "graphs.copy_in", "graphs.replay", "graphs.copy_in", "graphs.replay"]
    assert {s[KEY] for s in spans} == {"acc"}
    capture = next(s for s in spans if s[NAME] == "graphs.capture")
    inside = [s for s in spans if s is not capture
              and capture[T0] <= s[T0] and s[T1] <= capture[T1]]
    assert inside == [] and all(s[PARENT] == -1 for s in spans)


@pytest.mark.cuda
def test_forward_graphs_sync_params_once_a_call(card):
    from cleanumamba_tpu_torch.graphs import ForwardGraphs

    fwd = ForwardGraphs(lambda p, x: p["w"] * x, card)
    params = {"w": torch.full((8,), 3.0, device=card)}
    tracing.start()
    try:
        with torch.no_grad():
            outs = [fwd(params, torch.full((8,), float(i))).cpu() for i in range(3)]
    finally:
        spans = tracing.stop()
    assert [float(o[0]) for o in outs] == [0.0, 3.0, 6.0]
    assert [s[NAME] for s in spans if s[NAME] == "graphs.params_sync"] == \
        ["graphs.params_sync"] * 3
    names = [s[NAME] for s in _top_level(spans, "graphs.") if s[NAME] != "graphs.params_sync"]
    assert names == ["graphs.eager", "graphs.capture", "graphs.copy_in", "graphs.replay",
                     "graphs.copy_in", "graphs.replay"]
    assert {s[KEY] for s in spans if s[NAME] != "graphs.params_sync"} == {"forward"}
