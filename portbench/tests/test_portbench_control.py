"""The output check fails what it has to fail, at a size a test run holds.

- The control: the plain reference at the precision below the one the cell
  states (TF32 for fp32 with TF32 off; fp8 for bf16), or a fault planted in
  it (half of the batch), put in the program's place, reads above a limit.
- The rest of a run, with the timed path broken underneath (a step that
  returns its state unchanged; half of the batch left out; an answer
  altered where it is produced), comes out not correct, and the same run
  unbroken comes out correct.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import PKG, load_json, module
from portbench.tests import tiny

TRAFFIC = {
    "e8-mux-live": {"calls": 2, "call_seconds": [0.1, 0.4], "durations": 8},
    "e8-offline": {"items": 2, "seconds": 1.0},
    "e8-train": {"items": 4, "batch": 2, "seconds": 0.5},
}
SETUP = {"e8-offline": {"check_share": 1.0}}  # every call checked in a short window
LOWER = {"e8-mux-live": "tf32", "e8-offline": "tf32", "e8-train": "fp8"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limits(cell):
    return load_json(PKG / "workloads" / f"{cell}.json")["limits"]


def _driver(cell):
    name = load_json(PKG / "workloads" / f"{cell}.json")["driver"]
    return module("drivers", name)


@pytest.mark.parametrize("cell", list(TRAFFIC))
def test_the_control_fails_a_limit(cell):
    ctx = tiny.context(cell, seconds=0.5, traffic=TRAFFIC[cell], setup=SETUP.get(cell))
    got = _driver(cell).control(ctx, LOWER[cell])
    assert any(got[k] > v for k, v in _limits(cell).items()), got


def test_half_of_the_batch_fails_a_training_limit():
    ctx = tiny.context("e8-train", seconds=0.5, traffic=TRAFFIC["e8-train"])
    got = _driver("e8-train").control(ctx, "fp32", half_batch=True)
    assert any(got[k] > v for k, v in _limits("e8-train").items()), got


def _run(cell):
    ctx = tiny.context(cell, seconds=0.5, traffic=TRAFFIC[cell], setup=SETUP.get(cell))
    result, lines = tiny.finish(ctx)
    assert lines[-1].startswith("compared ")
    assert list(result)[-1] == "compared"
    return result


@pytest.mark.parametrize("cell", list(TRAFFIC))
def test_an_unbroken_run_is_correct(cell):
    assert _run(cell)["correct"] is True


def _alter_once(monkeypatch, owner, attr, nth=30):
    """``owner.attr`` returns one output with a sample moved, at its nth call
    that has output (after the set-up's)."""
    real, seen = getattr(owner, attr), []

    def altered(*a, **k):
        out = real(*a, **k)
        arr = out if isinstance(out, np.ndarray) else None
        if arr is not None and arr.size:
            seen.append(1)
            if len(seen) == nth:
                arr = arr.copy()
                arr.reshape(-1)[arr.size // 2] += 0.5 * max(np.abs(arr).max(), 1e-3)
                return arr
        elif isinstance(out, torch.Tensor) and out.numel():
            seen.append(1)
            if len(seen) == nth:
                out = out.clone()
                out.view(-1)[out.numel() // 2] += 0.5 * max(float(out.abs().max()), 1e-3)
        return out

    monkeypatch.setattr(owner, attr, altered)


def test_mux_state_left_unchanged(monkeypatch):
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    real = SessionMultiplexer._step_body
    monkeypatch.setattr(SessionMultiplexer, "_step_body",
                        lambda self, pool, live, x: (pool, real(self, pool, live, x)[1]))
    assert _run("e8-mux-live")["correct"] is False


def test_mux_answer_altered(monkeypatch):
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    _alter_once(monkeypatch, SessionMultiplexer, "_drain")
    assert _run("e8-mux-live")["correct"] is False


def test_offline_answer_altered(monkeypatch):
    """Every clip's output with one sample moved where the forward produces
    it: whichever calls the check samples, it sees the fault."""
    from cleanumamba_tpu_torch import graphs

    real = graphs.ForwardGraphs.__call__

    def altered(self, *a):
        out = real(self, *a).clone()
        out[0, out.shape[1] // 3] += 0.5 * float(out.abs().max())
        return out

    monkeypatch.setattr(graphs.ForwardGraphs, "__call__", altered)
    assert _run("e8-offline")["correct"] is False


def test_train_state_left_unchanged(monkeypatch):
    from cleanumamba_tpu_torch.train import trainer

    real = trainer.make_train_step

    def stale(*a, **k):
        step = real(*a, **k)

        def run(params, opt_state, batch):
            return params, opt_state, step(params, opt_state, batch)[2]

        return run

    monkeypatch.setattr(trainer, "make_train_step", stale)
    assert _run("e8-train")["correct"] is False


def test_train_half_of_the_batch_left_out(monkeypatch):
    from cleanumamba_tpu_torch.train import trainer

    real = trainer.make_train_step

    def halved(*a, **k):
        step = real(*a, **k)

        def run(params, opt_state, batch):
            clean, noisy = batch
            half = clean.shape[1] // 2
            return step(params, opt_state, (clean[:, :half], noisy[:, :half]))

        return run

    monkeypatch.setattr(trainer, "make_train_step", halved)
    assert _run("e8-train")["correct"] is False
