"""Each driver at a tiny size on the CPU, through the program's plain paths,
called as a function: it runs its window, reports its end-to-end metrics
and the counts the readers use, and its output check holds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests import tiny

TRAFFIC = {
    "e8-mux-live": {"calls": 2, "call_seconds": [0.1, 0.4], "durations": 8},
    "e8-offline": {"items": 2, "seconds": 1.0},
    "e8-train": {"items": 4, "batch": 2, "seconds": 0.5},
}
SETUP = {"e8-offline": {"check_share": 1.0}}  # every call checked in a short window
E2E = {"e8-mux-live": "hop_p95_ms", "e8-offline": "denoised_audio_rate", "e8-train": "train_audio_rate"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(TRAFFIC))
def test_driver_runs_tiny_on_the_cpu(cell):
    ctx = tiny.context(cell, seconds=0.6, traffic=TRAFFIC[cell], setup=SETUP.get(cell))
    out = tiny.run(ctx)
    assert out["e2e"][E2E[cell]] > 0 and out["e2e"]["setup_s"] >= 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    for name, value, limit in out["compared"]:
        assert value <= limit, (name, value, limit)
    c = out["counts"]
    if cell == "e8-mux-live":
        # every tick carried one live row: a feed ticks alone
        assert c["ticks"] == c["live_rows"] > 0 and c["admitted"] > 0
    if cell == "e8-train":
        assert c["steps"] > 0 and c["batch"] == 2


def test_same_seed_same_inputs():
    a = tiny.context("e8-offline", seed=2 ** 33 + 5, traffic=TRAFFIC["e8-offline"])
    b = tiny.context("e8-offline", seed=2 ** 33 + 5, traffic=TRAFFIC["e8-offline"])
    c = tiny.context("e8-offline", seed=2 ** 33 + 6, traffic=TRAFFIC["e8-offline"])
    pa = a.generator_module.make_pool(a.traffic, a.torch_generator("audio"))[1]
    pb = b.generator_module.make_pool(b.traffic, b.torch_generator("audio"))[1]
    pc = c.generator_module.make_pool(c.traffic, c.torch_generator("audio"))[1]
    assert torch.equal(pa, pb) and not torch.equal(pa, pc)


def test_live_plan_draws_every_calls_phase_from_the_seed():
    """The seed changes the order of the durations and residuals, not their
    set; each call's phase is drawn uniformly in [0, hop) from the seed."""
    def plan(seed):
        ctx = tiny.context("e8-mux-live", seed=seed, seconds=30.0)
        return ctx.generator_module.plan(ctx.traffic, ctx.rng("calls"), 30.0)

    la, lb, la2 = plan(11), plan(12), plan(11)
    assert len(la) == len(lb) == tiny.context("e8-mux-live").traffic["calls"]
    assert [c.hops for c in la[0]] != [c.hops for c in lb[0]] or [c.hops for c in la[1]] != \
        [c.hops for c in lb[1]]
    phases = [c.phase for calls in la for c in calls]
    assert phases == [c.phase for calls in la2 for c in calls]
    assert phases != [c.phase for calls in lb for c in calls]
    assert all(0.0 <= p < 0.016 for p in phases) and len(set(phases)) == len(phases)
    delays = np.concatenate([c.delay for calls in la for c in calls])
    assert delays.min() >= 0.0 and delays.max() < 0.016 and delays.std() > 0.003
