"""Tiny cells for the CPU tests: the drivers at full depth (frames of 766
samples, hops of 256) and small widths, with short windows."""

from __future__ import annotations

import torch

from portbench.harness import PKG, Context, load_json, module
from portbench.trace import Spans, Tracer

TINY_GEOM = {"channels_input": 1, "channels_output": 1, "channels_H": 2, "max_H": 4,
             "encoder_n_layers": 8, "kernel_size": 4, "stride": 2, "tsfm_n_layers": 2,
             "tsfm_n_head": 2, "tsfm_d_model": 8, "tsfm_d_inner": 16, "bottleneck": "mamba"}


def context(cell: str, seed: int = 7, seconds: float = 0.5, traffic=None,
            setup=None) -> Context:
    """A context of cell ``cell``'s files with a tiny geometry on the CPU;
    ``traffic`` and ``setup`` replace keys of the traffic file and of the
    workload's set-up.  The training cell's program runs in fp32 here: at
    these widths bf16 is far from its error at the cell's own."""
    bench = load_json(PKG.parent / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    wl = load_json(PKG / "workloads" / f"{cell}.json")
    fp32 = {"bf16": False} if "bf16" in wl["setup"] else {}
    wl["setup"] = dict(wl["setup"], **fp32, **(setup or {}))
    tr = dict(load_json(PKG / "traffic" / f"{entry['traffic']}.json"), **(traffic or {}))
    spans = Spans()
    return Context(name=cell, seed=seed, seconds=seconds, device=torch.device("cpu"),
                   config={"model": dict(TINY_GEOM)}, workload=wl, traffic=tr,
                   generator_module=module("traffic", tr["kind"]),
                   t0=0.0, spans=spans, tracer=Tracer(spans, False))


def run(ctx):
    return module("drivers", ctx.workload["driver"]).run(ctx)


def finish(ctx):
    """The rest of a run after the look for a card: ``(result, lines)``."""
    from portbench.harness import Manifest, finish as finish_run

    return finish_run(Manifest(), ctx)
