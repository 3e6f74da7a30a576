"""The benchmark's core: find a cell's files by name, run its driver, read
its per-layer metrics, and build the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``portbench/configs/<config>.json``: the model's geometry (``model``), its
  source and what was assumed (the manifest names the file);
- ``portbench/workloads/<cell>.json``: the driver, its set-up, the traced
  slice and the limits of the output check;
- ``portbench/traffic/<traffic>.json``: the traffic mix, read by the
  generator of its ``kind`` (``portbench/traffic/<kind>.py``);
- ``portbench/drivers/<driver>.py``: ``run(ctx) -> dict``, an entry point
  of the program driven through set-up, the window and the output check;
- ``portbench/metrics/<metric>.py``: ``read(rec) -> float | None``, one
  per-layer metric from the traced run's record;
- ``portbench/counts/<kernel>.py``: a kernel's name pattern, operations and
  bytes.

Each Python file is named as the name it is found by, with dots and dashes
written as underscores (``idle_share.live`` -> ``metrics/idle_share_live.py``),
and imported as a module of the package.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import re
import time
from typing import Optional

import numpy as np

from portbench.trace import Spans, Tracer

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module_name(name: str) -> str:
    """The file name (without ``.py``) of a driver, generator or reader."""
    return re.sub(r"[.-]", "_", name)


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, imported."""
    return importlib.import_module(f"portbench.{kind}.{module_name(name)}")


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.pkg = self.root / "portbench"
        self.data = load_json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(sorted(self.cells))})")
        return self.cells[name]

    def workload(self, name: str) -> dict:
        """The cell's workload file."""
        self.cell(name)
        return load_json(self.pkg / "workloads" / f"{name}.json")

    def files(self, name: str) -> dict:
        """The paths of a cell's files, each found by its name."""
        cell = self.cell(name)
        workload = self.workload(name)
        traffic = load_json(self.pkg / "traffic" / f"{cell['traffic']}.json")
        return {
            "config": self.root / self.configs[cell["config"]]["file"],
            "workload": self.pkg / "workloads" / f"{name}.json",
            "traffic": self.pkg / "traffic" / f"{cell['traffic']}.json",
            "driver": self.pkg / "drivers" / f"{module_name(workload['driver'])}.py",
            "generator": self.pkg / "traffic" / f"{module_name(traffic['kind'])}.py",
        }

    def reader(self, metric: str) -> pathlib.Path:
        return self.pkg / "metrics" / f"{module_name(metric)}.py"

    def metrics(self, name: str, trace: bool):
        """The metrics a run of cell ``name`` reports: end-to-end without
        the trace, per-layer with it."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if name in m.get("workloads", [name])]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the seed, the window, the device."""

    name: str
    seed: int
    seconds: float
    device: object
    config: dict
    workload: dict
    traffic: dict
    generator_module: object
    t0: float
    spans: Spans
    tracer: Tracer

    @property
    def geom(self) -> dict:
        return self.config["model"]

    def model_config(self):
        """The program's config object of this geometry."""
        from cleanumamba_tpu_torch.config import CleanUMambaConfig

        return CleanUMambaConfig(**self.geom)

    def substream(self, name: str) -> int:
        """A seed of its own for ``name``, from the run's seed."""
        words = [int(b) for b in name.encode()]
        ss = np.random.SeedSequence([self.seed & (2 ** 64 - 1), self.seed >> 64, *words])
        return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)

    def torch_generator(self, name: str):
        import torch

        return torch.Generator(device=self.device).manual_seed(self.substream(name))

    def rng(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self.substream(name))


def make_context(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool,
                 device, t0: Optional[float] = None) -> Context:
    paths = manifest.files(name)
    traffic = load_json(paths["traffic"])
    spans = Spans()
    return Context(name=name, seed=seed, seconds=seconds, device=device,
                   config=load_json(paths["config"]), workload=load_json(paths["workload"]),
                   traffic=traffic, generator_module=module("traffic", traffic["kind"]),
                   t0=time.perf_counter() if t0 is None else t0, spans=spans,
                   tracer=Tracer(spans, trace))


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None):
    """Run one cell: ``(result, lines)``, the result object and the lines for
    standard error, the compared numbers last."""
    return finish(manifest, make_context(manifest, name, seed, seconds, trace, device, t0))


def finish(manifest: Manifest, ctx: Context):
    """Run ``ctx``'s driver and build the result from what it returns."""
    name, trace = ctx.name, ctx.tracer.enabled
    out = module("drivers", ctx.workload["driver"]).run(ctx)
    metrics = {}
    if not trace:
        for m in manifest.metrics(name, trace=False):
            if m["name"] not in out["e2e"]:
                raise KeyError(f"{name}: the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        rec = {"cell": name, "geom": ctx.geom, "workload": ctx.workload, "traffic": ctx.traffic,
               "counts": out["counts"], "trace": ctx.tracer.summary}
        for m in manifest.metrics(name, trace=True):
            value = module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {c: {"value": v, "limit": lim} for c, v, lim in out["compared"]}
    result = {
        "correct": bool(compared) and all(x["value"] <= x["limit"] for x in compared.values()),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": out["device"],
    }
    if trace and ctx.tracer.summary is not None:
        s = ctx.tracer.summary
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    result["compared"] = compared
    lines = list(out.get("info", []))
    lines += [f"compared {c}: {x['value']!r} limit {x['limit']!r}" for c, x in compared.items()]
    return result, lines
