"""The manifest against the files: every cell, configuration, traffic mix,
driver and metric found by name, the contract's shape of BENCHMARK.json,
and a new cell added as one file plus one manifest entry."""

from __future__ import annotations

import json
import pathlib
import re
import shutil

import pytest

from portbench.harness import PKG, ROOT, Manifest, load_json, module, module_name

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_json(ROOT / "BENCHMARK.json")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    m = Manifest()
    files = m.files(cell)
    for path in files.values():
        assert path.is_file(), path
    assert m.cell(cell)["config"] in m.configs
    assert m.cell(cell)["chips"] == 1
    assert len(m.cell(cell)["why"]) <= 200 and "\n" not in m.cell(cell)["why"]
    workload = load_json(files["workload"])
    assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())
    names = [x["name"] for x in m.metrics(cell, trace=False)]
    assert "setup_s" in names and len(names) >= 2
    assert m.metrics(cell, trace=True), cell


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert Manifest().reader(metric).is_file()
    assert callable(module("metrics", metric).read)


def test_names_units_and_bounds_follow_the_contract():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers = {x["layer"] for x in BENCH["per_layer"]}
        assert all(len(x) <= 200 for x in layers)
        # every cell it names reports the end-to-end metric it moves
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert c["reduced"] == load_json(ROOT / c["file"])["reduced"]


def test_every_config_is_used_and_every_file_is_named():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    named = {f"{w['name']}.json" for w in BENCH["workloads"]}
    assert {p.name for p in (PKG / "workloads").glob("*.json")} == named
    readers = {f"{module_name(m['name'])}.py" for m in BENCH["per_layer"]}
    assert len(readers) == len(BENCH["per_layer"])  # no two metrics share a file
    assert {p.name for p in (PKG / "metrics").glob("*.py")} - {"__init__.py"} == readers


def test_a_new_cell_is_one_file_and_one_entry(tmp_path):
    """A later cell: a workload file and a manifest entry, nothing edited."""
    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "e8-mux-live-int8", "config": "e8-mamba",
                               "traffic": "mux-calls", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "hop_p95_ms":
            m["workloads"].append("e8-mux-live-int8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    (root / "portbench" / "workloads" / "e8-mux-live-int8.json").write_text(
        (PKG / "workloads" / "e8-mux-live.json").read_text().replace('"bf16"', '"int8"'))
    m = Manifest(root)
    files = m.files("e8-mux-live-int8")
    assert files["driver"] == root / "portbench" / "drivers" / "mux_live.py"
    assert files["config"] == root / "portbench" / "configs" / "e8-mamba.json"
    assert [x["name"] for x in m.metrics("e8-mux-live-int8", False)] == ["hop_p95_ms",
                                                                          "setup_s"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
    assert pathlib.Path(files["workload"]).is_file()
