"""The port stands alone: it imports nothing of JAX or of the JAX package,
keeps its own configuration classes, and runs on the GPU unless asked for
the CPU."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from cleanumamba_tpu import config as jconfig
from cleanumamba_tpu_torch import config as tconfig
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.train import checkpoint as tck

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "cleanumamba_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "cleanumamba_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_the_jax_package_blocked():
    """Every module of the port and chip_smoke import in a process where
    ``jax`` and ``cleanumamba_tpu`` cannot be imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cleanumamba_tpu'] = None\n"
        "import cleanumamba_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print('ok', len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=180, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 25  # every module was imported


@pytest.mark.parametrize("name", ["CleanUMambaConfig", "LossConfig", "STFTLossConfig",
                                  "OptimizationConfig", "TrainConfig"])
def test_config_classes_equal_the_jax_packages(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert jcls is not tcls
    jf = {f.name: f for f in dataclasses.fields(jcls)}
    tf = {f.name: f for f in dataclasses.fields(tcls)}
    assert list(jf) == list(tf)
    for key in jf:
        for attr in ("default", "default_factory"):
            a, b = getattr(jf[key], attr), getattr(tf[key], attr)
            if a is dataclasses.MISSING or b is dataclasses.MISSING:
                assert a is b, (key, attr)
            elif attr == "default":
                assert a == b, (key, a, b)
            elif dataclasses.is_dataclass(a()):
                assert dataclasses.asdict(a()) == dataclasses.asdict(b()), key
            else:
                assert a() == b(), key


@pytest.mark.parametrize("kwargs", [
    {}, {"bottleneck": "mha", "channels_H": 32, "max_H": 64, "tsfm_d_model": 64,
         "tsfm_d_inner": 128},
    {"encoder_n_layers": 4, "kernel_size": 8, "stride": 4, "encoder_groups": (1, 2, 4, 8),
     "bypass_channels": (0, 0, 4, 8)}], ids=["E8", "fullmini-mha", "grouped"])
def test_config_derived_properties_equal_the_jax_packages(kwargs):
    j, t = jconfig.CleanUMambaConfig(**kwargs), tconfig.CleanUMambaConfig(**kwargs)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("frame_length", "total_stride", "d_inner", "dt_rank", "d_state", "expand"):
        assert getattr(j, prop) == getattr(t, prop), prop
    for i in range(j.encoder_n_layers):
        assert j.bypass_of_layer(i) == t.bypass_of_layer(i)
        assert j.group_of_layer(i) == t.group_of_layer(i)
    assert j.valid_length(12345) == t.valid_length(12345)
    assert j.encoder_widths() == t.encoder_widths()
    assert j.to_reference_json() == t.to_reference_json()
    network = "CleanUNet" if j.bottleneck == "mha" else "CleanUMamba"
    back = tconfig.CleanUMambaConfig.from_reference_json(network, t.to_reference_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(
        jconfig.CleanUMambaConfig.from_reference_json(network, j.to_reference_json()))


def test_entry_points_take_the_gpu_by_default(tmp_path):
    """Without a CUDA device and without a device named, every entry point
    raises; none carries on on the CPU.  With one, the default is cuda:0."""
    if torch.cuda.is_available():
        assert tparams.default_device() == torch.device("cuda:0")
        return
    cfg = tconfig.CleanUMambaConfig(channels_H=4, max_H=8, encoder_n_layers=3, tsfm_n_layers=1,
                                    tsfm_n_head=2, tsfm_d_model=8, tsfm_d_inner=16)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg, gen)
    params = tm.init_params(cfg, gen, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.Streamer(params, cfg)
    assert ts.Streamer(params, cfg, "cpu").device == torch.device("cpu")
    path = tck.save_checkpoint(str(tmp_path), 0, params, None, cfg)
    for load in (tparams.load_checkpoint, tck.load_checkpoint):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(path)
    assert tparams.load_checkpoint(path, "cpu")[0] == cfg
    assert tparams.resolve_device("cpu") == torch.device("cpu")


def test_training_cli_takes_the_gpu_by_default(tmp_path):
    from cleanumamba_tpu_torch.cli import train as tcli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken, nothing to refuse")
    exp = tmp_path / "exp.json"
    cfg = tconfig.CleanUMambaConfig(channels_H=4, max_H=8, encoder_n_layers=3, tsfm_n_layers=1,
                                    tsfm_n_head=2, tsfm_d_model=8, tsfm_d_inner=16)
    import json
    exp.write_text(json.dumps({"network": "CleanUMamba", "exp_path": "t",
                               "network_config": cfg.to_reference_json()}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-c", str(ROOT / "configs" / "train_synth.json"), "-e", str(exp),
                   "--synthetic", "--max-iters", "1"])


def test_new_modules_are_covered():
    """The evaluation slice's modules are among the sources checked above."""
    names = {str(p.relative_to(ROOT / "cleanumamba_tpu_torch")) for p in SOURCES
             if "cleanumamba_tpu_torch" in p.parts}
    assert {"eval/__init__.py", "eval/metrics.py", "eval/pesq_p862.py", "eval/synth.py",
            "eval/validate.py", "utils.py", "cli/evaluate.py", "tracing.py"} <= names


def test_evaluate_cli_takes_the_gpu_by_default():
    from cleanumamba_tpu_torch.cli import evaluate as tevaluate

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken, nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(["--ckpt", str(ROOT / "artifacts" / "pruned_473k_finetuned.pkl"),
                        "--synthetic", "--max-items", "1"])


def test_pruning_modules_are_covered():
    """The pruning slice's modules are among the sources checked above."""
    names = {str(p.relative_to(ROOT / "cleanumamba_tpu_torch")) for p in SOURCES
             if "cleanumamba_tpu_torch" in p.parts}
    assert {"prune/__init__.py", "prune/groups.py", "prune/importance.py", "prune/pruner.py",
            "prune/telemetry.py", "prune/calibrate.py", "prune/driver.py", "cli/prune.py",
            "cli/finetune.py", "cli/calibrate.py"} <= names


@pytest.mark.parametrize("name,argv", [
    ("prune", ["-t", "artifacts/pruned_473k_finetuned.pkl", "-e", "configs/prune_2m_synth.json",
               "--synthetic", "--max-iters", "1"]),
    ("finetune", ["--ckpt", "artifacts/pruned_473k_finetuned.pkl", "--synthetic", "--iters", "1"]),
    ("calibrate", ["--ckpt", "artifacts/pruned_473k_finetuned.pkl", "--n-batches", "1"]),
])
def test_pruning_clis_take_the_gpu_by_default(name, argv, tmp_path):
    """Without a CUDA device and without --device, each CLI raises before it
    reads or writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken, nothing to refuse")
    cli = importlib.import_module(f"cleanumamba_tpu_torch.cli.{name}")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a if not a.startswith(("artifacts/", "configs/")) else str(ROOT / a)
                  for a in argv] + ["--out", str(out)])
    assert not out.exists()


def test_training_and_serving_slice_modules_are_covered():
    """The distillation, data-parallel and export modules are among the
    sources checked above."""
    names = {str(p.relative_to(ROOT / "cleanumamba_tpu_torch")) for p in SOURCES
             if "cleanumamba_tpu_torch" in p.parts}
    assert {"parallel/__init__.py", "parallel/mesh.py", "train/distill.py", "export.py",
            "cli/export.py"} <= names


def test_export_cli_takes_the_gpu_by_default(tmp_path):
    """Without a CUDA device and without --device, the export CLI raises
    before it writes anything."""
    from cleanumamba_tpu_torch.cli import export as texport

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken, nothing to refuse")
    out = tmp_path / "bundle"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.main(["--ckpt", str(ROOT / "artifacts" / "pruned_473k_finetuned.pkl"),
                      "--out", str(out), "--length", "4000"])
    assert not out.exists()


def test_data_mesh_refuses_a_rank_without_its_card(monkeypatch):
    """``make_mesh`` on a CUDA device raises where ``cuda:{LOCAL_RANK}``
    does not exist, and names the way out; it needs the launcher's
    environment."""
    from cleanumamba_tpu_torch.parallel import make_mesh

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(RuntimeError, match="does not exist"):
        make_mesh()


def test_compiled_dispatch_is_covered():
    """The CUDA graph owners and the paths that replay them are among the
    sources checked above, with the public functions of the offline slice."""
    from cleanumamba_tpu_torch import graphs
    from cleanumamba_tpu_torch.cli.serve import make_bench_run
    from cleanumamba_tpu_torch.prune.driver import make_loss_and_grad
    from cleanumamba_tpu_torch.train.distill import graph_kd_step

    names = {str(p.relative_to(ROOT / "cleanumamba_tpu_torch")) for p in SOURCES
             if "cleanumamba_tpu_torch" in p.parts}
    assert {"graphs.py", "train/distill.py", "train/trainer.py", "prune/driver.py",
            "cli/serve.py", "cli/denoise.py", "cli/finetune.py", "eval/validate.py"} <= names
    assert all(callable(f) for f in (graphs.StepGraphs, graphs.ForwardGraphs, make_bench_run,
                                     make_loss_and_grad, graph_kd_step))
