"""The port's serving CLIs on the CPU (``--device cpu``), on a tiny
checkpoint: ``cli/serve.py``'s demo and ``--bench``, ``cli/denoise.py`` on
two synthetic wavs, and ``cli/stream_demo.py --synthetic``."""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from cleanumamba_tpu_torch.cli import denoise, serve, stream_demo
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.data.wavio import read_wav, write_wav
from cleanumamba_tpu_torch.models.cleanumamba import forward, init_params
from cleanumamba_tpu_torch.train.checkpoint import save_checkpoint

TINY = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
                         tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and with the default pool one bf16 rep of the bench took over
    20 s in an eight-process run (seconds alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    return save_checkpoint(str(d), 0, params, None, TINY), params


def test_serve_demo(ckpt, capsys):
    serve.main(["--ckpt", ckpt[0], "--slots", "3", "--sessions", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    n = TINY.frame_length + 40 * TINY.total_stride
    assert out.count(f"in {n} samples -> out {n} samples") == 2
    assert "2 sessions" in out


@pytest.mark.parametrize("weights,block", [("bf16", 1), ("int8", 4)])
def test_serve_bench(ckpt, capsys, weights, block):
    serve.main(["--ckpt", ckpt[0], "--slots", "2", "--sessions", "1", "--block", str(block),
                "--bench", "--seconds", "0.5", "--reps", "2", "--weights", weights,
                "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serving_throughput" and line["value"] > 0
    assert line["slots"] == 2 and line["block"] == block and line["weights"] == weights
    assert line["backend"] == "cpu" and line["card"] is None and len(line["reps_ms"]) == 2


def test_denoise_cli(ckpt, tmp_path, capsys):
    src, dst = tmp_path / "noisy", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(0)
    audio = {f"a{i}.wav": (rng.normal(size=3000 + 700 * i) * 0.1).astype(np.float32)
             for i in range(2)}
    for name, x in audio.items():
        write_wav(str(src / name), x, 16000)
    denoise.main(["--ckpt", ckpt[0], "--input", str(src), "--output", str(dst),
                  "--device", "cpu"])
    assert "offline throughput" in capsys.readouterr().out
    for name, x in audio.items():
        y, sr = read_wav(str(dst / ("enhanced_" + name)))
        xin, _ = read_wav(str(src / name))
        want = forward(ckpt[1], torch.from_numpy(xin[None]), TINY)[0].numpy()
        assert sr == 16000 and y.shape == x.shape
        np.testing.assert_allclose(y, want, atol=2 / 32767)  # int16 wav quantisation
    denoise.main(["--ckpt", ckpt[0], "--input", str(src), "--output", str(dst / "bf16"),
                  "--device", "cpu", "--bf16", "--pad-to-sec", "0.25"])
    assert sorted(os.listdir(dst / "bf16")) == ["enhanced_a0.wav", "enhanced_a1.wav"]


def test_stream_demo_synthetic(ckpt, tmp_path, capsys):
    out = tmp_path / "y.wav"
    stream_demo.main(["--ckpt", ckpt[0], "--synthetic", "--seconds", "1", "--chunk", "1024",
                      "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "x realtime" in text and "wrote" in text
    y, _ = read_wav(str(out))
    assert y.shape == (16000,) and np.isfinite(y).all()
    # --mic without sounddevice (blocked here, installed or not): JAX's exit
    with mock.patch.dict(sys.modules, {"sounddevice": None}):
        with pytest.raises(SystemExit, match="sounddevice not installed; use --wav or --synthetic"):
            stream_demo.main(["--ckpt", ckpt[0], "--mic", "--device", "cpu"])
