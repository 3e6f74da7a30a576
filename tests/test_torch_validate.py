"""``eval/validate.py`` and ``cli/evaluate.py`` of the PyTorch port against
the JAX package's, on the CPU (JAX runs its plain scan there).

Same weights (the pruned checkpoint ``artifacts/pruned_473k_finetuned.pkl``,
a trained denoiser) and the same synthetic
utterances.  Length-weighted means:
STOI, segSNR, SI-SDR, LLR and WSS within 1e-3 absolute; PESQ and the three
composites within 1e-2.  The denoised waveforms themselves agree within 1e-4,
and the metric suite on JAX's own waveform is exact (the copies are the same
numpy code), which pins any flip of a discrete P.862 step to the forward.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest

import jax
import torch

from cleanumamba_tpu.cli import evaluate as jevaluate
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.data import SyntheticDenoiseDataset as JaxSynthetic
from cleanumamba_tpu.eval import metrics as jmet
from cleanumamba_tpu.eval.validate import validate as jax_validate
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.cli import evaluate as tevaluate
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.data import SyntheticDenoiseDataset
from cleanumamba_tpu_torch.eval import metrics as tmet
from cleanumamba_tpu_torch.eval.validate import validate
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.train.checkpoint import save_checkpoint

CKPT = "artifacts/pruned_473k_finetuned.pkl"
TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32)
FINE = ("stoi", "segsnr", "si_sdr", "llr", "wss")  # 1e-3 absolute
COARSE = ("pesq_wb", "pesq_nb", "csig", "cbak", "covl")  # 1e-2 absolute


def _agree(got, want):
    """The same metrics defined (STOI is NaN, and left out, when too few
    non-silent frames remain) and each within its tolerance."""
    assert sorted(got) == sorted(want) and set(COARSE) <= set(got) <= set(FINE + COARSE)
    for k in got:
        tol = 1e-3 if k in FINE else 1e-2
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port params) of the pruned checkpoint."""
    cfg, pt = tparams.load_checkpoint(CKPT, "cpu")
    ref = jax_load_checkpoint(CKPT)
    return ref["config"], ref["params"], pt


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig(**TINY)
    pj = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init_params, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg))
    return CleanUMambaConfig(**dataclasses.asdict(jcfg)), tparams.from_numpy(pj, "cpu")


@pytest.mark.parametrize("pad_to", [None, 12000, 20000], ids=["none", "crop", "pad"])
def test_validate_matches_jax(model, pad_to):
    jcfg, pj, pt = model
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    kw = dict(n_items=2, crop_length_sec=1.0, seed=7)
    got = validate(pt, cfg, SyntheticDenoiseDataset(**kw), pad_to=pad_to)
    want = jax_validate(pj, jcfg, JaxSynthetic(**kw), pad_to=pad_to)
    _agree(got, want)


def test_validate_waveforms_match_and_metrics_are_exact(model):
    """One utterance: the port's denoised waveform against JAX's (1e-4), and
    the port's metric suite on JAX's waveform equals JAX's exactly."""
    jcfg, pj, pt = model
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    clean, noisy = SyntheticDenoiseDataset(n_items=1, crop_length_sec=1.0, seed=7)[0]
    with torch.no_grad():
        den_t = tm.forward(pt, torch.from_numpy(noisy[None]), cfg).numpy()[0]
    den_j = np.asarray(jax.jit(lambda p, x: jm.forward(p, x, jcfg))(
        jax.tree_util.tree_map(jax.numpy.asarray, pj), jax.numpy.asarray(noisy[None])))[0]
    np.testing.assert_allclose(den_t, den_j, atol=1e-4, rtol=0)
    c16 = np.clip(clean * 32768.0, -32768, 32767)
    d16 = np.clip(den_j * 32768.0, -32768, 32767)
    got, want = tmet.eval_waveform(c16, d16), jmet.eval_waveform(c16, d16)
    assert list(got) == list(want)
    np.testing.assert_equal(got, want)


def test_validate_weights_by_length_and_skips_missing_metrics(tiny, monkeypatch):
    """Length-weighted means; a None or non-finite metric is left out of its
    mean (the JAX contract)."""
    cfg, pt = tiny
    calls = iter([{"stoi": 1.0, "wss": None}, {"stoi": 0.0, "wss": float("nan")},
                  {"stoi": 0.5, "wss": 2.0}])
    vmod = importlib.import_module("cleanumamba_tpu_torch.eval.validate")
    monkeypatch.setattr(vmod, "eval_waveform", lambda c, d: next(calls))
    ds = [(np.zeros(n, np.float32), np.zeros(n, np.float32)) for n in (1000, 3000, 2000)]
    out = validate(pt, cfg, ds)
    assert out["stoi"] == pytest.approx((1000 * 1.0 + 0 + 2000 * 0.5) / 6000)
    assert out["wss"] == pytest.approx(2.0 * 2000 / 6000)  # weight sum counts every item


def test_evaluate_cli_matches_jax(capsys):
    args = ["--ckpt", CKPT, "--synthetic", "--max-items", "2", "--pad-to-sec", "0.75", "--json"]
    tevaluate.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jevaluate.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _agree(got, want)


def test_evaluate_cli_prints_the_means(tiny, tmp_path, capsys):
    cfg, pt = tiny
    ckpt = save_checkpoint(str(tmp_path), 0, pt, None, cfg)
    tevaluate.main(["--ckpt", ckpt, "--synthetic", "--max-items", "1", "--pad-to-sec", "0.5",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[1/1] stoi=" in out and "== length-weighted means ==" in out and "pesq_wb:" in out


@pytest.mark.cuda
def test_validate_on_cuda_launches_the_scan_kernel_and_matches_cpu(model):
    """On the card validate runs K1 once per bottleneck layer and utterance,
    and its means agree with the CPU's at the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    from cleanumamba_tpu_torch.ops.cuda import selective_scan as k1

    jcfg, _, pt = model
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    ds = SyntheticDenoiseDataset(n_items=2, crop_length_sec=1.0, seed=7)
    want = validate(pt, cfg, ds)
    k1.selective_scan.launches = 0
    got = validate(tparams.to_device(pt, "cuda:0"), cfg, ds)
    assert k1.selective_scan.launches == cfg.tsfm_n_layers * 2
    _agree(got, want)
