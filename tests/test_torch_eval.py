"""The port's numpy copies of ``eval/metrics.py``, ``eval/pesq_p862.py`` and
``eval/synth.py`` against the JAX package's: exactly the same values on the
same arrays, and the same golden conformance vectors
(``tests/golden/metrics_golden.json``, read as it is, at the tolerances of
tests/test_metrics.py)."""

import json
import os
import sys

import numpy as np
import pytest

from cleanumamba_tpu.eval import metrics as jmet
from cleanumamba_tpu.eval import pesq_p862 as jpesq
from cleanumamba_tpu.eval import synth as jsynth
from cleanumamba_tpu_torch import eval as teval
from cleanumamba_tpu_torch.eval import metrics as tmet
from cleanumamba_tpu_torch.eval import pesq_p862 as tpesq
from cleanumamba_tpu_torch.eval import synth as tsynth

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _pairs():
    sys.path.insert(0, GOLDEN)
    from gen_metric_goldens import make_pairs

    return make_pairs()


PAIRS = _pairs()


def test_the_same_pesq_implementation_is_chosen():
    """Both packages take the ITU C library when it imports and their own
    P.862 otherwise: never one of each."""
    t, j = tmet._pesq_fn, jmet._pesq_fn
    if j.__module__.startswith("cleanumamba_tpu.eval"):
        assert t is tpesq.pesq_p862
    else:
        assert t is j


def test_exports_match_the_jax_package():
    from cleanumamba_tpu import eval as jeval

    assert teval.__all__ == jeval.__all__


@pytest.mark.parametrize("idx", range(len(PAIRS)), ids=[p[0] for p in PAIRS])
def test_metrics_equal_jax_exactly(idx):
    _, clean, proc = PAIRS[idx]
    for name in ("stoi", "segmental_snr", "llr", "wss", "si_sdr"):
        assert getattr(tmet, name)(clean, proc) == getattr(jmet, name)(clean, proc), name


def test_golden_conformance_vectors():
    with open(os.path.join(GOLDEN, "metrics_golden.json")) as f:
        expected = json.load(f)["pairs"]
    assert set(expected) == {name for name, *_ in PAIRS}
    for name, clean, proc in PAIRS:
        e = expected[name]
        assert tmet.wss(clean, proc) == pytest.approx(e["wss"], rel=1e-9, abs=1e-9), name
        assert tmet.llr(clean, proc) == pytest.approx(e["llr"], rel=0.02, abs=0.01), name
        assert tmet.segmental_snr(clean, proc) == pytest.approx(e["segsnr"], rel=0.01,
                                                                abs=0.05), name
        assert tmet.stoi(clean, proc, 16000) == pytest.approx(e["stoi"], abs=0.005), name


def test_eval_waveform_equals_jax_exactly():
    """The whole suite on int16-scaled 2 s signals, PESQ and the composites
    included (what eval/validate.py feeds it)."""
    clean = tsynth.speech_like(9, seconds=2.0)
    deg = tsynth.add_noise(clean, 10.0, seed=5)
    c16, d16 = clean * 32768.0, deg * 32768.0
    got, want = tmet.eval_waveform(c16, d16), jmet.eval_waveform(c16, d16)
    assert list(got) == list(want)
    assert got == want
    assert all(v is not None and np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("fs,mode", [(16000, "wb"), (16000, "nb"), (8000, "nb")])
def test_pesq_p862_equals_jax_exactly(fs, mode):
    clean = tsynth.speech_dense(3, seconds=2.0, fs=fs)
    deg = tsynth.add_noise(clean, 5.0, seed=2, kind="pink")
    assert tpesq.pesq_p862(fs, clean, deg, mode) == jpesq.pesq_p862(fs, clean, deg, mode)


def test_pesq_p862_input_validation_matches_jax():
    x = np.zeros(100, np.float32)
    for mod in (tpesq, jpesq):
        with pytest.raises(ValueError):
            mod.pesq_p862(16000, x, x, "wb")


def test_metric_internals_equal_jax_exactly():
    rng = np.random.default_rng(5)
    x = rng.normal(size=4000)
    a_t, R_t = tmet._lpc(x, 8)
    a_j, R_j = jmet._lpc(x, 8)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(R_t, R_j)
    assert tmet._quad_toeplitz(a_t, R_t) == jmet._quad_toeplitz(a_j, R_j)
    for args in ((10000, 512, 15, 150.0),):
        for a, b in zip(tmet._third_octave_bands(*args), jmet._third_octave_bands(*args)):
            np.testing.assert_array_equal(a, b)
    assert tmet.composite_scores(2.5, 0.6, 40.0, 5.0) == jmet.composite_scores(2.5, 0.6, 40.0, 5.0)
    for fs, n_fft, bands in ((16000, 512, 49), (8000, 256, 42)):
        np.testing.assert_array_equal(tpesq._band_bin_weights(fs, n_fft, bands),
                                      jpesq._band_bin_weights(fs, n_fft, bands))


@pytest.mark.parametrize("gen", ["speech_like", "speech_dense"])
def test_speech_generators_equal_jax_exactly(gen):
    for seed, seconds in ((7, 2.0), (1684, 4.5)):  # 1684: a burst clamped at the end
        np.testing.assert_array_equal(getattr(tsynth, gen)(seed, seconds=seconds),
                                      getattr(jsynth, gen)(seed, seconds=seconds))


@pytest.mark.parametrize("kind", ["white", "pink", "babble"])
def test_noise_and_mixing_equal_jax_exactly(kind):
    np.testing.assert_array_equal(tsynth.noise_like(kind, 32000, 3),
                                  jsynth.noise_like(kind, 32000, 3))
    clean = jsynth.speech_dense(3, seconds=2.0)
    np.testing.assert_array_equal(tsynth.add_noise(clean, 10.0, seed=5, kind=kind),
                                  jsynth.add_noise(clean, 10.0, seed=5, kind=kind))
