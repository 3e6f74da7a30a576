"""Synthetic speech-like evaluation material (the port's copy of
``cleanumamba_tpu/eval/synth.py``: numpy only, the same values).

The DNS / VCTK-DEMAND test sets the reference evaluates on (its
src/util/python_eval.py, README.md:30) are not in this repository, so
in-repo quality evidence uses procedurally generated
speech-like utterances: harmonic voiced "syllables" (f0 90-280 Hz, six
harmonics, Hann envelopes) plus high-pass fricative bursts — the spectral
and temporal structure PESQ/STOI key on — degraded with additive noise at
controlled SNR.  This is the strongest available in-repository proxy for the
published quality orderings (scripts/zoo_quality.py); absolute DNS numbers
still require the real test set.
"""

from __future__ import annotations

import numpy as np


def speech_like(seed: int, seconds: float = 4.0, fs: int = 16000) -> np.ndarray:
    """Speech-like test signal: harmonic syllables + fricatives, peak 0.3."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    x = np.zeros(n)
    for _ in range(int(seconds * 3)):
        f0 = rng.uniform(90, 280)
        s = int(rng.integers(0, n - fs // 3))
        d = min(int(rng.uniform(0.15, 0.35) * fs), n - s)  # clamp at the
        # buffer end (a start in the last fs//3 can draw a longer burst;
        # rng consumption is unchanged, so in-range seeds are bit-identical)
        tt = t[s:s + d] - t[s]
        e = np.hanning(d)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * tt + rng.uniform(0, 6.28))
                  / (k + 1) for k in range(6))
        x[s:s + d] += e * sig
    for _ in range(int(seconds * 2)):
        s = int(rng.integers(0, n - fs // 8))
        d = min(int(rng.uniform(0.04, 0.12) * fs), n - s)
        burst = rng.normal(size=d)
        burst -= np.convolve(burst, np.ones(9) / 9.0, mode="same")
        x[s:s + d] += 0.25 * np.hanning(d) * burst
    return (x / (np.abs(x).max() + 1e-9) * 0.3).astype(np.float64)


def speech_dense(seed: int, seconds: float = 4.0, fs: int = 16000) -> np.ndarray:
    """Denser, broader-band speech-like signal approximating real recorded
    speech more closely than :func:`speech_like`: ~4.5 syllables/s, up to 20
    harmonics with formant-shaped amplitudes (500/1500/2500 Hz), aspiration
    noise under the voicing envelope, stronger fricatives, and a -50 dB
    room-tone floor (real recordings are never digitally silent).

    Used by scripts/calibrate_pesq.py: perceptual metrics are sensitive to
    voiced density / bandwidth / silence structure, so calibration material
    should resemble the real speech the published characterisations used."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    x = np.zeros(n)
    for _ in range(int(seconds * 4.5)):
        f0 = rng.uniform(90, 280)
        s = int(rng.integers(0, n - fs // 3))
        d = min(int(rng.uniform(0.12, 0.3) * fs), n - s)
        tt = t[s:s + d] - t[s]
        e = np.hanning(d)
        nh = min(20, int(7500 / f0))
        sig = np.zeros(d)
        for k in range(1, nh + 1):
            f = k * f0
            amp = (1.0 / k) * (1 + 2 * np.exp(-((f - 500) / 300) ** 2)
                               + 1.2 * np.exp(-((f - 1500) / 400) ** 2)
                               + 0.8 * np.exp(-((f - 2500) / 500) ** 2))
            sig += amp * np.sin(2 * np.pi * f * tt + rng.uniform(0, 6.28))
        asp = rng.normal(size=d) * 0.05
        x[s:s + d] += e * (sig / (np.abs(sig).max() + 1e-9) + asp)
    for _ in range(int(seconds * 3)):
        s = int(rng.integers(0, n - fs // 8))
        d = min(int(rng.uniform(0.05, 0.15) * fs), n - s)
        burst = rng.normal(size=d)
        burst -= np.convolve(burst, np.ones(9) / 9.0, mode="same")
        x[s:s + d] += 0.5 * np.hanning(d) * burst
    x += rng.normal(size=n) * 3e-3  # room tone ~-50 dB vs peak
    return (x / (np.abs(x).max() + 1e-9) * 0.3).astype(np.float64)


def noise_like(kind: str, n: int, seed: int, fs: int = 16000) -> np.ndarray:
    """Unit-power noise: 'white', 'pink' (1/f spectrum), or 'babble'
    (a sum of six uncorrelated speech-like talkers — the hardest DNS noise
    class for denoisers, spectrally overlapping the target)."""
    rng = np.random.default_rng(seed)
    if kind == "white":
        v = rng.normal(size=n)
    elif kind == "pink":
        w = rng.normal(size=n)
        W = np.fft.rfft(w)
        f = np.fft.rfftfreq(n, 1.0 / fs)
        W[1:] /= np.sqrt(f[1:])
        v = np.fft.irfft(W, n)
    elif kind == "babble":
        v = np.zeros(n)
        for k in range(6):
            talker = speech_like(10_000 + 31 * seed + k, seconds=n / fs + 0.5, fs=fs)
            off = int(rng.integers(0, len(talker) - n))
            v += talker[off:off + n]
    else:
        raise ValueError(f"unknown noise kind {kind!r}")
    return v / (np.sqrt(np.mean(v ** 2)) + 1e-12)


def add_noise(clean: np.ndarray, snr_db: float, seed: int = 0,
              kind: str = "white", fs: int = 16000) -> np.ndarray:
    """clean + noise scaled to the requested segmental-average SNR."""
    v = noise_like(kind, len(clean), seed, fs)
    v *= np.sqrt(np.mean(clean ** 2) / 10 ** (snr_db / 10.0))
    return clean + v
