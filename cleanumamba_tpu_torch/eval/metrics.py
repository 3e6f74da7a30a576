"""Objective speech-quality metrics (host-side numpy; the port's copy of
``cleanumamba_tpu/eval/metrics.py``, the same values and the same choice of
PESQ implementation, so that both packages score alike).

Replaces the reference's metric stack (src/util/python_eval.py:81-459):
PESQ (optional C lib), STOI, WSS, LLR, segmental SNR and the CSIG/CBAK/COVL
composites.  The non-PESQ metrics are implemented from their published
definitions:

- STOI: C.H. Taal et al., "An Algorithm for Intelligibility Prediction of
  Time-Frequency Weighted Noisy Speech", IEEE TASLP 2011.
- WSS: Klatt 1982 weighted spectral slope distance, as specified in
  P. Loizou, "Speech Enhancement: Theory and Practice" (composite.m).
- LLR: Itakura log-likelihood ratio with Levinson-Durbin LPC, same source.
- segSNR: frame SNR clipped to [-10, 35] dB, same source.
- composites: Hu & Loizou 2008 regression weights.
- PESQ: from-scratch ITU-T P.862/P.862.2 (eval/pesq_p862.py).

Validation: WSS/LLR/segSNR are checked against golden vectors
cross-computed from the reference's own implementations (WSS value-parity
exact), STOI against an independently-written from-paper implementation —
tests/golden/metrics_golden.json, regenerated by tests/golden/gen_metric_goldens.py.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

try:  # prefer the ITU reference C library when present
    from pesq import pesq as _pesq_fn
except ImportError:  # from-scratch P.862/P.862.2 (eval/pesq_p862.py)
    from cleanumamba_tpu_torch.eval.pesq_p862 import pesq_p862 as _pesq_fn


# ---------------------------------------------------------------------------
# STOI
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_SEG = 30  # analysis segment length (frames) ~384 ms
_STOI_BETA = -15.0  # lower SDR bound (dB)
_STOI_DYN_RANGE = 40.0  # silent-frame removal threshold (dB)


def _resample(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    if fs_in == fs_out:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(fs_in, fs_out)
    return resample_poly(x, fs_out // g, fs_in // g)


def _third_octave_bands(fs: int, nfft: int, n_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(n_bands, dtype=float)
    cf = min_freq * 2.0 ** (k / 3.0)
    lo = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    hi = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((n_bands, len(f)))
    for i in range(n_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _frame_signal(x: np.ndarray, frame: int, hop: int,
                  ref_count: bool = False) -> np.ndarray:
    """Strided frames.  ``ref_count=True`` uses the reference metric stack's
    frame count int(len/hop - frame/hop) (python_eval.py:244,360,419), one
    frame fewer than the maximal count when (len - frame) % hop == 0."""
    if ref_count:
        n = max(0, int(len(x) / hop - frame / hop))
    else:
        n = 1 + max(0, (len(x) - frame)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, frame, hop):
    w = np.hanning(frame + 2)[1:-1]
    xf = _frame_signal(x, frame, hop) * w
    yf = _frame_signal(y, frame, hop) * w
    energies = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (len(xf) - 1) * hop + frame if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + frame] += xf[i]
        ys[i * hop : i * hop + frame] += yf[i]
    return xs, ys


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int = 16000) -> float:
    """Short-time objective intelligibility in [~0, 1]."""
    n = min(len(clean), len(processed))
    x = _resample(np.asarray(clean[:n], float), fs, _STOI_FS)
    y = _resample(np.asarray(processed[:n], float), fs, _STOI_FS)
    x, y = _remove_silent_frames(x, y, _STOI_DYN_RANGE, _STOI_FRAME, _STOI_HOP)
    if len(x) < _STOI_FRAME * 2:
        return float("nan")
    w = np.hanning(_STOI_FRAME + 2)[1:-1]
    xf = _frame_signal(x, _STOI_FRAME, _STOI_HOP) * w
    yf = _frame_signal(y, _STOI_FRAME, _STOI_HOP) * w
    X = np.abs(np.fft.rfft(xf, _STOI_NFFT, axis=1))
    Y = np.abs(np.fft.rfft(yf, _STOI_NFFT, axis=1))
    obm = _third_octave_bands(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    Xb = np.sqrt(obm @ (X.T**2))  # (bands, frames)
    Yb = np.sqrt(obm @ (Y.T**2))
    n_frames = Xb.shape[1]
    if n_frames < _STOI_SEG:
        return float("nan")
    clip = 10.0 ** (-_STOI_BETA / 20.0)
    scores = []
    for m in range(_STOI_SEG, n_frames + 1):
        Xs = Xb[:, m - _STOI_SEG : m]  # (15, 30)
        Ys = Yb[:, m - _STOI_SEG : m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12
        )
        Yp = np.minimum(Ys * alpha, Xs * (1.0 + clip))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Yp - Yp.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        scores.append(np.mean(num / den))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Segmental SNR / LLR / WSS (Loizou composite.m definitions)
# ---------------------------------------------------------------------------

def segmental_snr(
    clean: np.ndarray,
    processed: np.ndarray,
    fs: int = 16000,
    frame_sec: float = 0.03,
    overlap: float = 0.75,
    snr_min: float = -10.0,
    snr_max: float = 35.0,
) -> float:
    n = min(len(clean), len(processed))
    clean, processed = np.asarray(clean[:n], float), np.asarray(processed[:n], float)
    frame = int(round(frame_sec * fs))
    hop = int(frame * (1 - overlap))
    xf = _frame_signal(clean, frame, hop, ref_count=True)
    yf = _frame_signal(processed, frame, hop, ref_count=True)
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, frame + 1) / (frame + 1)))
    xf, yf = xf * w, yf * w
    sig = np.sum(xf**2, axis=1)
    noise = np.sum((xf - yf) ** 2, axis=1)
    snr = 10.0 * np.log10(sig / (noise + 1e-20) + 1e-20)
    return float(np.mean(np.clip(snr, snr_min, snr_max)))


def _lpc(frame: np.ndarray, order: int):
    """Levinson-Durbin autocorrelation LPC; returns (a, R) with a[0]=1."""
    n = len(frame)
    R = np.array([np.dot(frame[: n - k], frame[k:]) for k in range(order + 1)])
    if R[0] <= 0:
        return None, R
    a = np.zeros(order)
    E = R[0]
    for i in range(order):
        acc = R[i + 1]
        for j in range(i):
            acc -= a[j] * R[i - j]
        k = acc / E
        new_a = a.copy()
        new_a[i] = k
        for j in range(i):
            new_a[j] = a[j] - k * a[i - 1 - j]
        a = new_a
        E *= 1.0 - k * k
        if E <= 0:
            return None, R
    return np.concatenate([[1.0], -a]), R


def llr(clean: np.ndarray, processed: np.ndarray, fs: int = 16000) -> float:
    """Itakura log-likelihood ratio, mean over the best 95% of frames."""
    n = min(len(clean), len(processed))
    clean, processed = np.asarray(clean[:n], float), np.asarray(processed[:n], float)
    order = 16 if fs >= 10000 else 10
    frame = int(round(0.03 * fs))
    hop = frame // 4
    xf = _frame_signal(clean, frame, hop, ref_count=True)
    yf = _frame_signal(processed, frame, hop, ref_count=True)
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, frame + 1) / (frame + 1)))
    vals = []
    for i in range(len(xf)):
        a_c, R_c = _lpc(xf[i] * w, order)
        a_p, _ = _lpc(yf[i] * w, order)
        if a_c is None or a_p is None:
            vals.append(np.nan)
            continue
        # toeplitz quadratic forms via autocorrelation of clean frame
        num = _quad_toeplitz(a_p, R_c)
        den = _quad_toeplitz(a_c, R_c)
        if den <= 0 or num <= 0:
            vals.append(np.nan)
            continue
        vals.append(np.log(num / den))
    if not vals:
        return float("nan")
    # sort (nan/invalid frames land at the end), take the best 95%, then
    # drop remaining nans — value-parity with the reference's ordering of
    # these steps (python_eval.py:97-102)
    vals = np.sort(np.asarray(vals))
    keep = vals[: int(round(len(vals) * 0.95))]
    keep = keep[~np.isnan(keep)]
    if keep.size == 0:
        return float("nan")
    return float(np.mean(keep))


def _quad_toeplitz(a: np.ndarray, R: np.ndarray) -> float:
    """a^T T(R) a for symmetric Toeplitz T built from autocorrelation R."""
    order = len(a) - 1
    acc = R[0] * np.dot(a, a)
    for k in range(1, order + 1):
        acc += 2.0 * R[k] * np.dot(a[:-k], a[k:])
    return float(acc)


def wss(clean: np.ndarray, processed: np.ndarray, fs: int = 16000) -> float:
    """Klatt weighted spectral slope distance, best 95% of frames."""
    n = min(len(clean), len(processed))
    clean, processed = np.asarray(clean[:n], float), np.asarray(processed[:n], float)
    frame = int(round(0.03 * fs))
    hop = frame // 4
    n_crit = 25
    # critical band filters (Gaussian, Loizou's cent_freq/bandwidth tables
    # approximated by the bark scale construction)
    max_freq = fs / 2
    n_fft = 2 ** int(np.ceil(np.log2(2 * frame)))
    n_fftby2 = n_fft // 2
    Kmax, Klocmax = 20.0, 1.0
    cent = np.array([
        50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
        703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
        1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
        3276.17, 3597.63,
    ])
    bw = np.array([
        70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056,
        95.3398, 105.411, 116.256, 127.914, 140.423, 153.823, 168.154,
        183.457, 199.776, 217.153, 235.631, 255.255, 276.072, 298.126,
        321.465, 346.136,
    ])
    bw_min = bw[0]
    min_factor = np.exp(-30.0 / (2.0 * 2.303))
    filters = np.zeros((n_crit, n_fftby2))
    for i in range(n_crit):
        f0 = (cent[i] / max_freq) * n_fftby2
        b = (bw[i] / max_freq) * n_fftby2
        norm_factor = np.log(bw_min) - np.log(bw[i])
        j = np.arange(n_fftby2)
        filters[i] = np.exp(-11.0 * (((j - np.floor(f0)) / b) ** 2) + norm_factor)
        filters[i][filters[i] < min_factor] = 0.0
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(1, frame + 1) / (frame + 1)))
    xf = _frame_signal(clean, frame, hop, ref_count=True) * w
    yf = _frame_signal(processed, frame, hop, ref_count=True) * w
    vals = []
    for i in range(len(xf)):
        Xs = np.abs(np.fft.fft(xf[i], n_fft)) ** 2
        Ys = np.abs(np.fft.fft(yf[i], n_fft)) ** 2
        Xb = filters @ Xs[:n_fftby2]
        Yb = filters @ Ys[:n_fftby2]
        Xdb = 10.0 * np.log10(np.maximum(Xb, 1e-10))
        Ydb = 10.0 * np.log10(np.maximum(Yb, 1e-10))
        sx = Xdb[1:] - Xdb[:-1]
        sy = Ydb[1:] - Ydb[:-1]
        # locate nearest peaks / global max weighting (Klatt 1982)
        dbmax_x = Xdb.max()
        dbmax_y = Ydb.max()
        wx = _wss_weights(Xdb, sx, dbmax_x, Kmax, Klocmax)
        wy = _wss_weights(Ydb, sy, dbmax_y, Kmax, Klocmax)
        wgt = (wx + wy) / 2.0
        vals.append(float(np.sum(wgt * (sx - sy) ** 2) / np.sum(wgt)))
    vals = np.sort(np.asarray(vals))
    keep = int(round(len(vals) * 0.95))
    return float(np.mean(vals[:keep]))


def _wss_weights(db, slope, dbmax, Kmax, Klocmax):
    """Klatt weighting; peak localisation value-parity with the reference
    (python_eval.py:273-300, including its peak-at-n-1 convention on rising
    slopes)."""
    n = len(slope)
    wt = np.zeros(n)
    for k in range(n):
        if slope[k] > 0:  # find next peak
            j = k
            while j < n and slope[j] > 0:
                j += 1
            peak = db[j - 1]
        else:  # find previous valley's peak
            j = k
            while j >= 0 and slope[j] <= 0:
                j -= 1
            peak = db[j + 1]
        wmax = Kmax / (Kmax + dbmax - db[k])
        wlocmax = Klocmax / (Klocmax + peak - db[k])
        wt[k] = wmax * wlocmax
    return wt


def si_sdr(clean: np.ndarray, processed: np.ndarray) -> float:
    """Scale-invariant SDR (Le Roux 2019) — framework extension."""
    n = min(len(clean), len(processed))
    s = np.asarray(clean[:n], float)
    s_hat = np.asarray(processed[:n], float)
    alpha = np.dot(s_hat, s) / (np.dot(s, s) + 1e-12)
    target = alpha * s
    noise = s_hat - target
    return float(10.0 * np.log10((np.sum(target**2) + 1e-12) / (np.sum(noise**2) + 1e-12)))


# ---------------------------------------------------------------------------
# Composites + harness
# ---------------------------------------------------------------------------

def composite_scores(pesq_mos: float, llr_v: float, wss_v: float, seg_v: float):
    """Hu & Loizou 2008 composite regressions (reference python_eval.py:111-119)."""

    def bound(x):
        return float(np.clip(x, 1.0, 5.0))

    csig = bound(3.093 - 1.029 * llr_v + 0.603 * pesq_mos - 0.009 * wss_v)
    cbak = bound(1.634 + 0.478 * pesq_mos - 0.007 * wss_v + 0.063 * seg_v)
    covl = bound(1.594 + 0.805 * pesq_mos - 0.512 * llr_v - 0.007 * wss_v)
    return csig, cbak, covl


def eval_waveform(
    clean: np.ndarray, processed: np.ndarray, fs: int = 16000
) -> Dict[str, Optional[float]]:
    """All metrics for one utterance (reference eval_waveform,
    python_eval.py:81-135).  PESQ entries are None when the C lib is absent."""
    out: Dict[str, Optional[float]] = {}
    out["stoi"] = stoi(clean, processed, fs)
    out["segsnr"] = segmental_snr(clean, processed, fs)
    out["llr"] = llr(clean, processed, fs)
    out["wss"] = wss(clean, processed, fs)
    out["si_sdr"] = si_sdr(clean, processed)
    try:
        c16 = np.asarray(clean, np.float32)
        p16 = np.asarray(processed, np.float32)
        out["pesq_wb"] = float(_pesq_fn(fs, c16, p16, "wb")) if fs == 16000 else None
        out["pesq_nb"] = float(_pesq_fn(fs, c16, p16, "nb"))
    except ValueError:  # e.g. too-short signals
        out["pesq_wb"] = out["pesq_nb"] = None
    if out["pesq_wb"] is not None:
        out["csig"], out["cbak"], out["covl"] = composite_scores(
            out["pesq_wb"], out["llr"], out["wss"], out["segsnr"]
        )
    else:
        out["csig"] = out["cbak"] = out["covl"] = None
    return out
