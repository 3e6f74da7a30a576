"""WAV read/write (host-side, replaces torchaudio/PySoundFile — survey N10)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path: str, target_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Read a wav file as float32 in [-1, 1].  Returns (audio (T,), rate)."""
    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if target_rate is not None and rate != target_rate:
        audio = resample_poly(audio, rate, target_rate)
        rate = target_rate
    return audio, rate


def write_wav(path: str, audio: np.ndarray, rate: int = 16000) -> None:
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    wavfile.write(path, rate, (audio * 32767.0).astype(np.int16))


def resample_poly(audio: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    from scipy.signal import resample_poly as _rp
    from math import gcd

    g = gcd(rate_in, rate_out)
    return _rp(audio, rate_out // g, rate_in // g).astype(np.float32)
