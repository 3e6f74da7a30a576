"""STFT magnitude for the training loss (port of ``cleanumamba_tpu/ops/stft.py``).

Same semantics as the JAX package's frames x DFT-bank matmul, computed here
with ``torch.stft``: center=True with reflect padding of n_fft//2, the
periodic Hann window of ``win_length`` zero-padded centred to n_fft, the
one-sided spectrum, and the magnitude clamped at 1e-7 before the sqrt.
"""

from __future__ import annotations

import torch


def stft_magnitude(x, fft_size: int, hop_size: int, win_length: int):
    """|STFT| of x (B, T) -> (B, n_frames, fft_size//2 + 1) fp32, with
    n_frames = 1 + T // hop_size."""
    window = torch.hann_window(win_length, dtype=torch.float32, device=x.device)
    spec = torch.stft(x.float(), fft_size, hop_length=hop_size, win_length=win_length,
                      window=window, center=True, pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (B, freq, frames)
    return torch.sqrt(torch.clamp(power, min=1e-7)).transpose(1, 2)
