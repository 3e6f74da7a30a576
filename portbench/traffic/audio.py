"""Speech-like noisy audio from a seeded ``torch.Generator``, on its device.

The family of the project's synthetic training data (the program's
``data/synth_device.synth_batch``, copied here so that the benchmark's
inputs do not come from the program), laid out for long streams: about
three "syllables" a second, each a 5-harmonic stack at f0 ~ U(80, 300) Hz
under a Hann envelope of U(0.1, 0.4) s at a random start, the row peak-
scaled to U(0.2, 0.8); white noise coloured by an 8-tap exp(-i / tau)
kernel, tau ~ U(1, 4), mixed at an SNR ~ U(snr_lo, snr_hi) dB.  A few large
draws, whatever the length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SYLLABLE_MAX_S = 0.4


def speech_like(gen: torch.Generator, batch: int, length: int, sr: int = 16000,
                snr_db=(0.0, 15.0)):
    """(clean, noisy), each (batch, length) fp32 on ``gen``'s device."""
    dev = gen.device
    n_seg = max(1, int(length / sr * 3))
    span = int(SYLLABLE_MAX_S * sr)

    def u(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    f0 = u((batch, n_seg, 1), 80.0, 300.0)
    start = torch.floor(u((batch, n_seg, 1), 0.0, float(length)))
    dur = torch.floor(u((batch, n_seg, 1), 0.1 * sr, SYLLABLE_MAX_S * sr))
    harm = torch.arange(1.0, 6.0, device=dev)
    amps = u((batch, n_seg, 5), 0.2, 1.0) / harm
    phase = u((batch, n_seg, 5), 0.0, 2 * math.pi)
    level = u((batch, 1), 0.2, 0.8)
    tau = u((batch, 1), 1.0, 4.0)
    snr = u((batch, 1), float(snr_db[0]), float(snr_db[1]))
    white = torch.randn((batch, length + 7), generator=gen, device=dev)

    rel = torch.arange(span, dtype=torch.float32, device=dev)  # (span,)
    inside = rel < dur  # (b, seg, span)
    env = torch.where(inside, 0.5 - 0.5 * torch.cos(2 * math.pi * rel / (dur - 1)), 0.0)
    tt = rel / sr
    sig = torch.zeros((batch, n_seg, span), device=dev)
    for k in range(5):
        sig += amps[..., k:k + 1] * torch.sin(2 * math.pi * f0 * harm[k] * tt
                                              + phase[..., k:k + 1])
    sig = sig * env
    pos = (start + rel).long()  # (b, seg, span)
    pos = pos + (torch.arange(batch, device=dev) * (length + span))[:, None, None]
    clean = torch.zeros(batch * (length + span), device=dev)
    clean.index_add_(0, pos.reshape(-1), sig.reshape(-1))
    clean = clean.reshape(batch, length + span)[:, :length]
    clean = clean * (level / (clean.abs().amax(dim=1, keepdim=True) + 1e-6))

    kern = torch.exp(-torch.arange(8.0, device=dev) / tau)  # (b, 8)
    kern = kern / kern.sum(dim=1, keepdim=True)
    noise = F.conv1d(white[None], kern.flip(1)[:, None, :], groups=batch)[0]
    p_c = clean.square().mean(dim=1, keepdim=True) + 1e-12
    p_n = noise.square().mean(dim=1, keepdim=True) + 1e-12
    noise = noise * torch.sqrt(p_c / (p_n * 10.0 ** (snr / 10.0)))
    return clean, clean + noise
