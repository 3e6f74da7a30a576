"""Synthetic clean + noisy batches drawn on the device (port of
``cleanumamba_tpu/data/synth_device.py``).

The same distribution family as the host ``SyntheticDenoiseDataset``, not
the same bits (another generator):

- clean: ~3 "syllables" per second, each a 5-harmonic stack at
  f0 ~ U(80, 300) Hz under a Hann envelope at a random start and duration
  U(0.1, 0.4) s, peak-scaled to U(0.2, 0.8);
- noise: white normal coloured by an 8-tap exp(-i/tau) kernel,
  tau ~ U(1, 4), mixed at an SNR ~ U(snr_lo, snr_hi) dB.
"""

from __future__ import annotations

import math

import torch


def synth_batch(generator: torch.Generator, batch: int, length: int, sr: int = 16000,
                snr_lo: float = 0.0, snr_hi: float = 15.0):
    """(clean, noisy), each (batch, length) fp32 on the generator's device,
    deterministic per generator state."""
    dev = generator.device
    n_seg = max(1, int(length / sr * 3))

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    f0 = uniform((batch, n_seg, 1), 80.0, 300.0)
    start = torch.floor(uniform((batch, n_seg, 1), 0.0, float(length)))
    dur = torch.floor(uniform((batch, n_seg, 1), 0.1 * sr, 0.4 * sr))
    harm = torch.arange(1.0, 6.0, device=dev)
    amps = uniform((batch, n_seg, 5), 0.2, 1.0) / harm
    phase = uniform((batch, n_seg, 5), 0.0, 6.28)
    level = uniform((batch, 1), 0.2, 0.8)
    tau = uniform((batch, 1), 1.0, 4.0)
    snr_db = uniform((batch, 1), snr_lo, snr_hi)
    white = torch.randn((batch, length), generator=generator, device=dev)

    rel = torch.arange(length, dtype=torch.float32, device=dev) - start  # (b, seg, L)
    mask = (rel >= 0) & (rel < dur)
    tt = torch.where(mask, rel, 0.0) / sr
    env = torch.where(mask, 0.5 - 0.5 * torch.cos(2.0 * math.pi * rel / torch.clamp(dur - 1, min=1)),
                      0.0)
    sig = torch.zeros_like(tt)
    for k in range(5):  # one harmonic at a time keeps the peak at (b, seg, L)
        sig += amps[..., k:k + 1] * torch.sin(2.0 * math.pi * f0 * harm[k] * tt
                                              + phase[..., k:k + 1])
    clean = (env * sig).sum(dim=1)
    clean = clean * (level / (clean.abs().amax(dim=1, keepdim=True) + 1e-6))

    kern = torch.exp(-torch.arange(8.0, device=dev) / tau)  # (b, 8)
    kern = kern / kern.sum(dim=1, keepdim=True)
    # np.convolve(white, kern, mode="same")[n] = sum_i kern[i] * white[n + 3 - i]
    pad = torch.nn.functional.pad(white, (4, 3))  # pad[m] = white[m - 4]
    noise = torch.zeros_like(clean)
    for i in range(8):
        noise += kern[:, i:i + 1] * pad[:, 7 - i: 7 - i + length]
    p_c = clean.square().mean(dim=1, keepdim=True) + 1e-12
    p_n = noise.square().mean(dim=1, keepdim=True) + 1e-12
    noise = noise * torch.sqrt(p_c / (p_n * 10.0 ** (snr_db / 10.0)))
    return clean, clean + noise
