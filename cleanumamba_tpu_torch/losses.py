"""Training losses: L1/L2 + multi-resolution STFT + knowledge distillation
over skip connections (port of ``cleanumamba_tpu/losses.py``).

``band="high"`` keeps the reference's quirk: it slices the second half of
the *frames* axis, not of the frequencies; ``band="high_freq"`` slices the
frequencies.
"""

from __future__ import annotations

import torch

from cleanumamba_tpu_torch.config import LossConfig, STFTLossConfig
from cleanumamba_tpu_torch.ops.stft import stft_magnitude


def stft_loss(x, y, fft_size: int, hop_size: int, win_length: int, band: str = "full"):
    """Single-resolution (spectral convergence, log-magnitude L1) of the
    prediction x against the target y, both (B, T)."""
    x_mag = stft_magnitude(x, fft_size, hop_size, win_length)
    y_mag = stft_magnitude(y, fft_size, hop_size, win_length)
    if band == "high":
        ind = x_mag.shape[1] // 2  # frames axis: the reference's behaviour
        x_mag, y_mag = x_mag[:, ind:, :], y_mag[:, ind:, :]
    elif band == "high_freq":
        ind = x_mag.shape[2] // 2
        x_mag, y_mag = x_mag[..., ind:], y_mag[..., ind:]
    elif band != "full":
        raise NotImplementedError(band)
    sc = (y_mag - x_mag).norm() / y_mag.norm()
    mag = (y_mag.log() - x_mag.log()).abs().mean()
    return sc, mag


def multi_resolution_stft_loss(x, y, cfg: STFTLossConfig):
    """(sc_loss, mag_loss) averaged over the resolutions and scaled by the lambdas."""
    sc_total, mag_total = 0.0, 0.0
    n = len(cfg.fft_sizes)
    for fs, hs, wl in zip(cfg.fft_sizes, cfg.hop_sizes, cfg.win_lengths):
        sc, mag = stft_loss(x, y, fs, hs, wl, cfg.band)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    return cfg.sc_lambda * sc_total / n, cfg.mag_lambda * mag_total / n


def loss_fn(denoised, clean, cfg: LossConfig, skips=None, teacher_skips=None,
            kd_adapters=None):
    """(total loss, aux) for denoised and clean waveforms (B, L).

    aux holds ``reconstruct``, ``stft_sc`` and ``stft_mag`` (when
    stft_lambda > 0) and ``loss``, as 0-d tensors; with ``skips`` and
    ``teacher_skips`` (lists of (B, T, C) activations, one per connection,
    with ``kd_adapters`` from ``train/distill.make_kd_adapters``) also
    ``kd_loss``.
    """
    aux = {}
    if cfg.ell_p == 2:
        ae = (denoised - clean).square().mean()
    elif cfg.ell_p == 1:
        ae = (denoised - clean).abs().mean()
    else:
        raise NotImplementedError(cfg.ell_p)
    loss = ae * cfg.ell_p_lambda
    aux["reconstruct"] = ae * cfg.ell_p_lambda

    if cfg.stft_lambda > 0:
        sc, mag = multi_resolution_stft_loss(denoised.float(), clean.float(), cfg.stft_config)
        loss = loss + (sc + mag) * cfg.stft_lambda
        aux["stft_sc"] = sc * cfg.stft_lambda
        aux["stft_mag"] = mag * cfg.stft_lambda

    if skips is not None and teacher_skips is not None:
        # KD after "Understanding the Role of the Projector in Knowledge
        # Distillation", as the reference applies it (util.py:259-290): the
        # student skip through a 1x1 projection and a batch norm, the teacher
        # skip through a batch norm; log(sum |diff|^4) per connection, averaged
        kd_losses = []
        for ad, s_c, t_c in zip(kd_adapters, skips, teacher_skips):
            s_n = _kd_norm(s_c @ ad["embed_w"] + ad["embed_b"], ad["bn_s"])
            t_n = _kd_norm(t_c, ad["bn_t"])
            kd_losses.append((s_n - t_n).abs().pow(4.0).sum().log() * cfg.kd_p)
        kd = torch.stack(kd_losses).mean()
        loss = loss + kd
        aux["kd_loss"] = kd

    aux["loss"] = loss
    return loss, aux


def _kd_norm(x, bn):
    """Batch-norm style normalisation per channel over (batch, time), with
    the population variance (as ``jnp.var``)."""
    mean = x.mean(dim=(0, 1), keepdim=True)
    var = x.var(dim=(0, 1), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5) * bn["scale"] + bn["bias"]
