"""PyTorch port of the training losses vs the JAX package.

``stft_magnitude`` (``torch.stft``) against the JAX frames x DFT-bank
matmul, and ``loss_fn`` (L1/L2 + multi-resolution STFT, every band) in value
and in its gradient w.r.t. ``denoised``, on the same numpy waveforms.
fp32 on the CPU; FFT against matmul differ in summation order only.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import losses as jl
from cleanumamba_tpu.config import LossConfig, STFTLossConfig
from cleanumamba_tpu.ops.stft import stft_magnitude as jax_stft_magnitude
from cleanumamba_tpu_torch import losses as tl
from cleanumamba_tpu_torch.ops.stft import stft_magnitude

REL = 1e-4
SMALL_STFT = STFTLossConfig(fft_sizes=(128, 256, 512), hop_sizes=(32, 64, 100),
                            win_lengths=(64, 200, 512))


def _waves(seed, B=2, L=3001):
    rng = np.random.default_rng(seed)
    clean = (rng.normal(size=(B, L)) * 0.3).astype(np.float32)
    den = (clean + 0.1 * rng.normal(size=(B, L))).astype(np.float32)
    return den, clean


def _assert_rel(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


@pytest.mark.parametrize("fft,hop,win", [(512, 50, 240), (256, 64, 256), (1024, 120, 600)])
def test_stft_magnitude_matches_jax(fft, hop, win):
    x, _ = _waves(1)
    got = stft_magnitude(torch.from_numpy(x), fft, hop, win)
    want = np.asarray(jax_stft_magnitude(jnp.asarray(x), fft, hop, win))
    assert tuple(got.shape) == want.shape == (2, 1 + x.shape[1] // hop, fft // 2 + 1)
    _assert_rel(got.numpy(), want)


def test_stft_magnitude_gradient_matches_jax():
    x, _ = _waves(2)
    w = np.random.default_rng(3).normal(size=(2, 1 + 3001 // 64, 129)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (stft_magnitude(xt, 256, 64, 200) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_stft_magnitude(v, 256, 64, 200) * w))(jnp.asarray(x))
    _assert_rel(xt.grad.numpy(), want)


LOSS_CASES = {
    "l1-full": LossConfig(stft_config=SMALL_STFT),
    "l2-full": LossConfig(ell_p=2, ell_p_lambda=2.0, stft_config=SMALL_STFT),
    "l1-high": LossConfig(stft_config=dataclasses.replace(SMALL_STFT, band="high")),
    "l1-high_freq": LossConfig(stft_config=dataclasses.replace(SMALL_STFT, band="high_freq")),
    "l1-no-stft": LossConfig(stft_lambda=0.0),
    "default": LossConfig(),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_fn_and_its_gradient_match_jax(name):
    cfg = LOSS_CASES[name]
    den, clean = _waves(4, L=4096)
    dt = torch.from_numpy(den).requires_grad_()
    loss, aux = tl.loss_fn(dt, torch.from_numpy(clean), cfg)
    loss.backward()

    def jloss(d):
        return jl.loss_fn(d, jnp.asarray(clean), cfg)

    (jv, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(den))
    assert set(aux) == set(jaux)
    for k in aux:
        _assert_rel(aux[k].detach().numpy(), jaux[k])
    _assert_rel(loss.detach().numpy(), jv)
    _assert_rel(dt.grad.numpy(), jg)


def test_stft_loss_bands_slice_frames_or_frequencies():
    """band="high" keeps the reference's frames slice; "high_freq" slices
    frequencies; the two differ from each other and from "full"."""
    den, clean = _waves(5)
    x, y = torch.from_numpy(den), torch.from_numpy(clean)
    vals = {b: [float(v) for v in tl.stft_loss(x, y, 256, 64, 256, b)]
            for b in ("full", "high", "high_freq")}
    assert len({tuple(v) for v in vals.values()}) == 3
    xm, ym = stft_magnitude(x, 256, 64, 256), stft_magnitude(y, 256, 64, 256)
    n = xm.shape[1] // 2
    sc = float((ym[:, n:] - xm[:, n:]).norm() / ym[:, n:].norm())
    assert abs(vals["high"][0] - sc) <= 1e-6 * sc
    with pytest.raises(NotImplementedError):
        tl.stft_loss(x, y, 256, 64, 256, "low")

