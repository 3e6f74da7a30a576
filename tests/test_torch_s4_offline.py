"""The offline half of the Mamba-S4 mixer in the PyTorch port against the
JAX package's (``cleanumamba_tpu/models/bottleneck_s4.py``), on the CPU.

Same weights (JAX ``mixer_init`` or ``s4d_init_kernel`` -> numpy -> torch)
and the same numpy inputs; the port runs first in each test.  Kernels within
1e-4 of max|ref|.  ``extend_kernel_length`` is host numpy on the dense
complex64 system: given the same system (JAX's, patched in) its transform
equals JAX's within 1e-6 of max|ref|; end to end the two packages' complex64
systems differ by ~1e-6 (two LAPACK inverses), which ``dA^l`` amplifies
in ``C~``, so there the kernels are held to 1e-4 of max|ref| and to the
dense recurrence.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models import bottleneck_s4 as js4
from cleanumamba_tpu_torch.models import bottleneck_s4 as ts4
from cleanumamba_tpu_torch.params import from_numpy

MINI = dict(channels_H=32, max_H=64, tsfm_n_head=4, tsfm_d_model=64, tsfm_d_inner=128,
            bottleneck="mamba_s4", normalize_input=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.fixture(scope="module")
def mixer():
    pj = js4.mixer_init(jax.random.PRNGKey(0), JaxConfig(**MINI))
    return pj, from_numpy(_np(pj), "cpu")


@pytest.fixture(scope="module")
def attuned(mixer):
    """Both packages' kernels attuned to 48, then doubled to cover 150."""
    pj, pt = mixer
    kt = ts4.extend_kernel_length(pt["kernel"], 48)
    kj = js4.extend_kernel_length(pj["kernel"], 48)
    return {48: (kt, kj), 150: (ts4.extend_kernel_length(kt, 150),
                                js4.extend_kernel_length(kj, 150))}


@pytest.mark.parametrize("L", [48, 150])
def test_dplr_kernel_matches_jax(attuned, L):
    kt, kj = attuned[L]
    assert kt["l_kernel"] == int(kj["l_kernel"]) == {48: 48, 150: 192}[L]
    for n in (L, L // 3):
        _close(ts4.s4_dplr_kernel(kt, n).numpy(), js4.s4_dplr_kernel(kj, n), 1e-4)


def test_dplr_kernel_on_the_same_attuned_params_matches_jax(attuned):
    """The kernel alone: the port's kernel of JAX's attuned params."""
    _, kj = attuned[150]
    _close(ts4.s4_dplr_kernel(from_numpy(_np(kj), "cpu"), 150).numpy(),
           js4.s4_dplr_kernel(kj, 150), 1e-4)


@pytest.mark.parametrize("L", [48, 150])
def test_dplr_kernel_matches_the_dense_recurrence(attuned, L):
    """The frequency-domain kernel equals dC dA^t dB of the port's own
    discrete system (the JAX test's check, at its tolerance)."""
    kt, _ = attuned[L]
    dA, dB = (x.numpy().astype(np.complex128) for x in ts4._dense_discrete(kt))
    dC = ts4._dC_from_Ctilde(kt, ts4._dense_discrete(kt)[0]).numpy().astype(np.complex128)
    K, s = np.zeros((dC.shape[0], dB.shape[0], L)), dB.copy()
    for t in range(L):
        K[:, :, t] = np.einsum("chn,hn->ch", dC, s).real
        s = np.einsum("hmn,hn->hm", dA, s)
    np.testing.assert_allclose(ts4.s4_dplr_kernel(kt, L).numpy(), K, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("double", [False, True], ids=["attune", "double"])
def test_extend_kernel_length_transform_matches_jax(mixer, monkeypatch, double):
    """The first attunement (C~ = C (I - dA^L)) and a doubling (C~ (I + dA^l),
    from JAX's attuned params) on the same dense system: 1e-6 of max|ref|,
    the same l_kernel, fp32 pairs."""
    pj, pt = mixer
    monkeypatch.setattr(ts4, "_dense_discrete", lambda kp: tuple(
        torch.from_numpy(np.array(x)) for x in js4._dense_discrete(
            {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
             for k, v in kp.items()})))
    kt, kj = ts4.extend_kernel_length(pt["kernel"], 48), js4.extend_kernel_length(pj["kernel"], 48)
    if double:
        kt = ts4.extend_kernel_length(from_numpy(_np(kj), "cpu"), 150)
        kj = js4.extend_kernel_length(kj, 150)
    assert kt["l_kernel"] == int(kj["l_kernel"]) == (192 if double else 48)
    assert kt["C"].dtype == torch.float32
    _close(kt["C"].numpy(), kj["C"], 1e-6)


def test_extend_kernel_length_keeps_what_needs_nothing(attuned):
    kt, _ = attuned[150]
    assert ts4.extend_kernel_length(kt, 100)["C"] is kt["C"]  # already covers 100
    kd = ts4.s4d_init_kernel(H=2, N=8)
    assert ts4.extend_kernel_length(kd, 1000) == kd  # a diagonal kernel has no l_kernel


def test_dplr_kernel_refuses_a_length_beyond_l_kernel(attuned):
    kt, kj = attuned[48]
    with pytest.raises(ValueError, match="extend_kernel_length"):
        ts4.s4_dplr_kernel(kt, 49)
    with pytest.raises(AssertionError):  # the same condition in JAX
        js4.s4_dplr_kernel(kj, 49)
    with pytest.raises(ValueError, match="l_kernel 0"):
        ts4.s4_dplr_kernel(ts4.mixer_init(torch.Generator().manual_seed(0),
                                          JaxConfig(**MINI))["kernel"], 1)


@pytest.mark.parametrize("disc", ["zoh", "bilinear", "dss"])
def test_diag_kernel_and_init_match_jax(disc):
    kj = js4.s4d_init_kernel(H=4, N=16, disc=disc, seed=3)
    kt = ts4.s4d_init_kernel(H=4, N=16, disc=disc, seed=3)
    for k in ("A_real", "A_imag", "B", "C", "inv_dt"):
        np.testing.assert_array_equal(kt[k].numpy(), np.asarray(kj[k]))
    assert kt["mode"] == str(kj["mode"]) and kt["disc"] == str(kj["disc"])
    for L in (1, 40):
        _close(ts4.s4_diag_kernel(kt, L, disc=disc).numpy(),
               js4.s4_diag_kernel(kj, L, disc=disc), 1e-4)


@pytest.mark.parametrize("mode", ["s4d", "diag", "dss", "s4", "nplr", "dplr"])
def test_kernel_registry_dispatch_matches_jax(attuned, mode):
    assert set(ts4.kernel_registry) == set(js4.kernel_registry)
    if mode in ("s4", "nplr", "dplr"):
        kt, kj = attuned[48]
        kt, kj = {**kt, "mode": mode}, {**kj, "mode": js4.StaticStr(mode)}
    else:
        disc = "dss" if mode == "dss" else "bilinear"
        kj = {**js4.s4d_init_kernel(H=3, N=8, disc=disc, seed=1), "mode": js4.StaticStr(mode)}
        kt = {**from_numpy(_np(kj), "cpu"), "mode": mode}
    _close(ts4.s4_kernel(kt, 32).numpy(), js4.s4_kernel(kj, 32), 1e-4)


def test_fft_long_conv_matches_jax(mixer, attuned):
    pj, pt = mixer
    kt, kj = attuned[48]
    u = (np.random.default_rng(1).normal(size=(2, 40, 16)) * 0.5).astype(np.float32)
    got = ts4.fft_long_conv({**pt, "kernel": kt}, torch.from_numpy(u)).numpy()
    _close(got, js4.fft_long_conv({**pj, "kernel": kj}, jnp.asarray(u)), 1e-4)


@pytest.mark.parametrize("kernel", ["dplr", "s4d"])
def test_mixer_forward_matches_jax(kernel):
    pj = js4.mixer_init(jax.random.PRNGKey(1), JaxConfig(**MINI), kernel_type=kernel)
    T = 40
    if kernel == "dplr":
        pj["kernel"] = js4.extend_kernel_length(pj["kernel"], T)
    pt = from_numpy(_np(pj), "cpu")
    x = (np.random.default_rng(0).normal(size=(2, T, 64)) * 0.5).astype(np.float32)
    _close(ts4.mixer_forward(pt, torch.from_numpy(x)).numpy(),
           js4.mixer_forward(pj, jnp.asarray(x)), 1e-4)


def test_mixer_offline_equals_its_streaming_step(mixer):
    """The port's offline mixer (kernel + FFT) equals its own token steps
    (the dense discrete system), as tests/test_s4.py holds JAX's."""
    _, pt = mixer
    T = 40
    p = {**pt, "kernel": ts4.extend_kernel_length(pt["kernel"], T)}
    x = torch.from_numpy((np.random.default_rng(2).normal(size=(2, T, 64)) * 0.5)
                         .astype(np.float32))
    y_off = ts4.mixer_forward(p, x)
    cache, ys = ts4.mixer_init_cache(p, 2), []
    for t in range(T):
        cache, y = ts4.mixer_step(p, cache, x[:, t])
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_off, atol=1e-3, rtol=1e-3)


def test_kernel_gradients_reach_every_kernel_leaf(attuned):
    """The complex views are built with torch.complex from the stored pairs,
    so the kernel's gradient reaches A_real, A_imag, B, C, P and inv_dt."""
    kt, _ = attuned[48]
    leaves = {k: v.clone().requires_grad_() for k, v in kt.items() if isinstance(v, torch.Tensor)}
    k = ts4.s4_dplr_kernel({**kt, **leaves}, 48)
    grads = torch.autograd.grad(k.square().sum(), list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
