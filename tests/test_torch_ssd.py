"""The Mamba2 SSD scan of the PyTorch port against the JAX package's
(``cleanumamba_tpu/ops/scan.py::ssd_scan``, ``ssd_scan_grad``), on the CPU.

Same numpy inputs through both packages; the port runs first in each test.
Forward within 1e-5 (absolute, on unit-scale inputs); every gradient of
``ssd_scan_grad`` within 1e-4 of that leaf's max|ref| against ``jax.grad``
of JAX's ``ssd_scan_grad``; the mixer's SSD path against its broadcast
selective scan within 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models import bottleneck_mamba2 as jm2
from cleanumamba_tpu.ops import scan as jscan
from cleanumamba_tpu_torch.models import bottleneck_mamba2 as tm2
from cleanumamba_tpu_torch.ops import scan as tscan
from cleanumamba_tpu_torch.params import from_numpy

NAMES = ("x", "dt", "A", "B", "C", "D", "h0")


def _inputs(seed, Bsz=2, L=37, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "x": rng.normal(size=(Bsz, L, H, P)).astype(f),
        "dt": (np.abs(rng.normal(size=(Bsz, L, H))) * 0.2 + 0.01).astype(f),
        "A": (-np.abs(rng.normal(size=(H,))) - 0.2).astype(f),
        "B": rng.normal(size=(Bsz, L, N)).astype(f),
        "C": rng.normal(size=(Bsz, L, N)).astype(f),
        "D": rng.normal(size=(H,)).astype(f),
        "h0": rng.normal(size=(Bsz, H, P, N)).astype(f),
    }


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("with_h0_D", [True, False], ids=["h0_D", "no_h0_D"])
def test_ssd_scan_matches_jax(chunk, with_h0_D):
    inp = _inputs(1, L=100)  # 100: not a multiple of either chunk
    if not with_h0_D:
        inp["D"] = inp["h0"] = None
    args = [inp[k] for k in NAMES]
    y_t, h_t = tscan.ssd_scan(*[None if a is None else torch.from_numpy(a) for a in args],
                              chunk=chunk)
    y_j, h_j = jscan.ssd_scan(*[None if a is None else jnp.asarray(a) for a in args],
                              chunk=chunk)
    assert y_t.dtype == torch.float32 and h_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no_h0"])
def test_ssd_scan_grad_matches_jax_grad(with_h0):
    """Every gradient of the hand-written backward (chunk 8, L = 37: four
    chunks and a padded tail) against jax.grad of JAX's ssd_scan_grad."""
    inp = _inputs(2)
    rng = np.random.default_rng(3)
    gy = rng.normal(size=inp["x"].shape).astype(np.float32)
    gh = rng.normal(size=inp["h0"].shape).astype(np.float32)
    names = NAMES if with_h0 else NAMES[:-1]

    leaves = {k: torch.from_numpy(inp[k]).requires_grad_() for k in names}
    y, hl = tscan.ssd_scan_grad(*[leaves[k] for k in names], *([] if with_h0 else [None]),
                                chunk=8)
    loss = (y * torch.from_numpy(gy)).sum() + (hl * torch.from_numpy(gh)).sum()
    g_t = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))

    def jloss(*args):
        if not with_h0:
            args = (*args, None)
        y, hl = jscan.ssd_scan_grad(*args, 8)
        return jnp.sum(y * gy) + jnp.sum(hl * gh)

    g_j = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(inp[k]) for k in names])
    for k, ref in zip(names, g_j):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g_t[k].numpy(), ref, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"gradient of {k}")


def test_ssd_grad_equals_autograd_through_the_plain_form():
    """The hand-written backward equals autograd through the chunked plain
    forward (which is finite here because the mask is applied before exp)."""
    inp = _inputs(4, L=29)
    leaves = [torch.from_numpy(inp[k]).double().requires_grad_() for k in NAMES]
    gy = torch.from_numpy(np.random.default_rng(5).normal(size=inp["x"].shape))

    def grads(fn):
        y, hl = fn(*leaves, chunk=8)
        return torch.autograd.grad((y * gy).sum() + hl.square().sum(), leaves)

    # fp32 internally in both; compare in the inputs' float64 dtype
    for name, a, b in zip(NAMES, grads(tscan.ssd_scan_grad), grads(tscan.ssd_scan)):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0,
                                   msg=lambda m: f"{name}: {m}")


def test_ssd_grad_finite_where_the_decay_overflows_above_the_diagonal():
    """Large dt * |A| makes exp(s_t - s_tau) overflow for tau > t (where the
    mask zeroes it): the forward and every gradient stay finite."""
    inp = _inputs(6, Bsz=1, L=32, H=2)
    inp["dt"] = np.full_like(inp["dt"], 8.0)
    inp["A"] = np.array([-6.0, -3.0], np.float32)  # |s| grows by 24..48 per step
    s = np.cumsum(inp["dt"][0, :16] * inp["A"], axis=0)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp((s[None, :, :] - s[:, None, :]).astype(np.float32))).all()
    leaves = [torch.from_numpy(inp[k]).requires_grad_() for k in NAMES]
    y, hl = tscan.ssd_scan_grad(*leaves, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(hl).all()
    grads = torch.autograd.grad(y.square().sum() + hl.square().sum(), leaves)
    for name, g in zip(NAMES, grads):
        assert torch.isfinite(g).all(), name


def _mixer_params(seed):
    jcfg = JaxConfig(channels_H=16, max_H=32, encoder_n_layers=4, tsfm_n_layers=2,
                     tsfm_n_head=2, tsfm_d_model=32, tsfm_d_inner=64, bottleneck="mamba2")
    pj = jm2.mixer_init(jax.random.PRNGKey(seed), jcfg)
    return pj, from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def test_mixer_forward_ssd_equals_broadcast():
    _, pt = _mixer_params(0)
    x = torch.from_numpy((np.random.default_rng(7).normal(size=(2, 50, 32)) * 0.5)
                         .astype(np.float32))
    y1 = tm2.mixer_forward(pt, x, use_ssd=True)
    y2 = tm2.mixer_forward(pt, x, use_ssd=False)
    torch.testing.assert_close(y1, y2, atol=1e-4 * float(y2.abs().max()), rtol=0)


@pytest.mark.parametrize("use_ssd", [True, False], ids=["ssd", "broadcast"])
def test_mixer_forward_matches_jax(use_ssd):
    pj, pt = _mixer_params(1)
    x = (np.random.default_rng(8).normal(size=(2, 70, 32)) * 0.5).astype(np.float32)
    y_t = tm2.mixer_forward(pt, torch.from_numpy(x), use_ssd=use_ssd).numpy()
    y_j = np.asarray(jm2.mixer_forward(pj, jnp.asarray(x), use_ssd=use_ssd))
    np.testing.assert_allclose(y_t, y_j, atol=1e-4 * np.abs(y_j).max(), rtol=0)

