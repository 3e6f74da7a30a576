"""Streaming of the lstm, mha, mamba2 and mamba_s4 families: the PyTorch port
vs the JAX package, and against itself.

Same weights (JAX ``init_params`` -> numpy -> torch) and the same numpy audio
through ``stream_prime`` + 6 ``stream_step``s of both packages on the CPU,
with ``normalize_input`` on and off: outputs and every state leaf, atol 2e-5,
rtol 1e-4 (mamba_s4 atol 1e-4: complex64 sums in another order).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import streaming as js
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import cleanumamba as tm

FAMILIES = ["lstm", "mha", "mamba2", "mamba_s4"]
SMALL = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
             tsfm_d_model=16, tsfm_d_inner=32)


def _tol(family):
    return dict(atol=1e-4 if family == "mamba_s4" else 2e-5, rtol=1e-4)


def _audio(cfg, B, n_frames, seed):
    L = cfg.frame_length + n_frames * cfg.total_stride
    return (np.random.default_rng(seed).normal(size=(B, L)) * 0.3).astype(np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    jcfg = JaxConfig(bottleneck=request.param, **SMALL)
    pj = jax_init_params(jax.random.PRNGKey(2), jcfg)
    pt = tparams.from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return request.param, jcfg, pj, pt


@pytest.mark.parametrize("normalize_input", [True, False])
def test_prime_and_steps_match_jax(model, normalize_input):
    family, jcfg, pj, pt = model
    jcfg = dataclasses.replace(jcfg, normalize_input=normalize_input)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = _audio(cfg, 2, 6, seed=21)
    sj, oj = js.stream_prime(pj, jcfg, jnp.asarray(x[:, :fl]))
    st, ot = ts.stream_prime(pt, cfg, torch.from_numpy(x[:, :fl]))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **_tol(family))
    for t in range(6):
        new = x[:, fl + t * tsd: fl + (t + 1) * tsd]
        sj, oj = js.stream_step(pj, jcfg, sj, jnp.asarray(new))
        st, ot = ts.stream_step(pt, cfg, st, torch.from_numpy(new))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **_tol(family))
    if family == "mha":  # the port's rings are batch-leading, a position a row
        bc = st["bottleneck"]
        assert bool((bc["pos"] == bc["pos"][0]).all())
        st = dict(st, bottleneck={"k": bc["k"].transpose(0, 1), "v": bc["v"].transpose(0, 1),
                                  "pos": bc["pos"][0]})
    lt, lj = _leaves(tparams.to_numpy(st)), _leaves(sj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **_tol(family))


def test_block_equals_single_steps(model):
    """A block of 4 frames == 4 single steps (mamba2: one selective scan from
    the carried state; the others: a loop of token steps), on weights from
    the port's own init."""
    family, jcfg, _, _ = model
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    pt = tm.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    fl, tsd = cfg.frame_length, cfg.total_stride
    x = torch.from_numpy(_audio(cfg, 2, 4, seed=22))
    s0, _ = ts.stream_prime(pt, cfg, x[:, :fl])
    sb, ob = ts.stream_step_block(pt, cfg, s0, x[:, fl:])
    ss, outs = s0, []
    for t in range(4):
        ss, o = ts.stream_step(pt, cfg, ss, x[:, fl + t * tsd: fl + (t + 1) * tsd])
        outs.append(o)
    torch.testing.assert_close(ob, torch.cat(outs, 1), atol=1e-5, rtol=1e-4)
    for a, b in zip(_leaves(tparams.to_numpy(sb)), _leaves(tparams.to_numpy(ss))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", ["lstm", "mha"])
def test_streamed_equals_offline(family):
    """normalize_input=False: Streamer feed/flush == the offline forward away
    from the flush boundary (atol 1e-3, the tolerance of tests/test_streaming.py)."""
    cfg = CleanUMambaConfig(bottleneck=family, normalize_input=False, **SMALL)
    pt = tm.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    L = 1500
    x = (np.random.default_rng(23).normal(size=(1, L)) * 0.3).astype(np.float32)
    offline = tm.forward(pt, torch.from_numpy(x), cfg).numpy()
    s = ts.Streamer(pt, cfg, "cpu", fused=False)
    outs = [s.feed(x[:, i: i + 100]) for i in range(0, L, 100)] + [s.flush()]
    streamed = np.concatenate(outs, axis=1)
    assert streamed.shape == (1, L)
    n = L - cfg.frame_length
    np.testing.assert_allclose(streamed[:, :n], offline[:, :n], atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("family", ["mamba2", "mamba_s4"])
def test_offline_forward_not_ported_yet(family):
    """These two families once had a step and no offline forward; they now
    run offline on the port's own init (mamba_s4 after its kernels are
    attuned to the input's length), finite and of the input's shape.  The
    parity with JAX is in tests/test_torch_offline_families.py."""
    cfg = CleanUMambaConfig(bottleneck=family, **SMALL)
    pt = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pt = tm.prepare_for_length(pt, cfg, 500)
    y = tm.forward(pt, torch.zeros(1, 500) + 0.1, cfg)
    assert y.shape == (1, 500) and torch.isfinite(y).all()
