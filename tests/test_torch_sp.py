"""Sequence parallelism of the port (``parallel/sequence.py``) on the CPU,
against the JAX package's ``parallel/sequence.py`` and against zero-primed
streaming.

``mesh=None`` (one segment, no collective) runs in process against JAX's
``sp_stream_denoise`` on a 1-device mesh; the two-rank cases run once for the
file as two gloo ranks, each a subprocess of
``tests/torch_parallel_worker.py`` (no JAX there), against JAX's on a
2-device mesh (``tests/conftest.py`` gives JAX 8 CPU devices).  Weights are
made once by JAX's ``init_params``.  Tolerance: JAX's own, ``atol=3e-4,
rtol=2e-3`` (``tests/test_sequence_parallel.py``).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JCfg
from cleanumamba_tpu.models import bottleneck_s4 as js4
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cleanumamba_tpu.parallel.sequence import sp_stream_denoise as jax_sp
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.parallel.sequence import _WARM, sp_stream_denoise
from cleanumamba_tpu_torch.streaming import Streamer
from torch_parallel_worker import launch

TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=3, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32, normalize_input=False)
TS = 16  # TINY's total stride
TOL = dict(atol=3e-4, rtol=2e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(bottleneck="mamba", normalize=False, **kw):
    return JCfg(**{**TINY, "bottleneck": bottleneck, "normalize_input": normalize, **kw})


def _weights(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed), jcfg))


def _pcfg(jcfg):
    return CleanUMambaConfig(**dataclasses.asdict(jcfg))


def _jax_sp(w, jcfg, x, n_dev):
    """JAX's sp_stream_denoise, jitted over the input with the weights as
    constants.  mamba_s4's discrete systems are built on the host from
    concrete weights: JAX's own ``sp_discrete_system`` runs first, eagerly,
    and hands its results to the traced call in layer order."""
    params = jax.tree_util.tree_map(jnp.asarray, w)
    mesh = jax_make_mesh(n_dev)
    systems = iter([js4.sp_discrete_system(lp["mixer"])
                    for lp in params["bottleneck"]["layers"]] if jcfg.bottleneck == "mamba_s4"
                   else [])
    with mock.patch.object(js4, "sp_discrete_system", lambda mixer: next(systems)):
        return np.asarray(jax.jit(lambda v: jax_sp(params, jcfg, v, mesh))(jnp.asarray(x)))


def _signal(seed, L, scales=(0.3,)):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=L).astype(np.float32) * s for s in scales])


ONE = {  # mesh=None cases: (bottleneck, normalize_input)
    "mamba": ("mamba", False),
    "mamba_normalized": ("mamba", True),
    "mamba2": ("mamba2", False),
    "mamba_s4_normalized": ("mamba_s4", True),
}


@pytest.mark.parametrize("name", list(ONE))
def test_one_segment_matches_jax(name):
    """``mesh=None`` against JAX's SP at n_dev=1 (an unaligned length)."""
    jcfg = _jcfg(*ONE[name])
    w = _weights(jcfg)
    x = _signal(0, 97 * TS + 5)
    got = sp_stream_denoise(tparams.from_numpy(w, "cpu"), _pcfg(jcfg), x, device="cpu")
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _jax_sp(w, jcfg, x, 1), **TOL)


TWO = {  # two-rank cases: (config kwargs, signal seed, length, batch scales)
    "mamba": (dict(), 0, 97 * TS + 5, (0.3,)),
    "mamba_normalized_batch2": (dict(normalize=True), 2, 41 * TS + 7, (0.3, 0.05)),
    "mamba2": (dict(bottleneck="mamba2"), 0, 97 * TS + 5, (0.3,)),
    "mamba_s4_normalized": (dict(bottleneck="mamba_s4", normalize=True), 0, 97 * TS + 5, (0.3,)),
    "short": (dict(), 1, 2 * TS + 3, (0.3,)),  # below the halo: pads up
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cases = {}
    for name, (kw, seed, L, scales) in TWO.items():
        jcfg = _jcfg(**kw)
        cases[name] = (dataclasses.asdict(jcfg), _weights(jcfg), _signal(seed, L, scales))
    ranks = launch("sp", {"cases": cases}, str(tmp_path_factory.mktemp("sp")))
    return cases, ranks


@pytest.mark.parametrize("name", list(TWO))
def test_two_ranks_match_jax(two_ranks, name):
    """Two ranks against JAX's SP at n_dev=2; both ranks get the whole output."""
    cases, (r0, r1) = two_ranks
    fields, w, x = cases[name]
    got = r0[name]
    assert got.shape == x.shape and np.array_equal(got, r1[name])
    np.testing.assert_allclose(got, _jax_sp(w, JCfg(**fields), x, 2), **TOL)


def test_two_ranks_match_zero_primed_streaming(two_ranks):
    """The normalised batch-2 case (the two rows at different scales, so that
    their EMA rows differ) against the port's own Streamer on
    ``[zeros(ctx) | x | pad]``, sliced back to x."""
    cases, (r0, _) = two_ranks
    fields, w, x = cases["mamba_normalized_batch2"]
    cfg = CleanUMambaConfig(**fields)
    ts, fl = cfg.total_stride, cfg.frame_length
    ctx = fl + (_WARM - 1) * ts
    B, L = x.shape
    total = -(-(L + fl - ts) // (2 * ts)) * (2 * ts)
    padded = np.concatenate([np.zeros((B, ctx), np.float32), x,
                             np.zeros((B, total - L), np.float32)], axis=1)
    s = Streamer(tparams.from_numpy(w, "cpu"), cfg, "cpu", batch=B)
    ref = np.concatenate([s.feed(padded), s.flush()], axis=1)[:, ctx: ctx + L]
    np.testing.assert_allclose(r0["mamba_normalized_batch2"], ref, **TOL)


def _refusal(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("kw", [dict(bottleneck="mha"), dict(bottleneck="lstm"),
                                dict(d_conv=5)], ids=["mha", "lstm", "d_conv5"])
def test_refusals_match_jax(kw):
    """MHA and LSTM bottlenecks, and a conv needing more warm tokens than
    carried: JAX's exception type and message."""
    jcfg = _jcfg(**kw)
    w = _weights(jcfg, seed=1)
    x = np.zeros((1, 4096), np.float32)
    want = _refusal(lambda: jax_sp(jax.tree_util.tree_map(jnp.asarray, w), jcfg,
                                   jnp.asarray(x), jax_make_mesh(1)))
    got = _refusal(lambda: sp_stream_denoise(tparams.from_numpy(w, "cpu"), _pcfg(jcfg), x,
                                             device="cpu"))
    assert got == want and want[0] is NotImplementedError
