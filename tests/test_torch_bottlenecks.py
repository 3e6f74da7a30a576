"""The lstm, mha, mamba2 and mamba_s4 bottlenecks of the PyTorch port vs the JAX package.

Weights come from the JAX package's ``init_params`` (numpy -> torch), tokens
from numpy with a seed; both run on the CPU in fp32.  Tolerance: atol 2e-5,
rtol 1e-4 (summation order only); mamba_s4 atol 1e-4, its complex64 sums
run in another order.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models import bottleneck_lstm as jlstm
from cleanumamba_tpu.models import bottleneck_mamba2 as jm2
from cleanumamba_tpu.models import bottleneck_mha as jmha
from cleanumamba_tpu.models import bottleneck_s4 as js4
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.ops import norms as jnorms
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import bottleneck_lstm as tlstm
from cleanumamba_tpu_torch.models import bottleneck_mamba2 as tm2
from cleanumamba_tpu_torch.models import bottleneck_mha as tmha
from cleanumamba_tpu_torch.models import bottleneck_s4 as ts4
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.ops import norms as tnorms

FAMILIES = ["lstm", "mha", "mamba2", "mamba_s4"]
SMALL = dict(channels_H=8, max_H=16, encoder_n_layers=3, tsfm_n_layers=2, tsfm_n_head=2,
             tsfm_d_model=32, tsfm_d_inner=64)
MHA_RING = 4  # fewer slots than steps: the ring wraps


def _tol(family):
    return dict(atol=1e-4 if family == "mamba_s4" else 2e-5, rtol=1e-4)


def _np(tree):
    """JAX pytree -> numpy leaves (static tags stay as they are)."""
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(family, JAX cfg, port cfg, JAX bottleneck params, port bottleneck params)."""
    jcfg = JaxConfig(bottleneck=request.param, **SMALL)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    bj = jax_init_params(jax.random.PRNGKey(7), jcfg)["bottleneck"]
    return request.param, jcfg, cfg, bj, tparams.from_numpy(_np(bj), "cpu")


def _init_caches(name, jcfg, cfg, bj, bt, B):
    if name == "lstm":
        return jlstm.init_cache(bj["layers"], B), tlstm.init_cache(bt["layers"], B)
    if name == "mha":
        return (jmha.init_cache(bj, jcfg, B, MHA_RING), tmha.init_cache(bt, cfg, B, MHA_RING))
    jmod, tmod = (jm2, tm2) if name == "mamba2" else (js4, ts4)
    return ([jmod.mixer_init_cache(lp["mixer"], B) for lp in bj["layers"]],
            [tmod.mixer_init_cache(lp["mixer"], B) for lp in bt["layers"]])


def _steps(name, jcfg, cfg, bj, bt, cj, ct, x):
    """One token through both packages; mixers are chained layer to layer."""
    xt = torch.from_numpy(x)
    if name == "lstm":
        cj, yj = jlstm.step(bj["layers"], cj, jnp.asarray(x))
        ct, yt = tlstm.step(bt["layers"], ct, xt)
    elif name == "mha":
        cj, yj = jmha.step(bj, jcfg, cj, jnp.asarray(x))
        ct, yt = tmha.step(bt, cfg, ct, xt)
    else:
        jmod, tmod = (jm2, tm2) if name == "mamba2" else (js4, ts4)
        yj, yt, nj, nt = jnp.asarray(x), xt, [], []
        for lj, lt, a, b in zip(bj["layers"], bt["layers"], cj, ct):
            a, yj = jmod.mixer_step(lj["mixer"], a, yj)
            b, yt = tmod.mixer_step(lt["mixer"], b, yt)
            nj.append(a)
            nt.append(b)
        cj, ct = nj, nt
    return cj, ct, yj, yt


def _assert_trees_close(got, want, **tol):
    lg = jax.tree_util.tree_leaves(tparams.to_numpy(got))
    lw = jax.tree_util.tree_leaves(_np(want))
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, **tol)


def _as_jax(name, cache):
    """The port's mha cache in the JAX package's layout: each row's rings
    (batch, layers, W, d) as (layers, batch, W, d), and the rows' positions,
    equal here, as JAX's one position."""
    if name != "mha":
        return cache
    pos = cache["pos"]
    assert bool((pos == pos[0]).all()), pos
    return {"k": cache["k"].transpose(0, 1), "v": cache["v"].transpose(0, 1), "pos": pos[0]}


def test_init_cache_matches_jax(family):
    name, jcfg, cfg, bj, bt = family
    cj, ct = _init_caches(name, jcfg, cfg, bj, bt, 2)
    _assert_trees_close(_as_jax(name, ct), cj, **_tol(name))


def test_steps_match_jax(family):
    """6 single-token steps: outputs and caches (for mha the ring wraps)."""
    name, jcfg, cfg, bj, bt = family
    cj, ct = _init_caches(name, jcfg, cfg, bj, bt, 2)
    rng = np.random.default_rng(11)
    for _ in range(6):
        x = rng.normal(size=(2, jcfg.tsfm_d_model)).astype(np.float32)
        cj, ct, yj, yt = _steps(name, jcfg, cfg, bj, bt, cj, ct, x)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **_tol(name))
    _assert_trees_close(_as_jax(name, ct), cj, **_tol(name))


def _assert_same_structure(t, j, path=""):
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(t) == sorted(j), (path, sorted(t), sorted(j))
        for k in j:
            _assert_same_structure(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same_structure(a, b, f"{path}[{i}]")
    elif hasattr(j, "shape"):
        jn = np.asarray(j)
        assert tuple(t.shape) == jn.shape, (path, tuple(t.shape), jn.shape)
        assert tparams.to_numpy(t).dtype == jn.dtype, (path, t.dtype, jn.dtype)
    else:  # a static tag of the S4 kernel: a plain value in the port
        assert isinstance(t, (int, str)) and t == type(t)(j.value), (path, t, j)


def test_init_params_tree_matches_jax(family):
    """The port's init_params: the JAX tree's structure, leaf names, shapes and dtypes."""
    name, jcfg, cfg, _, _ = family
    pj = jax_init_params(jax.random.PRNGKey(0), jcfg)
    pt = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _assert_same_structure(pt, pj)
    assert tm.count_params(pt) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(pj))


@pytest.mark.parametrize("name", ["lstm", "mha"])
def test_forward_matches_jax(name):
    jcfg = JaxConfig(bottleneck=name, **SMALL)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    bj = jax_init_params(jax.random.PRNGKey(8), jcfg)["bottleneck"]
    bt = tparams.from_numpy(_np(bj), "cpu")
    x = np.random.default_rng(12).normal(size=(2, 9, jcfg.tsfm_d_model)).astype(np.float32)
    if name == "lstm":
        want = jlstm.forward(bj["layers"], jnp.asarray(x))
    else:
        want = jmha.forward(bj, jnp.asarray(x), jcfg)
    got = tm.bottleneck_forward(bt, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["lstm", "mha"])
def test_forward_equals_steps(name):
    """The port's offline forward equals its own token steps (zero state)."""
    cfg = CleanUMambaConfig(bottleneck=name, **SMALL)
    bt = tm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")["bottleneck"]
    x = torch.from_numpy(
        np.random.default_rng(13).normal(size=(1, 7, cfg.tsfm_d_model)).astype(np.float32))
    off = tm.bottleneck_forward(bt, x, cfg)
    cache = (tlstm.init_cache(bt["layers"], 1) if name == "lstm"
             else tmha.init_cache(bt, cfg, 1, 16))
    ys = []
    for t in range(x.shape[1]):
        if name == "lstm":
            cache, y = tlstm.step(bt["layers"], cache, x[:, t])
        else:
            cache, y = tmha.step(bt, cfg, cache, x[:, t])
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), off, atol=2e-5, rtol=1e-4)


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(14)
    x, z = (rng.normal(size=(3, 5, 24)).astype(np.float32) for _ in range(2))
    scale = rng.normal(size=(24,)).astype(np.float32)
    want = jnorms.gated_rms_norm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(scale))
    got = tnorms.gated_rms_norm(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_s4_discrete_system_matches_jax():
    """The host-side complex64 discretisation (dense DPLR with l_kernel 0)."""
    jcfg = JaxConfig(bottleneck="mamba_s4", **SMALL)
    pj = jax_init_params(jax.random.PRNGKey(9), jcfg)["bottleneck"]["layers"][0]["mixer"]
    pt = tparams.from_numpy(_np(pj), "cpu")
    assert pt["kernel"]["l_kernel"] == 0 and isinstance(pt["kernel"]["l_kernel"], int)
    want, got = js4.sp_discrete_system(pj), ts4.sp_discrete_system(pt)
    for k in ("dA", "dB", "dC"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4)
