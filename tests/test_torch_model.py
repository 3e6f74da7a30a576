"""PyTorch port model (offline forward, init, checkpoints) vs the JAX package.

Both packages get the same weights (JAX ``init_params`` or a checkpoint ->
numpy -> torch) and the same numpy waveform.  Forward tolerance: max|Δ| <=
1e-4 * max|y_jax| (fp32 on the CPU; ~30 matmuls deep).
"""

import dataclasses
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.models import bottleneck_mamba as tmamba
from cleanumamba_tpu_torch.models import cleanumamba as tm

SMALL = CleanUMambaConfig(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
                          tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
CKPTS = ["artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"]
REL = 1e-4

_jax_forward = jax.jit(jm.forward, static_argnums=2)


def _assert_rel(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _wave(seed, B, L, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(B, L)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def small_params():
    pj = jax.jit(jm.init_params, static_argnums=1)(jax.random.PRNGKey(0), SMALL)
    return pj, tparams.from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.mark.parametrize("normalize_input", [True, False])
def test_forward_small_matches_jax(small_params, normalize_input):
    pj, pt = small_params
    cfg = dataclasses.replace(SMALL, normalize_input=normalize_input)
    x = _wave(1, 2, 3000)
    want = np.asarray(_jax_forward(pj, jnp.asarray(x), cfg))
    got = tm.forward(pt, torch.from_numpy(x), cfg)
    assert got.shape == (2, 3000)
    _assert_rel(got, want)


@pytest.mark.parametrize("layout", ["B1L", "BL1"])
def test_forward_accepts_3d_layouts(small_params, layout):
    _, pt = small_params
    x = torch.from_numpy(_wave(2, 2, 700))
    x3 = x[:, None, :] if layout == "B1L" else x[:, :, None]
    torch.testing.assert_close(tm.forward(pt, x3, SMALL), tm.forward(pt, x, SMALL))


def test_forward_return_skips_matches_jax(small_params):
    pj, pt = small_params
    x = _wave(3, 1, 1000)
    _, skips_j = jax.block_until_ready(
        jax.jit(jm.forward, static_argnums=(2, 3))(pj, jnp.asarray(x), SMALL, True))
    _, skips_t = tm.forward(pt, torch.from_numpy(x), SMALL, return_skips=True)
    assert len(skips_t) == len(skips_j) == SMALL.encoder_n_layers + 1
    for sj, st in zip(skips_j, skips_t):
        _assert_rel(st, sj)


@pytest.mark.parametrize("ckpt", CKPTS)
def test_forward_checkpoint_matches_jax(ckpt):
    """Ragged pruned E8 checkpoints (per-layer d_inner, d_state, dt_rank)."""
    ref = jax_load_checkpoint(ckpt)
    cfg, pt = tparams.load_checkpoint(ckpt, "cpu")
    x = _wave(4, 1, 4000, 0.1)
    want = np.asarray(_jax_forward(ref["params"], jnp.asarray(x), ref["config"]))
    _assert_rel(tm.forward(pt, torch.from_numpy(x), cfg), want)


def test_mixer_forward_and_step_match_jax():
    from cleanumamba_tpu.models import bottleneck_mamba as jmamba

    p = jax.tree_util.tree_map(np.asarray, jmamba.mixer_init(jax.random.PRNGKey(3), 16, 40, 8, 3))
    p["out_proj"] = _wave(5, 40, 16)  # non-zero, so the output is not trivially 0
    pt = tparams.from_numpy(p, "cpu")
    x = _wave(6, 2, 9, 1.0).reshape(2, 9, 1) * np.ones((1, 1, 16), np.float32)
    x = x + _wave(7, 2, 9 * 16, 1.0).reshape(2, 9, 16)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    want = np.asarray(
        jax.jit(jmamba.mixer_forward, static_argnums=(2, 3))(pj, jnp.asarray(x), 32, "xla"))
    got = tmamba.mixer_forward(pt, torch.from_numpy(x))
    _assert_rel(got, want, 1e-5)
    cache_j = jmamba.mixer_init_cache(pj, 2)
    cache_t = tmamba.mixer_init_cache(pt, 2)
    step = jax.jit(jmamba.mixer_step)
    for t in range(3):
        cache_j, y_j = jax.block_until_ready(step(pj, cache_j, jnp.asarray(x[:, t])))
        cache_t, y_t = tmamba.mixer_step(pt, cache_t, torch.from_numpy(x[:, t]))
        _assert_rel(y_t, y_j, 1e-5)
        _assert_rel(cache_t["ssm_state"], cache_j["ssm_state"], 1e-5)
    # offline mixer == token steps from an empty cache
    _assert_rel(got[:, 2], y_j, 1e-5)


def _flat_shapes(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return treedef, [(tuple(x.shape), str(x.dtype)) for x in leaves]


def test_init_params_tree_matches_jax_at_e8():
    """Full E8: same tree, leaf names, shapes and dtypes as JAX init_params
    (jax.eval_shape: nothing computed on the JAX side), and 41.37M params."""
    cfg = CleanUMambaConfig()
    jshape = jax.eval_shape(lambda k: jm.init_params(k, cfg), jax.random.PRNGKey(0))
    pt = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    t_def, t_leaves = _flat_shapes(tparams.to_numpy(pt))
    j_def, j_leaves = _flat_shapes(jshape)
    assert t_def == j_def
    assert t_leaves == j_leaves
    n = tm.count_params(pt)
    assert n == sum(int(np.prod(s)) for s, _ in j_leaves)
    assert round(n / 1e6, 2) in (41.37, 41.38)


def test_init_params_distributions(small_params):
    """Seeded and reproducible; the same distributions as JAX init_params:
    deterministic leaves equal, random leaves with the same spread."""
    pj, _ = small_params
    a = tm.init_params(SMALL, torch.Generator().manual_seed(5), "cpu")
    b = tm.init_params(SMALL, torch.Generator().manual_seed(5), "cpu")
    for x, y in zip(tparams.tree_leaves(a), tparams.tree_leaves(b)):
        assert torch.equal(x, y)
    leaves = jax.tree_util.tree_leaves  # one (sorted-key) order for both trees
    for t, j in zip(leaves(tparams.to_numpy(a)), leaves(pj)):
        j = np.asarray(j)
        if j.size > 1 and j.std() == 0:  # constants: norm scales/biases, D
            np.testing.assert_array_equal(t, j)
        if j.size < 256:
            continue
        assert abs(t.std() - j.std()) <= 0.15 * j.std()
        assert abs(t.mean() - j.mean()) <= 5 * j.std() / np.sqrt(j.size)  # 5 sigma
    m = a["bottleneck"]["layers"][0]["mixer"]
    torch.testing.assert_close(m["A_log"][3], torch.log(torch.arange(1.0, SMALL.d_state + 1)))
    dt = torch.nn.functional.softplus(m["dt_proj_b"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6


def test_other_bottleneck_families_raise():
    """A family name that is none of the five is refused by the config;
    mamba2 and mamba_s4, which once raised here, run their own params (a
    mamba checkpoint's bottleneck is not theirs: it lacks their leaves)."""
    _, pt = tparams.load_checkpoint(CKPTS[0], "cpu")
    with pytest.raises(ValueError, match="not supported"):
        dataclasses.replace(SMALL, bottleneck="gru")
    for family in ("mamba2", "mamba_s4"):
        cfg = dataclasses.replace(SMALL, bottleneck=family)
        with pytest.raises(KeyError):
            tm.bottleneck_forward(pt["bottleneck"], torch.zeros(1, 3, 292), cfg)
        own = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        own = tm.prepare_for_length(own, cfg, 3 * cfg.total_stride)
        y = tm.bottleneck_forward(own["bottleneck"], torch.zeros(1, 3, cfg.tsfm_d_model), cfg)
        assert y.shape == (1, 3, cfg.tsfm_d_model) and torch.isfinite(y).all()


def test_checkpoint_roundtrip(tmp_path):
    """load (port) -> to_numpy -> pickle in the project's format -> load with
    both loaders: identical config and leaves."""
    cfg, pt = tparams.load_checkpoint(CKPTS[1], "cpu")
    path = tmp_path / "rt.pkl"
    path.write_bytes(pickle.dumps({
        "iter": 1, "network_config": cfg.to_reference_json(), "bottleneck": cfg.bottleneck,
        "params": tparams.to_numpy(pt), "opt_state": None}))
    cfg2, pt2 = tparams.load_checkpoint(str(path), "cpu")
    ref = jax_load_checkpoint(str(path))
    assert cfg2 == cfg and dataclasses.asdict(cfg) == dataclasses.asdict(ref["config"])
    leaves = jax.tree_util.tree_leaves  # one (sorted-key) order for all three
    for a, b, c in zip(leaves(tparams.to_numpy(pt2)), leaves(tparams.to_numpy(pt)),
                       leaves(ref["params"])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
