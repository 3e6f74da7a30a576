"""PyTorch port checkpoint converter (``convert.py``) and
``cli/denoise.py::load_any_checkpoint`` vs the JAX package.

The reference's own checkpoints are not in the repository, so the files are
written by the JAX package's ``save_reference_checkpoint``: small configs of
all five bottleneck families and both ``artifacts/*.pkl``.  The port's
``load_reference_checkpoint`` gives the JAX loader's config and leaves bit
for bit, its ``export_reference_state_dict`` the JAX export's tensors bit for
bit, and ``load_any_checkpoint`` reads either format of one model to the
same config and leaves.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from cleanumamba_tpu import convert as jconvert
from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from cleanumamba_tpu_torch import convert as tconvert
from cleanumamba_tpu_torch.cli.denoise import load_any_checkpoint
from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.params import from_numpy, load_checkpoint

TINY = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
            tsfm_d_model=16, tsfm_d_inner=32)
FAMILIES = ["mamba", "mamba2", "mamba_s4", "lstm", "mha"]
CKPTS = ["artifacts/pruned_473k_finetuned.pkl", "artifacts/capstone_724k_scratch.pkl"]


def _jax_model(name):
    """(JAX config, numpy params) of a small family config or an artifact."""
    if name in FAMILIES:
        cfg = JaxConfig(bottleneck=name, **TINY)
        return cfg, jax.tree_util.tree_map(np.asarray,
                                           jax_init_params(jax.random.PRNGKey(0), cfg))
    ck = jax_load_checkpoint(name)
    return ck["config"], jax.tree_util.tree_map(np.asarray, ck["params"])


def _assert_tree_equal(ours, theirs, path=()):
    """Port tree (torch leaves, plain ints) == JAX tree (arrays, static ints)."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _assert_tree_equal(ours[k], theirs[k], path + (k,))
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_tree_equal(a, b, path + (i,))
    elif isinstance(ours, torch.Tensor):
        assert ours.dtype == torch.float32, path
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), err_msg=str(path))
    else:  # a static length (mamba_s4's l_kernel)
        assert ours == int(getattr(theirs, "value", theirs)), path


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{name: path} of reference-format files the JAX package wrote."""
    d = tmp_path_factory.mktemp("reference")
    out = {}
    for name in FAMILIES + CKPTS:
        cfg, params = _jax_model(name)
        path = str(d / (name.replace("/", "_") + ".pkl"))
        jconvert.save_reference_checkpoint(path, params, cfg, n_iter=7, run_id="r")
        out[name] = path
    return out


@pytest.mark.parametrize("name", FAMILIES + CKPTS)
def test_load_reference_checkpoint_matches_jax(written, name):
    cfg, params, meta = tconvert.load_reference_checkpoint(written[name], "cpu")
    jcfg, jparams, jmeta = jconvert.load_reference_checkpoint(written[name])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_tree_equal(params, jparams)
    assert meta["iter"] == jmeta["iter"] == 7 and meta["run_id"] == "r"
    assert meta["network_config"] == jmeta["network_config"]


@pytest.mark.parametrize("name", FAMILIES + CKPTS)
def test_export_reference_state_dict_matches_jax(name):
    jcfg, pn = _jax_model(name)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    ours = tconvert.export_reference_state_dict(from_numpy(pn, "cpu"), cfg)
    theirs = jconvert.export_reference_state_dict(pn, jcfg)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and torch.equal(ours[k], theirs[k]), k
    assert tconvert.sniff_bottleneck(ours) == jconvert.sniff_bottleneck(theirs) == \
        jcfg.bottleneck


def test_convert_round_trip(written):
    """export -> convert gives back every leaf bit for bit."""
    cfg, params, _ = tconvert.load_reference_checkpoint(written["mamba_s4"], "cpu")
    back = tconvert.convert_state_dict(tconvert.export_reference_state_dict(params, cfg), cfg)
    _assert_tree_equal(back, jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, params))


@pytest.mark.parametrize("ckpt", CKPTS)
def test_load_any_checkpoint_reads_both_formats(written, ckpt):
    """The project's pickle and the reference file of the same model give the
    same config and leaves; the reference path matches the converter."""
    cfg_a, params_a, meta_a = load_any_checkpoint(ckpt, "cpu")
    cfg_r, params_r, meta_r = load_any_checkpoint(written[ckpt], "cpu")
    cfg_p, params_p = load_checkpoint(ckpt, "cpu")
    assert cfg_a == cfg_p and cfg_r.to_reference_json() == cfg_a.to_reference_json()
    assert dataclasses.asdict(cfg_r) == dataclasses.asdict(
        CleanUMambaConfig.from_reference_json("CleanUMamba", cfg_a.to_reference_json()))
    numpy_a = jax.tree_util.tree_map(lambda t: t.numpy(), params_a)
    _assert_tree_equal(params_p, numpy_a)
    _assert_tree_equal(params_r, numpy_a)
    assert "params" not in meta_a and meta_r["iter"] == 7


def test_load_any_checkpoint_refuses_other_pickles(tmp_path):
    import pickle

    path = tmp_path / "x.pkl"
    path.write_bytes(pickle.dumps({"weights": 1}))
    with pytest.raises(ValueError, match="neither"):
        load_any_checkpoint(str(path), "cpu")
