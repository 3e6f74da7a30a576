"""PyTorch port (cleanumamba_tpu_torch) ops and params vs the JAX package.

Same inputs, made with numpy from a seed, go through each JAX op and its
port on the CPU.  fp32 tolerance: rtol=1e-5, atol=1e-5 (summation order
only).
"""

import dataclasses
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.ops import conv as jconv
from cleanumamba_tpu.ops import norms as jnorms
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.ops import conv as tconv
from cleanumamba_tpu_torch.ops import norms as tnorms

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (2, 4)])
def test_conv1d(stride, groups):
    x, w, b = _np(2, 37, 8, seed=1), _np(4, 8 // groups, 12, seed=2), _np(12, seed=3)
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, groups))
    _close(tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                        stride, groups), want)


@pytest.mark.parametrize("L", [40, 41])
def test_conv1d_strided_matmul(L):
    x, w, b = _np(2, L, 3, seed=4), _np(4, 3, 6, seed=5), _np(6, seed=6)
    want = np.asarray(jconv.conv1d_strided_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 2))
    _close(tconv.conv1d_strided_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                       torch.from_numpy(b), 2), want)


@pytest.mark.parametrize("K,S", [(4, 2), (6, 3), (3, 2), (5, 1)])  # K == 2S and generic
def test_conv_transpose1d(K, S):
    x, w, b = _np(2, 9, 5, seed=7), _np(K, 5, 3, seed=8), _np(3, seed=9)
    want = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), S))
    _close(tconv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), S), want)


@pytest.mark.parametrize("with_bias", [False, True])
def test_causal_depthwise_conv(with_bias):
    x, w, b = _np(2, 17, 6, seed=10), _np(4, 6, seed=11), _np(6, seed=12)
    bj, bt = (jnp.asarray(b), torch.from_numpy(b)) if with_bias else (None, None)
    want = np.asarray(jconv.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), bj))
    _close(tconv.causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w), bt), want)


@pytest.mark.parametrize("act", ["Sigmoid", "ReLU", "SiLU", "GELU"])
@pytest.mark.parametrize("bypass", [0, 3])
def test_glu_activation(act, bypass):
    x = _np(2, 5, bypass + 2 * 7, seed=13) * 3
    want = np.asarray(jconv.glu_activation(jnp.asarray(x), act, bypass))
    _close(tconv.glu_activation(torch.from_numpy(x), act, bypass), want)


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm(with_bias):
    x, s, b = _np(3, 4, 16, seed=14) * 2 + 1, _np(16, seed=15), _np(16, seed=16)
    bj, bt = (jnp.asarray(b), torch.from_numpy(b)) if with_bias else (None, None)
    want = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(s), bj, 1e-5))
    _close(tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(s), bt, 1e-5), want)


def test_rms_norm():
    x, s = _np(3, 4, 16, seed=17) * 2 + 1, _np(16, seed=18)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5), want)


def test_norm_keeps_bf16_dtype_with_fp32_statistics():
    x = _np(2, 16, seed=19) * 100 + 1000
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y = tnorms.layer_norm(xt, torch.ones(16), torch.zeros(16))
    want = jnorms.layer_norm(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                             jnp.ones(16), jnp.zeros(16))
    assert y.dtype == torch.bfloat16
    # both round the same fp32 statistics to bf16: within one bf16 ulp
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def _tree():
    return {"a": [np.arange(6, dtype=np.float32).reshape(2, 3),
                  {"A_log": np.ones((2, 2), np.float32), "b": np.ones(3, np.float32)}],
            "n": np.array([1, 2], np.int32), "meta": 7}


def test_from_numpy_to_numpy_roundtrip():
    tree = _tree()
    t = tparams.from_numpy(tree, "cpu")
    assert isinstance(t["a"][0], torch.Tensor) and t["a"][0].dtype == torch.float32
    assert t["n"].dtype == torch.int32 and t["meta"] == 7
    back = tparams.to_numpy(t)
    np.testing.assert_array_equal(back["a"][0], tree["a"][0])
    np.testing.assert_array_equal(back["a"][1]["A_log"], tree["a"][1]["A_log"])
    np.testing.assert_array_equal(back["n"], tree["n"])
    # dtype recasts floating leaves only
    t16 = tparams.from_numpy(tree, "cpu", torch.bfloat16)
    assert t16["a"][0].dtype == torch.bfloat16 and t16["n"].dtype == torch.int32


def test_from_numpy_gives_contiguous_copies():
    """Pickled leaves can be Fortran-ordered; the kernels need C order."""
    f = np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    t = tparams.from_numpy({"w": f}, "cpu")["w"]
    assert t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), f)
    f[0, 0] = -1.0
    assert t[0, 0].item() == 0.0  # a copy, not a view of the numpy buffer


def test_prepare_weight_view_bf16_keeps_sensitive_and_1d_leaves_fp32():
    t = tparams.from_numpy(_tree(), "cpu")
    v = tparams.prepare_weight_view(t, "bf16")
    assert v["a"][0].dtype == torch.bfloat16  # 2-D weight
    assert v["a"][1]["A_log"].dtype == torch.float32  # sensitive key
    assert v["a"][1]["b"].dtype == torch.float32  # 1-D
    assert tparams.prepare_weight_view(t, "fp32") is t
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tparams.prepare_weight_view(t, "int8")
    with pytest.raises(ValueError):
        tparams.prepare_weight_view(t, "fp16")


def test_sensitive_keys_match_quant():
    from cleanumamba_tpu.quant import _SENSITIVE_KEYS

    assert tparams._SENSITIVE_KEYS == _SENSITIVE_KEYS


def test_load_checkpoint_matches_jax_loader():
    from cleanumamba_tpu.train.checkpoint import load_checkpoint

    path = "artifacts/capstone_724k_scratch.pkl"
    cfg, params = tparams.load_checkpoint(path, "cpu")
    ref = load_checkpoint(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref["config"])
    got = jax.tree_util.tree_leaves(tparams.to_numpy(params))
    want = jax.tree_util.tree_leaves(ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_load_checkpoint_other_bottleneck_config(tmp_path):
    payload = {"network_config": {"channels_H": 8, "max_H": 16, "encoder_n_layers": 2,
                                  "tsfm_n_layers": 1, "tsfm_n_head": 2, "tsfm_d_model": 16,
                                  "tsfm_d_inner": 32},
               "bottleneck": "lstm", "params": {"w": np.zeros((2, 2), np.float32)}}
    path = tmp_path / "ck.pkl"
    path.write_bytes(pickle.dumps(payload))
    cfg, params = tparams.load_checkpoint(str(path), "cpu")
    assert cfg.bottleneck == "lstm" and params["w"].shape == (2, 2)


def test_port_never_imports_jax():
    """Importing every module of the port (and chip_smoke) loads no jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cleanumamba_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('cleanumamba_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 12  # every module was imported
