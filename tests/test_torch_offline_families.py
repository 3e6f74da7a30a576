"""The offline forward of the mamba2 and mamba_s4 families in the PyTorch
port against the JAX package, on the CPU.

Same weights (JAX ``init_params`` -> numpy -> torch; mamba_s4 kernels
attuned by each package's own ``prepare_for_length``) and the same numpy
audio:
- the whole ``forward`` within 1e-4 of max|ref|;
- offline equals streamed at ``normalize_input=False`` (atol 2e-4, rtol 1e-3);
- the fp32 loss within 1e-5 relative and every gradient leaf within 2e-4
  of its scale, against ``jax.value_and_grad``: the scale is the leaf's
  max|ref|, or 1e-3 of the largest gradient in the model where the leaf's
  own is smaller (mamba2's per-head ``D`` and ``dt_bias``: sums of
  nearly cancelling terms whose JAX gradient itself moves 6e-5..1.1e-4 of
  its max when the input moves by 1e-7 relative);
- ``cli/denoise.py`` on a mamba_s4 checkpoint whose ``l_kernel`` is shorter
  than the input's bottleneck length: it extends the kernels per file
  (``prepare_for_length``), as the JAX CLI does, and equals JAX's output.
The port runs before JAX in each test.
"""

import copy
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu.config import CleanUMambaConfig as JaxConfig
from cleanumamba_tpu.config import LossConfig as JaxLossConfig
from cleanumamba_tpu.losses import loss_fn as jax_loss_fn
from cleanumamba_tpu.models import bottleneck_s4 as js4
from cleanumamba_tpu.models import cleanumamba as jm
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch import streaming as ts
from cleanumamba_tpu_torch.cli import denoise
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig
from cleanumamba_tpu_torch.data.wavio import read_wav, write_wav
from cleanumamba_tpu_torch.models import cleanumamba as tm
from cleanumamba_tpu_torch.train import trainer as tt
from cleanumamba_tpu_torch.train.checkpoint import save_checkpoint

FAMILIES = ["mamba2", "mamba_s4"]
SMALL = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2, tsfm_n_head=2,
             tsfm_d_model=16, tsfm_d_inner=32)
L = 4096


def _arrays(tree, path=()):
    """{key path: numpy array} of a tree of either package; static tags
    (ints, strings, JAX's StaticInt) are not leaves, as in JAX's pytree."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _arrays(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _arrays(x, path + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().float().numpy()}
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {path: np.asarray(tree, np.float32)}
    return {}


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * np.abs(want).max(), rtol=0)


def _grads_close(got, want, tol):
    """Every gradient leaf within ``tol`` of its scale: the leaf's max|ref|,
    or 1e-3 of the model's largest gradient where the leaf's is smaller."""
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.abs(ref).max() for ref in want.values())
    for path, ref in want.items():
        assert np.abs(ref).max() > 0, path
        np.testing.assert_allclose(got[path], ref, rtol=0, err_msg=str(path),
                                   atol=tol * max(np.abs(ref).max(), floor))


def _audio(B, n, seed):
    return (np.random.default_rng(seed).normal(size=(B, n)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    """(family, JAX config, JAX params, port params), mamba_s4 kernels
    attuned for L samples by each package."""
    jcfg = JaxConfig(bottleneck=request.param, **SMALL)
    # mamba_s4's init draws host numpy from a traced key: it cannot be jitted
    init = jm.init_params if request.param == "mamba_s4" else jax.jit(jm.init_params,
                                                                      static_argnums=1)
    pj = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3), jcfg))
    pt = tparams.from_numpy(pj, "cpu")
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    pt = tm.prepare_for_length(pt, cfg, L)
    pj = jm.prepare_for_length(pj, jcfg, L)
    return request.param, jcfg, pj, pt


def test_prepare_for_length_attunes_each_s4_layer(model):
    family, jcfg, pj, pt = model
    if family != "mamba_s4":
        assert tm.prepare_for_length(pt, CleanUMambaConfig(**dataclasses.asdict(jcfg)), L) is pt
        return
    bott = jcfg.valid_length(L) // jcfg.total_stride
    for lt, lj in zip(pt["bottleneck"]["layers"], pj["bottleneck"]["layers"]):
        assert lt["mixer"]["kernel"]["l_kernel"] == int(lj["mixer"]["kernel"]["l_kernel"]) == bott


@pytest.mark.parametrize("normalize_input", [True, False])
def test_forward_matches_jax(model, normalize_input):
    family, jcfg, pj, pt = model
    jcfg = dataclasses.replace(jcfg, normalize_input=normalize_input)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    x = _audio(2, L, seed=11)
    y_t = tm.forward(pt, torch.from_numpy(x), cfg).numpy()
    y_j = np.asarray(jm.forward(jax.tree_util.tree_map(jnp.asarray, pj), jnp.asarray(x), jcfg))
    assert y_t.shape == x.shape
    _close(y_t, y_j, 1e-4)


def test_streamed_equals_offline(model):
    """normalize_input=False: Streamer feed/flush == the offline forward away
    from the flush boundary (atol 2e-4, rtol 1e-3)."""
    family, jcfg, _, pt = model
    cfg = CleanUMambaConfig(**dataclasses.asdict(dataclasses.replace(jcfg,
                                                                      normalize_input=False)))
    n = 1500
    x = _audio(1, n, seed=23)
    offline = tm.forward(pt, torch.from_numpy(x), cfg).numpy()
    s = ts.Streamer(pt, cfg, "cpu", fused=False)
    streamed = np.concatenate([s.feed(x[:, i: i + 100]) for i in range(0, n, 100)]
                              + [s.flush()], axis=1)
    assert streamed.shape == (1, n)
    m = n - cfg.frame_length
    np.testing.assert_allclose(streamed[:, :m], offline[:, :m], atol=2e-4, rtol=1e-3)


def test_train_gradient_matches_jax(model):
    """fp32: the loss, and every gradient leaf (the S4 kernel's A, B, C, P
    and dt included) to 2e-4 of its scale (module docstring)."""
    family, jcfg, pj, pt = model
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    clean = _audio(2, L, seed=31)
    noisy = (clean + 0.1 * np.random.default_rng(32).normal(size=clean.shape)).astype(np.float32)
    grads, aux = tt.make_grad_fn(cfg, LossConfig(), bf16=False)(
        pt, torch.from_numpy(clean[None]), torch.from_numpy(noisy[None]))

    def micro(p):
        return jax_loss_fn(jm.forward(p, jnp.asarray(noisy), jcfg), jnp.asarray(clean),
                           JaxLossConfig())

    (loss, _), gj = jax.jit(jax.value_and_grad(micro, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pj))
    assert abs(float(aux["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    _grads_close(_arrays(tparams.to_numpy(grads)), _arrays(gj), 2e-4)


def test_train_step_runs_with_the_static_kernel_tags(model):
    """A bf16 Adam step carries the S4 kernel's int l_kernel through the
    gradient, the optimizer state and the update unchanged."""
    family, jcfg, _, pt = model
    from cleanumamba_tpu_torch.config import OptimizationConfig
    from cleanumamba_tpu_torch.train.optim import make_optimizer

    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    opt = make_optimizer(OptimizationConfig(n_iters=10), schedule=lambda s: 1e-3)
    step = tt.make_train_step(cfg, LossConfig(), opt, bf16=True)
    clean = _audio(1, L, seed=41)[None]
    new_p, state, aux = step(pt, opt.init(pt), (torch.from_numpy(clean),
                                                torch.from_numpy(clean * 1.1)))
    assert bool(aux["grads_finite"]) and state["count"] == 1
    assert sorted(_arrays(new_p)) == sorted(_arrays(pt))
    if family == "mamba_s4":
        for lp, ln in zip(pt["bottleneck"]["layers"], new_p["bottleneck"]["layers"]):
            assert ln["mixer"]["kernel"]["l_kernel"] == lp["mixer"]["kernel"]["l_kernel"]
            assert isinstance(state["mu"]["bottleneck"]["layers"][0]["mixer"]["kernel"]
                              ["l_kernel"], int)


def test_denoise_cli_extends_a_short_s4_kernel(tmp_path, capsys):
    """A mamba_s4 checkpoint attuned to 8 bottleneck steps, files whose
    bottleneck needs 38 and 63 steps: the CLI extends the kernels for each
    file and writes JAX's output (int16 wav: atol 1e-4)."""
    jcfg = JaxConfig(bottleneck="mamba_s4", **SMALL)
    pj = jm.init_params(jax.random.PRNGKey(5), jcfg)
    for layer in pj["bottleneck"]["layers"]:
        layer["mixer"]["kernel"] = js4.extend_kernel_length(layer["mixer"]["kernel"], 8)
    pj = jax.tree_util.tree_map(np.asarray, pj)
    cfg = CleanUMambaConfig(**dataclasses.asdict(jcfg))
    ckpt = save_checkpoint(str(tmp_path / "ck"), 0, tparams.from_numpy(pj, "cpu"), None, cfg)
    src, dst = tmp_path / "noisy", tmp_path / "out"
    src.mkdir()
    for i, n in enumerate((600, 1000)):
        write_wav(str(src / f"a{i}.wav"), _audio(1, n, seed=50 + i)[0], 16000)
    denoise.main(["--ckpt", ckpt, "--input", str(src), "--output", str(dst), "--device", "cpu"])
    assert "offline throughput" in capsys.readouterr().out
    for i in range(2):
        x, _ = read_wav(str(src / f"a{i}.wav"))
        y, _ = read_wav(str(dst / f"enhanced_a{i}.wav"))
        p = jm.prepare_for_length(copy.deepcopy(pj), jcfg, len(x))
        ref = np.asarray(jm.forward(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x[None]), jcfg))[0]
        np.testing.assert_allclose(y, np.clip(ref, -1, 1), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_train_step_on_cuda_match_cpu(family):
    """On the card (TF32 off): the fp32 forward within 1e-4 of max|ref| of
    the CPU's, streamed equal to offline at ``normalize_input=False``, and a
    bf16 train step whose loss is finite and within 2e-4 relative of the
    CPU's (the checks of chip_smoke.py phase 16 at a small size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    from cleanumamba_tpu_torch.config import OptimizationConfig
    from cleanumamba_tpu_torch.train.optim import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CleanUMambaConfig(bottleneck=family, **SMALL)
    pc = tm.prepare_for_length(tm.init_params(cfg, torch.Generator().manual_seed(8), "cpu"),
                               cfg, L)
    pg = tparams.to_device(pc, "cuda:0")
    clean = _audio(2, L, seed=33)
    noisy = (clean + 0.1 * np.random.default_rng(34).normal(size=clean.shape)).astype(np.float32)
    with torch.no_grad():
        y_c = tm.forward(pc, torch.from_numpy(noisy), cfg)
        y_g = tm.forward(pg, torch.from_numpy(noisy).cuda(), cfg).cpu()
    _close(y_g.numpy(), y_c.numpy(), 1e-4)

    cfg_n = dataclasses.replace(cfg, normalize_input=False)
    x = _audio(1, 1500, seed=35)
    with torch.no_grad():
        offline = tm.forward(pg, torch.from_numpy(x).cuda(), cfg_n).cpu().numpy()
    s = ts.Streamer(pg, cfg_n, "cuda:0")
    streamed = np.concatenate([s.feed(x[:, i: i + 100]) for i in range(0, 1500, 100)]
                              + [s.flush()], axis=1)
    m = 1500 - cfg.frame_length
    np.testing.assert_allclose(streamed[:, :m], offline[:, :m], atol=2e-4, rtol=1e-3)

    opt = make_optimizer(OptimizationConfig(n_iters=10), schedule=lambda s: 1e-4)
    step = tt.make_train_step(cfg, LossConfig(), opt, bf16=True)
    losses = []
    for d, p in (("cuda:0", pg), ("cpu", pc)):
        batch = (torch.from_numpy(clean[None]).to(d), torch.from_numpy(noisy[None]).to(d))
        _, _, aux = step(p, opt.init(p), batch)
        assert bool(aux["grads_finite"]), d
        losses.append(float(aux["loss"]))
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 2e-4 * abs(losses[1])
