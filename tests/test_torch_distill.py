"""Knowledge distillation of the port (``losses.py``'s KD branch,
``train/distill.py``) against the JAX package, on the sizes of
``tests/test_distill.py``: the skip widths and adapters, the KD loss on the
same numpy skips and adapters, one fp32 KD step against JAX's
``make_kd_train_step``, and twelve steps that lower both losses.

The port runs before JAX in each test.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cleanumamba_tpu import losses as jl
from cleanumamba_tpu.config import CleanUMambaConfig as JCfg
from cleanumamba_tpu.config import LossConfig as JLoss
from cleanumamba_tpu.config import OptimizationConfig as JOpt
from cleanumamba_tpu.config import STFTLossConfig as JSTFT
from cleanumamba_tpu.models.cleanumamba import init_params as jax_init_params
from cleanumamba_tpu.train import distill as jd
from cleanumamba_tpu.train.trainer import make_optimizer as jax_make_optimizer
from cleanumamba_tpu_torch import losses as tl
from cleanumamba_tpu_torch import params as tparams
from cleanumamba_tpu_torch.config import CleanUMambaConfig, LossConfig, OptimizationConfig
from cleanumamba_tpu_torch.config import STFTLossConfig
from cleanumamba_tpu_torch.train import distill as td
from cleanumamba_tpu_torch.train.optim import make_optimizer

TEACHER = dict(channels_H=16, max_H=32, encoder_n_layers=4, tsfm_n_layers=2,
               tsfm_n_head=2, tsfm_d_model=32, tsfm_d_inner=64)
STUDENT = dict(channels_H=8, max_H=16, encoder_n_layers=4, tsfm_n_layers=2,
               tsfm_n_head=2, tsfm_d_model=16, tsfm_d_inner=32)
STFT = dict(fft_sizes=(256,), hop_sizes=(64,), win_lengths=(128,))
L = 2048
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops here run on one thread: the suite's workers share the
    cores, and an oversubscribed thread pool makes small ops far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """numpy leaves in one (sorted-key) order for either package's tree."""
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def setup():
    jt_cfg, js_cfg = JCfg(**TEACHER), JCfg(**STUDENT)
    teacher = _np(jax_init_params(jax.random.PRNGKey(0), jt_cfg))
    student = _np(jax_init_params(jax.random.PRNGKey(1), js_cfg))
    adapters = _np(jd.make_kd_adapters(jax.random.PRNGKey(2), js_cfg, jt_cfg))
    rng = np.random.default_rng(0)
    clean = (rng.normal(size=(2, L)) * 0.3).astype(np.float32)
    noisy = (clean + 0.1 * rng.normal(size=(2, L))).astype(np.float32)
    return teacher, student, adapters, clean, noisy


def _tcfg(jcfg):
    return CleanUMambaConfig(**dataclasses.asdict(jcfg))


def test_skip_widths_and_adapter_shapes_equal_jax():
    for kw in (TEACHER, STUDENT, {}):
        assert td.skip_widths(CleanUMambaConfig(**kw)) == jd.skip_widths(JCfg(**kw))
    s_cfg, t_cfg = CleanUMambaConfig(**STUDENT), CleanUMambaConfig(**TEACHER)
    ours = td.make_kd_adapters(torch.Generator().manual_seed(2), s_cfg, t_cfg, device="cpu")
    theirs = jd.make_kd_adapters(jax.random.PRNGKey(2), JCfg(**STUDENT), JCfg(**TEACHER))
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert jax.tree_util.tree_structure(tparams.to_numpy(a)) == \
            jax.tree_util.tree_structure(_np(b))
        for x, y in zip(_leaves(tparams.to_numpy(a)), _leaves(b)):
            assert x.shape == y.shape and x.dtype == y.dtype
        bound = 1 / np.sqrt(a["embed_w"].shape[0])
        assert a["embed_w"].abs().max() <= bound and a["embed_w"].std() > 0.3 * bound
        assert not a["embed_b"].any() and (a["bn_s"]["scale"] == 1).all()
        assert (a["bn_t"]["scale"] == 1).all() and not a["bn_t"]["bias"].any()


@pytest.mark.parametrize("kd_p", [1.0, 0.5])
def test_kd_loss_fn_matches_jax(kd_p):
    """The same numpy skips (student and teacher widths differ) and adapters
    (with non-trivial batch-norm affines): loss and kd_loss to 1e-5."""
    rng = np.random.default_rng(3)
    s_w, t_w = [8, 16, 12], [16, 32, 24]
    skips = [(rng.normal(size=(2, 40 - 5 * i, w)) * (i + 1)).astype(np.float32)
             for i, w in enumerate(s_w)]
    t_skips = [(rng.normal(size=(2, 40 - 5 * i, w)) * 0.5).astype(np.float32)
               for i, w in enumerate(t_w)]
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    adapters = [{"embed_w": f(sw, tw) * 0.3, "embed_b": f(tw) * 0.1,
                 "bn_s": {"scale": 1 + 0.1 * f(tw), "bias": 0.1 * f(tw)},
                 "bn_t": {"scale": 1 + 0.1 * f(tw), "bias": 0.1 * f(tw)}}
                for sw, tw in zip(s_w, t_w)]
    den = f(2, 1024) * 0.3
    clean = f(2, 1024) * 0.3
    stft = dict(fft_sizes=(128,), hop_sizes=(32,), win_lengths=(128,))
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    ours = tl.loss_fn(t(den), t(clean), LossConfig(kd_p=kd_p, stft_config=STFTLossConfig(**stft)),
                      skips=[t(s) for s in skips], teacher_skips=[t(s) for s in t_skips],
                      kd_adapters=tparams.from_numpy(adapters, "cpu"))[1]
    theirs = jl.loss_fn(jnp.asarray(den), jnp.asarray(clean),
                        JLoss(kd_p=kd_p, stft_config=JSTFT(**stft)),
                        skips=[jnp.asarray(s) for s in skips],
                        teacher_skips=[jnp.asarray(s) for s in t_skips],
                        kd_adapters=jax.tree_util.tree_map(jnp.asarray, adapters))[1]
    assert set(ours) == set(theirs) and "kd_loss" in ours
    for k in theirs:
        want = float(theirs[k])
        assert abs(float(ours[k]) - want) <= 1e-5 * abs(want), k


def test_kd_norm_uses_the_population_variance():
    x = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2)
    bn = {"scale": torch.ones(2), "bias": torch.zeros(2)}
    y = tl._kd_norm(x, bn)
    ref = (x - x.mean((0, 1))) / torch.sqrt(x.var((0, 1), unbiased=False) + 1e-5)
    torch.testing.assert_close(y, ref)


# The step compared with JAX: Adam with eps 1.0, so that an update,
# lr * g / (|g| + eps) at the first step, is smooth in g.  With eps 1e-8 it
# is lr * sign(g), and embed_b's gradient is fp32 rounding noise around 0
# (~1e-5: the batch norm removes the shift), whose sign and size differ
# between the packages; the zero-initialised leaves (embed_b, the norm and
# batch-norm biases) hold only their update, so the noise would be the
# whole leaf.  The same arithmetic runs (moments, bias correction, clipping).
STEP_LR = 1e-3


def _opt_cfg():
    return dict(n_iters=1000, learning_rate=STEP_LR, eps=1.0)


def test_kd_step_matches_jax(setup):
    """One fp32 KD step from the same weights, adapters and batch: the
    loss parts to 1e-4, and every leaf of params and adapters within 1e-4 of
    max(its leaf's largest value, 1e-3 of the model's largest)."""
    teacher, student, adapters, clean, noisy = setup
    s_cfg, t_cfg = _tcfg(JCfg(**STUDENT)), _tcfg(JCfg(**TEACHER))
    opt = make_optimizer(OptimizationConfig(**_opt_cfg()), schedule=lambda s: STEP_LR)
    step = td.make_kd_train_step(s_cfg, t_cfg, LossConfig(kd_p=1.0, stft_config=STFTLossConfig(
        **STFT)), opt)
    p0, a0 = tparams.from_numpy(student, "cpu"), tparams.from_numpy(adapters, "cpu")
    p_t, a_t, state, aux_t = step(p0, a0, opt.init((p0, a0)),
                                  tparams.from_numpy(teacher, "cpu"),
                                  (torch.from_numpy(clean), torch.from_numpy(noisy)))

    jopt = jax_make_optimizer(JOpt(**_opt_cfg()), schedule=lambda s: STEP_LR)
    jstep = jax.jit(jd.make_kd_train_step(JCfg(**STUDENT), JCfg(**TEACHER),
                                          JLoss(kd_p=1.0, stft_config=JSTFT(**STFT)), jopt))
    pj, aj = jax.tree_util.tree_map(jnp.asarray, (student, adapters))
    p_j, a_j, _, aux_j = jstep(pj, aj, jopt.init((pj, aj)),
                               jax.tree_util.tree_map(jnp.asarray, teacher),
                               (jnp.asarray(clean), jnp.asarray(noisy)))
    assert state["count"] == 1
    for k in ("loss", "kd_loss", "reconstruct", "stft_sc", "stft_mag"):
        want = float(aux_j[k])
        assert abs(float(aux_t[k]) - want) <= 1e-4 * abs(want), k
    t_leaves = _leaves(tparams.to_numpy([p_t, a_t]))
    j_leaves = _leaves([_np(p_j), _np(a_j)])
    assert len(t_leaves) == len(j_leaves)
    floor = 1e-3 * max(np.abs(x).max() for x in j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), floor)
    # the step moved every adapter leaf and the student
    for a, a0 in zip(_leaves(tparams.to_numpy(a_t)), _leaves(adapters)):
        assert not np.array_equal(a, a0)
    assert any(not np.array_equal(p, p0) for p, p0 in zip(_leaves(tparams.to_numpy(p_t)),
                                                          _leaves(student)))


def test_twelve_kd_steps_lower_loss_and_kd_loss(setup):
    """JAX's test_kd_step_runs_and_improves on the port: Adam at 1e-3,
    twelve steps on one batch; the total and the distillation term fall."""
    teacher, student, adapters, clean, noisy = setup
    s_cfg, t_cfg = CleanUMambaConfig(**STUDENT), CleanUMambaConfig(**TEACHER)
    opt = make_optimizer(OptimizationConfig(n_iters=1000, learning_rate=LR),
                         schedule=lambda s: LR)
    step = td.make_kd_train_step(s_cfg, t_cfg, LossConfig(kd_p=1.0, stft_config=STFTLossConfig(
        **STFT)), opt)
    p, a = tparams.from_numpy(student, "cpu"), tparams.from_numpy(adapters, "cpu")
    teacher_t = tparams.from_numpy(teacher, "cpu")
    batch = (torch.from_numpy(clean), torch.from_numpy(noisy))
    state = opt.init((p, a))
    losses, kds = [], []
    for _ in range(12):
        p, a, state, aux = step(p, a, state, teacher_t, batch)
        losses.append(float(aux["loss"]))
        kds.append(float(aux["kd_loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] and kds[-1] < kds[0]


def test_bf16_kd_step_casts_only_the_student(setup, monkeypatch):
    """Under bf16 the student's params are bf16 and noisy stays fp32 (the
    forward computes in fp32 with bf16-rounded weights); the teacher runs in
    fp32 and takes no gradient; the master params stay fp32."""
    from cleanumamba_tpu_torch.train import distill

    teacher, student, adapters, clean, noisy = setup
    seen = []
    real = distill.forward

    def spy(p, x, cfg, return_skips=False):
        w = tparams.tensor_leaves(p)
        seen.append((w[0].dtype, x.dtype, torch.is_grad_enabled()))
        return real(p, x, cfg, return_skips=return_skips)

    monkeypatch.setattr(distill, "forward", spy)
    s_cfg, t_cfg = CleanUMambaConfig(**STUDENT), CleanUMambaConfig(**TEACHER)
    opt = make_optimizer(OptimizationConfig(n_iters=1000, learning_rate=LR),
                         schedule=lambda s: LR)
    step = td.make_kd_train_step(s_cfg, t_cfg, LossConfig(kd_p=1.0, stft_config=STFTLossConfig(
        **STFT)), opt, bf16=True)
    p, a = tparams.from_numpy(student, "cpu"), tparams.from_numpy(adapters, "cpu")
    p, a, _, aux = step(p, a, opt.init((p, a)), tparams.from_numpy(teacher, "cpu"),
                        (torch.from_numpy(clean), torch.from_numpy(noisy)))
    assert seen == [(torch.bfloat16, torch.float32, True), (torch.float32, torch.float32, False)]
    assert np.isfinite(float(aux["kd_loss"]))
    assert all(x.dtype == torch.float32 for x in tparams.tensor_leaves([p, a]))
