"""The plain reference against the program at tiny sizes on the CPU, in fp32:
the offline forward, streaming (prime then frame steps, and the
multiplexer's padded flush), and a training step's loss and gradient."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.tests.tiny import TINY_GEOM
from portbench.traffic.audio import speech_like
from portbench.weights import leaf_paths, make_params


@pytest.fixture(scope="module")
def setup():
    from cleanumamba_tpu_torch.config import CleanUMambaConfig

    params = make_params(TINY_GEOM, torch.Generator().manual_seed(5))
    _, noisy = speech_like(torch.Generator().manual_seed(6), 2, 4000)
    return CleanUMambaConfig(**TINY_GEOM), params, noisy


def test_offline_forward(setup):
    from cleanumamba_tpu_torch.models.cleanumamba import forward

    cfg, params, noisy = setup
    with torch.no_grad():
        got, want = forward(params, noisy, cfg), ref.forward(params, noisy, TINY_GEOM)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_streaming_every_frame(setup):
    """Streamer (prime, then one frame a hop) against the reference's prime
    and one block."""
    from cleanumamba_tpu_torch.streaming import Streamer

    cfg, params, noisy = setup
    x = noisy[:1, : 766 + 256 * 9].numpy()
    st = Streamer(params, cfg, device="cpu", fused=False)
    got = np.concatenate([st.feed(x[:, i:i + 256])[0] for i in range(0, x.shape[1], 256)])
    with torch.no_grad():
        want = ref.stream(params, TINY_GEOM, torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_multiplexed_session_with_its_flush(setup):
    """A multiplexer session fed hop by hop beside another, flushed: its
    whole output against the reference over the audio padded as the flush
    pads it."""
    from cleanumamba_tpu_torch.serve import SessionMultiplexer

    cfg, params, noisy = setup
    mux = SessionMultiplexer(params, cfg, slots=3, weights="bf16", device="cpu")
    a, b = mux.open(), mux.open()
    xa, xb = noisy[0, :256 * 11].numpy(), noisy[1, :256 * 7].numpy()
    outs = {a: [], b: []}
    for i in range(11):
        outs[a].append(mux.feed(a, xa[256 * i:256 * (i + 1)]))
        if i < 7:
            outs[b].append(mux.feed(b, xb[256 * i:256 * (i + 1)]))
    outs[b].append(mux.flush(b))
    outs[a].append(mux.flush(a))
    P = ref.stored(params, "bf16")
    for sid, x in ((a, xa), (b, xb)):
        got = np.concatenate(outs[sid])
        pad = np.concatenate([x, np.zeros(766 + 256, np.float32)])
        with torch.no_grad():
            want = ref.stream(P, TINY_GEOM, torch.from_numpy(pad)[None])[0, :x.shape[0]].numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_training_loss_and_gradient(setup):
    """The program's fp32 gradient (its grad function, the train step's) and
    the reference's, leaf by leaf, on the loss of the training cell."""
    from cleanumamba_tpu_torch.config import LossConfig
    from cleanumamba_tpu_torch.train.trainer import make_grad_fn

    cfg, params, noisy = setup
    clean = noisy * 0.5
    grads, aux = make_grad_fn(cfg, LossConfig(), bf16=False)(params, clean[None], noisy[None])
    lc = {"ell_p_lambda": 1.0, "stft_lambda": 1.0,
          "stft_config": {"sc_lambda": 0.5, "mag_lambda": 0.5, "hop_sizes": [50, 120, 240],
                          "win_lengths": [240, 600, 1200], "fft_sizes": [512, 1024, 2048]}}
    leaves = [t.clone().requires_grad_() for _, t in leaf_paths(params)]
    loss = ref.loss(ref.forward(ref_train._tree(params, leaves), noisy, TINY_GEOM,
                                grad_chunks=True), clean, lc)
    want = torch.autograd.grad(loss, leaves)
    assert float(aux["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    for (path, g), w in zip(leaf_paths(grads), want):
        assert (g - w).abs().max() <= 1e-4 * max(w.abs().max(), 1e-6), path


def test_reference_adam_matches_the_programs_optimizer(setup):
    """Three of the reference's steps against three of the program's fp32
    train step: the losses and each leaf's change."""
    from cleanumamba_tpu_torch.config import LossConfig, OptimizationConfig
    from cleanumamba_tpu_torch.params import tensor_leaves
    from cleanumamba_tpu_torch.train.optim import make_optimizer
    from cleanumamba_tpu_torch.train.trainer import make_train_step

    cfg, params, noisy = setup
    opt = {"optimizer": "adam", "learning_rate": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8,
           "clip_grad_norm_max": 10, "weight_decay": 0, "n_iters": 100}
    lc = {"ell_p_lambda": 1.0, "stft_lambda": 1.0,
          "stft_config": {"sc_lambda": 0.5, "mag_lambda": 0.5, "hop_sizes": [50, 120, 240],
                          "win_lengths": [240, 600, 1200], "fft_sizes": [512, 1024, 2048]}}
    optimizer = make_optimizer(OptimizationConfig(n_iters=100, learning_rate=1e-3))
    step = make_train_step(cfg, LossConfig(), optimizer, bf16=False)
    p, s = params, optimizer.init(params)
    batches = [(noisy[:, i:i + 2000] * 0.5, noisy[:, i:i + 2000]) for i in (0, 1000, 2000)]
    losses = []
    for c, x in batches:
        p, s, aux = step(p, s, (c[None], x[None]))
        losses.append(float(aux["loss"]))
    r_losses, _, r_d = ref_train.steps(params, batches, TINY_GEOM, lc, opt)
    assert losses == pytest.approx(r_losses, rel=1e-5)
    d = torch.stack([(a - b).norm() for a, b in zip(tensor_leaves(p),
                                                     tensor_leaves(params))])
    assert torch.allclose(d, r_d, rtol=1e-3, atol=1e-9)
