"""The FLOP and byte counts against hand counts, and the weights' tree
against the program's parameter tree."""

from __future__ import annotations

import pytest
import torch

from portbench.counts import k1, k2, k5, model_flops, peaks
from portbench.harness import ROOT, load_json
from portbench.tests.tiny import TINY_GEOM
from portbench.weights import leaf_paths, make_params

# two levels, K 4, S 2, widths 1 -> 2 -> 4, d_model 4, d_inner 8, d_state 2
HAND = {"channels_input": 1, "channels_output": 1, "channels_H": 2, "max_H": 4,
        "encoder_n_layers": 2, "kernel_size": 4, "stride": 2, "tsfm_n_layers": 1,
        "tsfm_n_head": 2, "tsfm_d_model": 4, "tsfm_d_inner": 8, "bottleneck": "mamba"}


def test_model_flops_by_hand():
    # a frame: level 0 makes 2 new positions, level 1 one (the bottleneck token)
    assert model_flops.frame_positions(HAND) == [2, 1]
    enc0 = 2 * 4 * 1 * 2 + 2 * 2 * 4  # conv 1->2 over 4 taps, mix 2->4
    dec0 = 2 * 2 * 4 + 2 * 2 * 4 * 1  # mix 2->4, transposed conv 2->1 over 4 taps
    enc1 = 2 * 4 * 2 * 4 + 2 * 4 * 8
    dec1 = 2 * 4 * 8 + 2 * 4 * 4 * 2
    # bottleneck: conv1 4->4 and conv2 4->4; in_proj 4->16, depthwise conv 4 taps
    # over 8, x_proj 8->(1 + 2*2), dt_proj 1->8, scan 7 * 8 * 2, out_proj 8->4
    layer = 2 * 4 * 16 + 2 * 4 * 8 + 2 * 8 * 5 + 2 * 1 * 8 + 7 * 8 * 2 + 2 * 8 * 4
    want = 2 * (enc0 + dec0) + 1 * (enc1 + dec1) + 2 * 4 * 4 * 2 + layer
    assert model_flops.frame_flops(HAND) == want


def test_offline_positions_follow_the_padded_length():
    # 10 samples pad to valid_length 10: level 0 makes 4, level 1 makes 1
    assert model_flops.level_lengths(HAND, 10) == [4, 1]
    assert model_flops.level_lengths(HAND, 11) == [6, 2]  # 11 pads to 14
    e8 = load_json(ROOT / "portbench/configs/e8-mamba.json")["model"]
    assert model_flops.level_lengths(e8, 160000)[-1] == 624
    # E8: 10.45 GMAC an audio-second
    assert model_flops.offline_flops(e8, 160000) / 10 / 2 == pytest.approx(10.46e9, rel=2e-3)


def test_kernel_counts_by_hand():
    ops, nbytes = k1.cost(B=2, L=3, Di=4, N=5, esize=2)
    assert ops == 2 * 3 * 4 * (7 * 5 + 3)
    assert nbytes == (2 * 3 * 4 * (2 + 2 + 4) + 2 * 2 * 3 * 5 * 2 + 4 * 5 * 4 + 4 * 4
                      + 2 * 2 * 4 * 5 * 4)
    ops, nbytes = k2.cost(B=1, L=2, Di=3, N=4, esize=4)
    assert ops == 1 * 2 * 3 * 4 * 16
    assert nbytes == 2 * 2 * 3 * 12 + 4 * 2 * 4 * 4 + 2 * (3 * 4 * 4 + 3 * 4) + 2 * 3 * 4 * 4
    # K5 on the hand model: frame_length 10, hop 4; level outputs 4 and 1 of
    # which 2 and 1 are new; caches 2 * 2; decoder tails 2 * 1 + 2 * 2; conv
    # and SSM state 4 * 8 + 8 * 2; input tail 6, std and count 2
    assert k5.state_floats(HAND) == 6 + 2 + 4 + 6 + 48
    ops, nbytes = k5.cost(HAND, 1, 4)
    assert ops == model_flops.frame_flops(HAND)
    assert nbytes == model_flops.param_count(HAND) * 4 + (2 * 66 + 2 * 4) * 4


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 1.0, "bf16") == pytest.approx(1.0)


@pytest.mark.parametrize("geom", [TINY_GEOM, HAND])
def test_weights_tree_is_the_programs(geom):
    """The benchmark's weights have the program's tree: the same leaves, in
    the same order, of the same shapes, as the program's own init."""
    from cleanumamba_tpu_torch.config import CleanUMambaConfig
    from cleanumamba_tpu_torch.models.cleanumamba import init_params

    ours = make_params(geom, torch.Generator().manual_seed(3))
    theirs = init_params(CleanUMambaConfig(**geom), torch.Generator().manual_seed(3), "cpu")
    a, b = leaf_paths(ours), leaf_paths(theirs)
    assert [p for p, _ in a] == [p for p, _ in b]
    assert [tuple(t.shape) for _, t in a] == [tuple(t.shape) for _, t in b]
    assert model_flops.param_count(geom) == sum(t.numel() for _, t in b)
    # the same distributions: each leaf's spread within a factor of the init's
    for (path, x), (_, y) in zip(a, b):
        if y.numel() > 64 and y.std() > 0:
            assert 0.5 < float(x.std() / y.std()) < 2.0, path
