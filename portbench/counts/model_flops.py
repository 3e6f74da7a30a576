"""The model's own FLOPs, from a configuration's geometry: the strided
encoder convolutions, the 1x1 mixes, the transposed convolutions, the
bottleneck's projections and depthwise convolution, and its scan (per
state element and token: exp, dt * A, B * (dt * u), the state's
multiply-add and C's multiply-add: 7).  A multiply-add is 2 FLOPs.  The
nonlinearities, norms and residual adds are left out."""

from __future__ import annotations

import math


def widths(geom: dict):
    """(input channels, output channels) of each encoder level."""
    out, cin, h = [], geom["channels_input"], geom["channels_H"]
    for _ in range(geom["encoder_n_layers"]):
        out.append((cin, h))
        cin, h = h, min(2 * h, geom["max_H"])
    return out


def level_lengths(geom: dict, samples: int):
    """Output positions of each encoder level for an input of ``samples``
    (padded to the model's valid length, as the forward pads it)."""
    D, K, S = geom["encoder_n_layers"], geom["kernel_size"], geom["stride"]
    n = samples
    for _ in range(D):
        n = 1 if n < K else 1 + math.ceil((n - K) / S)
    lens = [n]
    for _ in range(D - 1):
        lens.append((lens[-1] - 1) * S + K)
    lens = lens[::-1]  # level 0 first: valid_length positions at each level
    return lens


def frame_positions(geom: dict):
    """New positions of each encoder level in one streamed frame."""
    D, S = geom["encoder_n_layers"], geom["stride"]
    return [S ** (D - 1 - i) for i in range(D)]


def flops(geom: dict, positions) -> float:
    """FLOPs of one forward over ``positions`` new outputs at each encoder
    level (the decoder level of the same index takes as many inputs; the
    bottleneck as many tokens as the deepest level)."""
    K = geom["kernel_size"]
    total = 0.0
    for (cin, h), n in zip(widths(geom), positions):
        enc = 2 * K * cin * h + 2 * h * 2 * h
        dec = 2 * h * 2 * h + 2 * h * K * cin
        total += n * (enc + dec)
    dm, di = geom["tsfm_d_model"], geom["tsfm_d_inner"]
    N, r = dm // geom["tsfm_n_head"], -(-dm // 16)
    w_last = widths(geom)[-1][1]
    per_layer = (2 * dm * 2 * di + 2 * geom.get("d_conv", 4) * di + 2 * di * (r + 2 * N)
                 + 2 * r * di + 7 * di * N + 2 * di * dm)
    total += positions[-1] * (4 * w_last * dm + geom["tsfm_n_layers"] * per_layer)
    return total


def offline_flops(geom: dict, samples: int, batch: int = 1) -> float:
    return batch * flops(geom, level_lengths(geom, samples))


def frame_flops(geom: dict) -> float:
    return flops(geom, frame_positions(geom))


def param_count(geom: dict) -> int:
    from portbench.weights import layout

    return sum(math.prod(shape) for _, shape, _, _, _ in layout(geom))
