"""CleanUNet's FLOPs, from a configuration's geometry: the U-Net's levels as
``model_flops`` counts them (strided convolutions, 1x1 mixes, transposed
convolutions) and the 1x1 convolutions into and out of the bottleneck; the
transformer's products per token (q, k, v and fc: 4 d_model^2
multiply-adds; the FFN: 2 d_model d_ff); and its attention, 4 d_model per
attended position and layer (q . k and the weighted values).  A
multiply-add is 2 FLOPs; softmax, norms and residual adds are left out."""

from __future__ import annotations

from portbench.counts import model_flops


def unet_flops(geom: dict, positions) -> float:
    """The U-Net's FLOPs over ``positions`` new outputs at each encoder level
    (the bottleneck takes as many tokens as the deepest level)."""
    K, dm = geom["kernel_size"], geom["tsfm_d_model"]
    widths = model_flops.widths(geom)
    total = 0.0
    for (cin, h), n in zip(widths, positions):
        total += n * (2 * K * cin * h + 2 * h * 2 * h + 2 * h * 2 * h + 2 * h * K * cin)
    return total + positions[-1] * 4 * widths[-1][1] * dm


def token_flops(geom: dict) -> float:
    """The transformer's products for one token, every layer."""
    d, dff = geom["tsfm_d_model"], geom["tsfm_d_inner"]
    return geom["tsfm_n_layers"] * (2 * 4 * d * d + 2 * 2 * d * dff)


def attention_flops(geom: dict, positions: int) -> float:
    """Attention over ``positions`` attended slots in all, every layer."""
    return geom["tsfm_n_layers"] * 4 * geom["tsfm_d_model"] * positions


def frame_flops(geom: dict) -> float:
    """One streamed frame, its attention left out (``attention_flops``)."""
    positions = model_flops.frame_positions(geom)
    return unet_flops(geom, positions) + positions[-1] * token_flops(geom)
