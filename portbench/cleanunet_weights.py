"""CleanUNet's weights, made by the benchmark on the device from the seed.

The tree, its leaf names, shapes and order are those of the parameter pytree
of a model with the ``mha`` bottleneck (the project's checkpoint format).
The U-Net's leaves and their initialisation are CleanUMamba's
(``portbench.weights``: torch's fan-in uniform for every convolution, then
``weight_scaling_init``).  The transformer's follow the program's rule:
every matrix and bias uniform in +-1/sqrt(fan_in), each LayerNorm's scale 1
and bias 0.  Every uniform number comes from ONE draw of the generator into
a flat fp32 buffer, sliced and scaled per leaf on its device.
"""

from __future__ import annotations

import math

import torch

from portbench import weights


def layout(geom: dict):
    """[(path, shape, kind, bound, group)] of every leaf in tree order, as
    :func:`portbench.weights.layout` gives them (kind "u", "ones", "zeros")."""
    if geom["bottleneck"] != "mha":
        raise ValueError("portbench.cleanunet_weights: the mha bottleneck alone")
    unet = weights.layout(dict(geom, bottleneck="mamba"))
    dm, dff = geom["tsfm_d_model"], geom["tsfm_d_inner"]
    bott = []
    for l in range(geom["tsfm_n_layers"]):
        p = ("bottleneck", "layers", l)
        bott += [(p + (n,), (dm, dm), "u", 1 / math.sqrt(dm), None)
                 for n in ("w_qs", "w_ks", "w_vs", "fc")]
        bott += [(p + ("attn_norm", "scale"), (dm,), "ones", 0.0, None),
                 (p + ("attn_norm", "bias"), (dm,), "zeros", 0.0, None),
                 (p + ("ffn_w1",), (dm, dff), "u", 1 / math.sqrt(dm), None),
                 (p + ("ffn_b1",), (dff,), "u", 1 / math.sqrt(dm), None),
                 (p + ("ffn_w2",), (dff, dm), "u", 1 / math.sqrt(dff), None),
                 (p + ("ffn_b2",), (dm,), "u", 1 / math.sqrt(dff), None),
                 (p + ("ffn_norm", "scale"), (dm,), "ones", 0.0, None),
                 (p + ("ffn_norm", "bias"), (dm,), "zeros", 0.0, None)]
    bott += [(("bottleneck", "enc_norm", "scale"), (dm,), "ones", 0.0, None),
             (("bottleneck", "enc_norm", "bias"), (dm,), "zeros", 0.0, None)]
    at = next(i for i, leaf in enumerate(unet) if leaf[0][0] == "bottleneck")
    rest = [leaf for leaf in unet[at:] if leaf[0][0] != "bottleneck"]
    return unet[:at] + bott + rest


def make_params(geom: dict, generator: torch.Generator) -> dict:
    """The fp32 parameter tree on ``generator``'s device, from its state."""
    dev = generator.device
    leaves = layout(geom)
    n_u = sum(math.prod(shape) for _, shape, kind, _, _ in leaves if kind == "u")
    flat = torch.rand(n_u, generator=generator, device=dev, dtype=torch.float32)
    values, at = {}, 0
    for path, shape, kind, bound, _ in leaves:
        n = math.prod(shape)
        if kind == "u":
            values[path] = (flat[at:at + n].reshape(shape) * 2 - 1) * bound
            at += n
        else:
            values[path] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=dev)
    groups = {}  # weight_scaling_init: a convolution's weight and bias over sqrt(10 * std(w))
    for path, _, _, _, group in leaves:
        if group is not None:
            groups.setdefault(group, []).append(path)
    for paths in groups.values():
        scale = torch.rsqrt(10.0 * values[paths[0]].std(correction=0))
        for p in paths:
            values[p] = values[p] * scale
    tree: dict = {}
    for path, _, _, _, _ in leaves:
        weights._insert(tree, path, values[path].contiguous())
    return tree


def param_count(geom: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _, _ in layout(geom))
