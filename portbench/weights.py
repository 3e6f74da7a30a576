"""The model's weights, made by the benchmark on the device from the seed.

The tree, its leaf names, shapes and order are those of the CleanUMamba
parameter pytree (the format of the project's checkpoints); the
distributions follow the reference's initialisation: torch's default
fan-in uniform for every convolution, then ``weight_scaling_init`` (w and b
divided by sqrt(10 * std(w))); mamba-ssm's Mamba init in the bottleneck (dt
log-uniform in [1e-3, 0.1] through an inverse softplus, ``A_log = log(1..
d_state)``, ``D = 1``, ``out_proj`` uniform over sqrt(d_inner) and
sqrt(n_layers)).  Every uniform number comes from ONE draw of a CUDA
``torch.Generator`` (or a CPU one in the tests) into a flat fp32 buffer,
sliced and scaled per leaf on the device.  The benchmark hands the same
tree to the program and to the plain reference.
"""

from __future__ import annotations

import math

import torch


def layout(geom: dict):
    """[(path, shape, kind, bound, group)] of every leaf in tree order.

    kind: "u" uniform(-bound, bound); "dt" the inverse-softplus dt bias;
    "alog", "ones", "zeros".  ``group`` names the leaves rescaled together
    by ``weight_scaling_init`` (weight first)."""
    if geom["bottleneck"] != "mamba":
        raise ValueError("portbench.weights: only the mamba bottleneck is laid out")
    if geom.get("residual_projection") or geom.get("rms_norm"):
        raise ValueError("portbench.weights: residual projections / RMS norms not laid out")
    K, D = geom["kernel_size"], geom["encoder_n_layers"]
    dm, di, n_layers = geom["tsfm_d_model"], geom["tsfm_d_inner"], geom["tsfm_n_layers"]
    N = dm // geom["tsfm_n_head"]
    r = -(-dm // 16)
    d_conv = geom.get("d_conv", 4)
    leaves, dec = [], []
    cin, cout_dec, h = geom["channels_input"], geom["channels_output"], geom["channels_H"]
    for i in range(D):
        g = ("enc", i, "conv")
        b = math.sqrt(1.0 / (cin * K))
        leaves += [(("encoder", i, "conv_w"), (K, cin, h), "u", b, g),
                   (("encoder", i, "conv_b"), (h,), "u", b, g)]
        g = ("enc", i, "mix")
        b = math.sqrt(1.0 / h)
        leaves += [(("encoder", i, "mix_w"), (1, h, 2 * h), "u", b, g),
                   (("encoder", i, "mix_b"), (2 * h,), "u", b, g)]
        j = D - 1 - i  # the decoder list runs from the deepest level up
        tb = math.sqrt(1.0 / (cout_dec * K))
        dec.append([(("decoder", j, "mix_w"), (1, h, 2 * h), "u", b, ("dec", j, "mix")),
                    (("decoder", j, "mix_b"), (2 * h,), "u", b, ("dec", j, "mix")),
                    (("decoder", j, "convt_w"), (K, h, cout_dec), "u", tb, ("dec", j, "convt")),
                    (("decoder", j, "convt_b"), (cout_dec,), "u", tb, ("dec", j, "convt"))])
        cin = cout_dec = h
        h = min(2 * h, geom["max_H"])
    for level in reversed(dec):
        leaves += level
    b1, b2 = math.sqrt(1.0 / cin), math.sqrt(1.0 / dm)
    leaves += [(("tsfm_conv1", "w"), (1, cin, dm), "u", b1, ("c1",)),
               (("tsfm_conv1", "b"), (dm,), "u", b1, ("c1",))]
    for l in range(n_layers):
        p = ("bottleneck", "layers", l)
        leaves += [(p + ("norm", "scale"), (dm,), "ones", 0.0, None),
                   (p + ("norm", "bias"), (dm,), "zeros", 0.0, None),
                   (p + ("mixer", "in_proj"), (dm, 2 * di), "u", 1 / math.sqrt(dm), None),
                   (p + ("mixer", "conv_w"), (d_conv, di), "u", 1 / math.sqrt(d_conv), None),
                   (p + ("mixer", "conv_b"), (di,), "u", 1 / math.sqrt(d_conv), None),
                   (p + ("mixer", "x_proj"), (di, r + 2 * N), "u", 1 / math.sqrt(di), None),
                   (p + ("mixer", "dt_proj_w"), (r, di), "u", r ** -0.5, None),
                   (p + ("mixer", "dt_proj_b"), (di,), "dt", 0.0, None),
                   (p + ("mixer", "A_log"), (di, N), "alog", 0.0, None),
                   (p + ("mixer", "D"), (di,), "ones", 0.0, None),
                   (p + ("mixer", "out_proj"), (di, dm), "u",
                    1 / math.sqrt(di) / math.sqrt(n_layers), None)]
    leaves += [(("bottleneck", "norm_f", "scale"), (dm,), "ones", 0.0, None),
               (("bottleneck", "norm_f", "bias"), (dm,), "zeros", 0.0, None),
               (("tsfm_conv2", "w"), (1, dm, cin), "u", b2, ("c2",)),
               (("tsfm_conv2", "b"), (cin,), "u", b2, ("c2",))]
    return leaves


def _insert(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def make_params(geom: dict, generator: torch.Generator) -> dict:
    """The fp32 parameter tree on ``generator``'s device, from its state."""
    dev = generator.device
    leaves = layout(geom)
    sizes = [math.prod(shape) for _, shape, kind, _, _ in leaves if kind in ("u", "dt")]
    flat = torch.rand(sum(sizes), generator=generator, device=dev, dtype=torch.float32)
    values, at = {}, 0
    for path, shape, kind, bound, _ in leaves:
        n = math.prod(shape)
        if kind == "u":
            values[path] = (flat[at:at + n].reshape(shape) * 2 - 1) * bound
            at += n
        elif kind == "dt":  # mamba-ssm: dt log-uniform in [1e-3, 0.1], floor 1e-4
            u = flat[at:at + n]
            at += n
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            dt = dt.clamp(min=1e-4)
            values[path] = dt + torch.log(-torch.expm1(-dt))
        elif kind == "alog":
            values[path] = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                                  device=dev)).repeat(shape[0], 1)
        elif kind == "ones":
            values[path] = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            values[path] = torch.zeros(shape, dtype=torch.float32, device=dev)
    # weight_scaling_init: a convolution's weight and bias over sqrt(10 * std(w))
    groups = {}
    for path, _, _, _, group in leaves:
        if group is not None:
            groups.setdefault(group, []).append(path)
    for paths in groups.values():
        scale = torch.rsqrt(10.0 * values[paths[0]].std(correction=0))
        for p in paths:
            values[p] = values[p] * scale
    tree: dict = {}
    for path, _, _, _, _ in leaves:
        _insert(tree, path, values[path].contiguous())
    return tree


def leaf_paths(tree, prefix=()):
    """[(path, tensor)] of a parameter tree in its order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaf_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]
