"""CleanUMamba: causal time-domain U-Net around a sequence-model bottleneck
(port of ``cleanumamba_tpu/models/cleanumamba.py``).  The offline forward
runs all five bottleneck families: ``"mamba"``, ``"mamba2"`` and
``"mamba_s4"`` (pre-norm residual stacks), ``"lstm"`` and ``"mha"``.  A
``"mamba_s4"`` model's DPLR kernels must cover the bottleneck length:
:func:`prepare_for_length` extends them.

Activations are channels-last ``(B, L, C)``; the strided K=4/S=2 encoder
conv and the decoder's transposed conv are matmuls; the residual stream
through the bottleneck is fp32.  Params are the JAX package's pytree with
torch tensors at the leaves; pruned checkpoints are just other leaf shapes.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.models import (
    bottleneck_lstm,
    bottleneck_mamba,
    bottleneck_mamba2,
    bottleneck_mha,
    bottleneck_s4,
)
from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform
from cleanumamba_tpu_torch.ops.conv import (
    conv1d,
    conv1d_strided_matmul,
    conv_transpose1d,
    glu_activation,
)
from cleanumamba_tpu_torch.ops.norms import layer_norm, rms_norm
from cleanumamba_tpu_torch.params import resolve_device, tree_leaves, tree_map

Params = Dict[str, Any]

# the residual pre-norm families and their mixer modules
STEP_MIXERS = {"mamba": bottleneck_mamba, "mamba2": bottleneck_mamba2,
               "mamba_s4": bottleneck_s4}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def encoder_level(p, x, cfg: CleanUMambaConfig, i: int, tap=None):
    """One encoder level: strided conv -> ReLU -> 1x1 -> GLU.  ``tap(name,
    tensor)`` collects activation telemetry at the pruning groups' hook
    points (``enc_conv_{i}``, ``enc_out_{i}``)."""
    groups = cfg.group_of_layer(i)
    K, S = cfg.kernel_size, cfg.stride
    if groups == 1 and K == 2 * S:
        x = conv1d_strided_matmul(x, p["conv_w"], p["conv_b"], stride=S)
    else:
        x = conv1d(x, p["conv_w"], p["conv_b"], stride=S, groups=groups)
    if tap is not None:
        tap(f"enc_conv_{i}", x)
    x = torch.relu(x)
    x = x @ p["mix_w"][0].to(x.dtype) + p["mix_b"].to(x.dtype)
    if tap is not None:
        tap(f"enc_out_{i}", x)
    return glu_activation(x, cfg.glu_activation, cfg.bypass_of_layer(i))


def decoder_level(p, x, cfg: CleanUMambaConfig, enc_i: int, relu: bool, tap=None):
    """One decoder level: 1x1 -> GLU -> ConvTranspose (-> ReLU).  ``tap``
    receives the 1x1's output (``dec_mix_{j}``, j the decoder's own index)."""
    x = x @ p["mix_w"][0].to(x.dtype) + p["mix_b"].to(x.dtype)
    if tap is not None:
        tap(f"dec_mix_{cfg.encoder_n_layers - 1 - enc_i}", x)
    x = glu_activation(x, cfg.glu_activation, cfg.bypass_of_layer(enc_i))
    x = conv_transpose1d(x, p["convt_w"], p["convt_b"], stride=cfg.stride)
    return torch.relu(x) if relu else x


def pointwise(p, x):
    """1x1 conv ``{"w": (1, Cin, Cout), "b": (Cout,)}`` as a matmul in x's dtype."""
    return x @ p["w"][0].to(x.dtype) + p["b"].to(x.dtype)


def norm(p, x, cfg: CleanUMambaConfig):
    """The bottleneck's pre-norm / final norm, fp32 statistics."""
    if cfg.rms_norm:
        return rms_norm(x, p["scale"], cfg.norm_epsilon)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_epsilon)


def residual_stack(bp, x, cfg: CleanUMambaConfig, mixer):
    """Pre-norm residual blocks with an fp32 residual stream and a final
    add & norm.  ``mixer(l, layer_params, hidden)`` runs layer l's mixer on
    ``hidden`` (cast back to x's dtype) and returns its output."""
    hidden, residual = x, None
    for l, lp in enumerate(bp["layers"]):
        residual = hidden.float() if residual is None else hidden.float() + residual
        hidden = mixer(l, lp["mixer"], norm(lp["norm"], residual, cfg).to(x.dtype))
    residual = hidden.float() + residual
    return norm(bp["norm_f"], residual, cfg).to(x.dtype)


def bottleneck_forward(params: Params, x, cfg: CleanUMambaConfig, tap=None):
    """Bottleneck over (B, T, d_model) features; returns the same shape.
    For the mamba family ``tap`` receives each layer's normed input times
    ``in_proj`` (``d_inner_xz_{l}``, the d_inner group's telemetry); it
    costs one more product a layer, and nothing when ``tap`` is None."""
    if cfg.bottleneck == "lstm":
        return bottleneck_lstm.forward(params["layers"], x)
    if cfg.bottleneck == "mha":
        return bottleneck_mha.forward(params, x, cfg)
    mixer = STEP_MIXERS[cfg.bottleneck]

    def run(l, mp, h):
        if tap is not None and cfg.bottleneck == "mamba":
            tap(f"d_inner_xz_{l}", h @ mp["in_proj"].to(h.dtype))
        return mixer.mixer_forward(mp, h)

    return residual_stack(params, x, cfg, run)


def prepare_for_length(params: Params, cfg: CleanUMambaConfig, L: int) -> Params:
    """Make params valid for inputs of length L: for the mamba_s4 bottleneck,
    extend each layer's attuned kernel length (host-side) to the bottleneck
    length ``valid_length(L) // total_stride``; the other families need
    nothing.  Like the JAX package, it replaces the kernel dicts inside the
    given tree and returns that tree."""
    if cfg.bottleneck != "mamba_s4":
        return params
    bott_len = cfg.valid_length(L) // cfg.total_stride
    for layer in params["bottleneck"]["layers"]:
        layer["mixer"]["kernel"] = bottleneck_s4.extend_kernel_length(
            layer["mixer"]["kernel"], bott_len)
    return params


def forward(params: Params, noisy, cfg: CleanUMambaConfig, return_skips: bool = False,
            tap=None):
    """Offline denoising forward.

    noisy: (B, L), (B, 1, L) or (B, L, 1) raw waveform -> denoised (B, L)
    (plus the skip activations and bottleneck output if requested).
    ``tap(name, tensor)``, if given, sees the activations at the pruning
    groups' telemetry points (:func:`forward_with_telemetry`).
    """
    if noisy.ndim == 3:
        noisy = noisy.reshape(noisy.shape[0], -1)
    B, L = noisy.shape
    x = noisy[..., None]
    if cfg.normalize_input:
        std = x.std(dim=1, keepdim=True, correction=0) + 1e-3  # jnp.std: population
        x = x / std
    x = F.pad(x, (0, 0, 0, cfg.valid_length(L) - L))

    skips = []
    for i, ep in enumerate(params["encoder"]):
        x = encoder_level(ep, x, cfg, i, tap)
        skips.append(x)
    if cfg.residual_projection:
        skips = [pointwise(rp, s) for s, rp in zip(skips, params["residual_projection"])]
    skips = skips[::-1]

    x = pointwise(params["tsfm_conv1"], x)
    if tap is not None:
        tap("d_model_in", x)
    tsfm_out = bottleneck_forward(params["bottleneck"], x, cfg, tap)
    x = pointwise(params["tsfm_conv2"], tsfm_out)

    n_dec = len(params["decoder"])
    for j, dp in enumerate(params["decoder"]):
        x = x + skips[j][:, : x.shape[1], :]
        x = decoder_level(dp, x, cfg, n_dec - 1 - j, relu=(j != n_dec - 1), tap=tap)

    y = x[:, :L, 0]
    if cfg.normalize_input:
        y = y * std[:, 0, :]
    if return_skips:
        return y, skips + [tsfm_out]
    return y


def forward_with_telemetry(params: Params, noisy, cfg: CleanUMambaConfig):
    """:func:`forward` that also returns the per-channel activation variance
    at the pruning groups' telemetry points: ``(denoised, {tap: var (C,)})``,
    each the population variance in fp32 over every batch row and time step
    (``jnp.var``), a tensor on the params' device.  Unlike the JAX
    package's, whose copy of the forward leaves the residual projections
    out, the denoised output is :func:`forward`'s for every config (the two
    agree where ``residual_projection`` is off, as in every config shipped)."""
    taps: Dict[str, Any] = {}

    def tap(name, x):
        xf = x.float()
        taps[name] = xf.reshape(-1, xf.shape[-1]).var(dim=0, correction=0)

    return forward(params, noisy, cfg, tap=tap), taps


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _torch_conv_init(gen, k_size, cin, cout, groups=1):
    """torch Conv1d default init, then weight_scaling_init: w, b /= sqrt(10*std(w))."""
    bound = math.sqrt(groups / (cin * k_size))
    w = uniform(gen, (k_size, cin // groups, cout), bound)
    b = uniform(gen, (cout,), bound)
    scale = 1.0 / torch.sqrt(10.0 * w.std(correction=0))
    return w * scale, b * scale


def init_params(cfg: CleanUMambaConfig, gen: torch.Generator, device=None,
                dtype=torch.float32) -> Params:
    """The full parameter pytree, drawn from the CPU generator ``gen`` and
    moved to ``device`` (None: ``params.default_device()``).

    Same tree, leaf names, shapes and init distributions as the JAX
    package's ``init_params`` (torch defaults + weight_scaling_init on every
    conv + mamba-ssm's out_proj rescale); the numbers differ, since the
    generators do.
    """
    device = resolve_device(device)
    D = cfg.encoder_n_layers
    encoder, decoder_rev, resproj = [], [], []
    cin, cout_dec, h = cfg.channels_input, cfg.channels_output, cfg.channels_H
    for i in range(D):
        g = cfg.group_of_layer(i)
        bp = cfg.bypass_of_layer(i)
        mix_out = bp + (h - bp) * 2
        cw, cb = _torch_conv_init(gen, cfg.kernel_size, cin, h, g)
        mw, mb = _torch_conv_init(gen, 1, h, mix_out)
        encoder.append({"conv_w": cw, "conv_b": cb, "mix_w": mw, "mix_b": mb})
        if cfg.residual_projection:
            rw, rb = _torch_conv_init(gen, 1, h, h)
            resproj.append({"w": rw, "b": rb})
        dmw, dmb = _torch_conv_init(gen, 1, h, mix_out)
        # ConvTranspose1d: fan-in Cout*K in torch's default init
        t_bound = math.sqrt(1.0 / (cout_dec * cfg.kernel_size))
        tw = uniform(gen, (cfg.kernel_size, h, cout_dec), t_bound)
        tb = uniform(gen, (cout_dec,), t_bound)
        t_scale = 1.0 / torch.sqrt(10.0 * tw.std(correction=0))
        decoder_rev.append({"mix_w": dmw, "mix_b": dmb,
                            "convt_w": tw * t_scale, "convt_b": tb * t_scale})
        cin = cout_dec = h
        h = min(2 * h, cfg.max_H)

    c1w, c1b = _torch_conv_init(gen, 1, cin, cfg.tsfm_d_model)
    c2w, c2b = _torch_conv_init(gen, 1, cfg.tsfm_d_model, cin)
    params = {
        "encoder": encoder,
        "decoder": decoder_rev[::-1],
        "tsfm_conv1": {"w": c1w, "b": c1b},
        "bottleneck": _init_bottleneck(cfg, gen),
        "tsfm_conv2": {"w": c2w, "b": c2b},
    }
    if cfg.residual_projection:
        params["residual_projection"] = resproj
    return tree_map(lambda t: t.to(device=device, dtype=dtype)
                    if isinstance(t, torch.Tensor) else t, params)


def _init_bottleneck(cfg: CleanUMambaConfig, gen: torch.Generator) -> Params:
    n = cfg.tsfm_n_layers
    if cfg.bottleneck == "lstm":
        return {"layers": bottleneck_lstm.init(gen, cfg.tsfm_d_model, n)}
    if cfg.bottleneck == "mha":
        return bottleneck_mha.init(gen, cfg)
    if cfg.bottleneck not in STEP_MIXERS:
        raise ValueError(cfg.bottleneck)
    layers = []
    for _ in range(n):
        if cfg.bottleneck == "mamba":
            mixer = bottleneck_mamba.mixer_init(gen, cfg.tsfm_d_model, cfg.d_inner,
                                                cfg.d_state, cfg.dt_rank, cfg.d_conv)
            # mamba-ssm _init_weights: out_proj kaiming-uniform / sqrt(n_layer)
            mixer["out_proj"] = uniform(gen, (cfg.d_inner, cfg.tsfm_d_model),
                                         1.0 / math.sqrt(cfg.d_inner)) / math.sqrt(n)
        else:
            mixer = STEP_MIXERS[cfg.bottleneck].mixer_init(gen, cfg)
        layers.append({"norm": _norm_params(cfg), "mixer": mixer})
    return {"layers": layers, "norm_f": _norm_params(cfg)}


def _norm_params(cfg: CleanUMambaConfig):
    p = {"scale": torch.ones((cfg.tsfm_d_model,), dtype=torch.float32)}
    if not cfg.rms_norm:
        p["bias"] = torch.zeros((cfg.tsfm_d_model,), dtype=torch.float32)
    return p


def count_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params) if isinstance(t, torch.Tensor))
