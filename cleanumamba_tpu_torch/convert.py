"""Reference-checkpoint converter (port of ``cleanumamba_tpu/convert.py``):
PyTorch reference ``.pkl`` <-> the param tree.

A reference checkpoint is a ``torch.save`` of ``{model_state_dict,
network_config, ...}``.  Widths are taken from tensor *shapes*, as the
reference's ``load_pruned_state_dict`` does, so ragged channel-pruned
checkpoints convert unchanged.  The leaves come out as fp32 torch tensors on
the device named (``params.resolve_device``).

Layout conversions (reference -> ours):
    Conv1d          (Cout, Cin, K)  -> (K, Cin, Cout)
    ConvTranspose1d (Cin, Cout, K)  -> (K, Cin, Cout)
    Linear          (Out, In)       -> (In, Out)
    depthwise conv  (C, 1, K)       -> (K, C)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from cleanumamba_tpu_torch.config import CleanUMambaConfig
from cleanumamba_tpu_torch.params import resolve_device, to_device


def _f32(t) -> torch.Tensor:
    """A reference tensor as a contiguous fp32 CPU tensor (moved to the
    device once the whole tree is built)."""
    return t.detach().to("cpu").float().contiguous()


def _conv_w(t):
    return _f32(t).permute(2, 1, 0).contiguous()  # (Cout,Cin,K) -> (K,Cin,Cout)


def _convt_w(t):
    return _f32(t).permute(2, 0, 1).contiguous()  # (Cin,Cout,K) -> (K,Cin,Cout)


def _lin_w(t):
    return _f32(t).T.contiguous()  # (Out,In) -> (In,Out)


def sniff_bottleneck(sd: Dict[str, Any]) -> str:
    keys = list(sd.keys())
    if any(k.startswith("tsfm_encoder.layer_stack") for k in keys):
        return "mha"
    if any(k.startswith("tsfm_Mamba_layers.weight_ih_l") for k in keys):
        return "lstm"
    if any(".mixer.ssm." in k for k in keys):
        return "mamba_s4"
    if any(k.endswith(".mixer.dt_bias") for k in keys):
        return "mamba2"
    return "mamba"


def load_reference_checkpoint(path: str, device=None
                              ) -> Tuple[CleanUMambaConfig, Dict[str, Any], Dict[str, Any]]:
    """Load + convert.  Returns (config, params on ``device``, metadata).
    Only load checkpoints from a trusted source: unpickling runs code."""
    return convert_payload(torch.load(path, map_location="cpu", weights_only=False), device)


def convert_payload(ck: Dict[str, Any], device=None
                    ) -> Tuple[CleanUMambaConfig, Dict[str, Any], Dict[str, Any]]:
    """A loaded reference checkpoint (``{model_state_dict, network_config,
    ...}``) -> (config, params on ``device``, metadata)."""
    device = resolve_device(device)
    sd = ck["model_state_dict"]
    net_cfg = dict(ck.get("network_config", {}))
    bottleneck = sniff_bottleneck(sd)
    network = "CleanUNet" if bottleneck == "mha" else "CleanUMamba"
    if bottleneck == "lstm":
        net_cfg["LSTM"] = True
    elif bottleneck == "mamba_s4":
        net_cfg["mamba_s4"] = True
    elif bottleneck == "mamba2":
        net_cfg["mamba_v2"] = True
    cfg = CleanUMambaConfig.from_reference_json(network, net_cfg)
    params = to_device(convert_state_dict(sd, cfg), device)
    meta = {k: v for k, v in ck.items() if k != "model_state_dict"}
    return cfg, params, meta


def convert_state_dict(sd: Dict[str, Any], cfg: CleanUMambaConfig) -> Dict[str, Any]:
    """Convert a reference state dict (torch tensors) to the param tree (fp32
    CPU tensors)."""
    n_enc = cfg.encoder_n_layers

    encoder = []
    for i in range(n_enc):
        encoder.append(
            {
                "conv_w": _conv_w(sd[f"encoder.{i}.0.weight"]),
                "conv_b": _f32(sd[f"encoder.{i}.0.bias"]),
                "mix_w": _conv_w(sd[f"encoder.{i}.2.weight"]),
                "mix_b": _f32(sd[f"encoder.{i}.2.bias"]),
            }
        )
    decoder = []
    for j in range(n_enc):
        decoder.append(
            {
                "mix_w": _conv_w(sd[f"decoder.{j}.0.weight"]),
                "mix_b": _f32(sd[f"decoder.{j}.0.bias"]),
                "convt_w": _convt_w(sd[f"decoder.{j}.2.weight"]),
                "convt_b": _f32(sd[f"decoder.{j}.2.bias"]),
            }
        )

    params: Dict[str, Any] = {
        "encoder": encoder,
        "decoder": decoder,
        "tsfm_conv1": {
            "w": _conv_w(sd["tsfm_conv1.weight"]),
            "b": _f32(sd["tsfm_conv1.bias"]),
        },
        "tsfm_conv2": {
            "w": _conv_w(sd["tsfm_conv2.weight"]),
            "b": _f32(sd["tsfm_conv2.bias"]),
        },
        "bottleneck": _convert_bottleneck(sd, cfg),
    }
    if any(k.startswith("residual_projection_layers") for k in sd):
        params["residual_projection"] = [
            {
                "w": _conv_w(sd[f"residual_projection_layers.{i}.weight"]),
                "b": _f32(sd[f"residual_projection_layers.{i}.bias"]),
            }
            for i in range(n_enc)
        ]
    return params


def export_reference_state_dict(params, cfg: CleanUMambaConfig):
    """Inverse conversion: our param pytree -> a reference-format torch
    state dict (fp32), so models trained/pruned in this framework can be
    loaded by the PyTorch reference via its ``load_pruned_state_dict``.
    All five bottlenecks supported: mamba, mamba2, mamba_s4, lstm, and mha
    (CleanUNet naming).  The tensors are fp32 on the CPU."""

    def t(x):
        return x.detach().to("cpu", torch.float32).clone()

    sd = {}
    for i, ep in enumerate(params["encoder"]):
        sd[f"encoder.{i}.0.weight"] = t(ep["conv_w"]).permute(2, 1, 0).contiguous()
        sd[f"encoder.{i}.0.bias"] = t(ep["conv_b"])
        sd[f"encoder.{i}.2.weight"] = t(ep["mix_w"]).permute(2, 1, 0).contiguous()
        sd[f"encoder.{i}.2.bias"] = t(ep["mix_b"])
    for j, dp in enumerate(params["decoder"]):
        sd[f"decoder.{j}.0.weight"] = t(dp["mix_w"]).permute(2, 1, 0).contiguous()
        sd[f"decoder.{j}.0.bias"] = t(dp["mix_b"])
        sd[f"decoder.{j}.2.weight"] = t(dp["convt_w"]).permute(1, 2, 0).contiguous()
        sd[f"decoder.{j}.2.bias"] = t(dp["convt_b"])
    sd["tsfm_conv1.weight"] = t(params["tsfm_conv1"]["w"]).permute(2, 1, 0).contiguous()
    sd["tsfm_conv1.bias"] = t(params["tsfm_conv1"]["b"])
    sd["tsfm_conv2.weight"] = t(params["tsfm_conv2"]["w"]).permute(2, 1, 0).contiguous()
    sd["tsfm_conv2.bias"] = t(params["tsfm_conv2"]["b"])
    bott = params["bottleneck"]
    if cfg.bottleneck == "lstm":
        for l, lp in enumerate(bott["layers"]):
            sd[f"tsfm_Mamba_layers.weight_ih_l{l}"] = t(lp["w_ih"]).T.contiguous()
            sd[f"tsfm_Mamba_layers.weight_hh_l{l}"] = t(lp["w_hh"]).T.contiguous()
            sd[f"tsfm_Mamba_layers.bias_ih_l{l}"] = t(lp["b_ih"])
            sd[f"tsfm_Mamba_layers.bias_hh_l{l}"] = t(lp["b_hh"])
        return sd
    if cfg.bottleneck == "mha":
        # CleanUNet transformer naming (reference CleanUNet load path)
        for l, layer in enumerate(bott["layers"]):
            p = f"tsfm_encoder.layer_stack.{l}"
            sd[f"{p}.slf_attn.w_qs.weight"] = t(layer["w_qs"]).T.contiguous()
            sd[f"{p}.slf_attn.w_ks.weight"] = t(layer["w_ks"]).T.contiguous()
            sd[f"{p}.slf_attn.w_vs.weight"] = t(layer["w_vs"]).T.contiguous()
            sd[f"{p}.slf_attn.fc.weight"] = t(layer["fc"]).T.contiguous()
            _export_norm(sd, f"{p}.slf_attn.layer_norm", layer["attn_norm"], t)
            sd[f"{p}.pos_ffn.w_1.weight"] = t(layer["ffn_w1"]).T.contiguous()
            sd[f"{p}.pos_ffn.w_1.bias"] = t(layer["ffn_b1"])
            sd[f"{p}.pos_ffn.w_2.weight"] = t(layer["ffn_w2"]).T.contiguous()
            sd[f"{p}.pos_ffn.w_2.bias"] = t(layer["ffn_b2"])
            _export_norm(sd, f"{p}.pos_ffn.layer_norm", layer["ffn_norm"], t)
        _export_norm(sd, "tsfm_encoder.layer_norm", bott["enc_norm"], t)
        return sd
    for l, layer in enumerate(bott["layers"]):
        p = f"tsfm_Mamba_layers.{l}"
        _export_norm(sd, f"{p}.norm", layer["norm"], t)
        m = layer["mixer"]
        sd[f"{p}.mixer.in_proj.weight"] = t(m["in_proj"]).T.contiguous()
        sd[f"{p}.mixer.conv1d.weight"] = t(m["conv_w"]).T[:, None, :].contiguous()
        sd[f"{p}.mixer.conv1d.bias"] = t(m["conv_b"])
        if cfg.bottleneck == "mamba":
            sd[f"{p}.mixer.x_proj.weight"] = t(m["x_proj"]).T.contiguous()
            sd[f"{p}.mixer.dt_proj.weight"] = t(m["dt_proj_w"]).T.contiguous()
            sd[f"{p}.mixer.dt_proj.bias"] = t(m["dt_proj_b"])
            sd[f"{p}.mixer.A_log"] = t(m["A_log"])
            sd[f"{p}.mixer.D"] = t(m["D"])
        elif cfg.bottleneck == "mamba2":
            sd[f"{p}.mixer.dt_bias"] = t(m["dt_bias"])
            sd[f"{p}.mixer.A_log"] = t(m["A_log"])
            sd[f"{p}.mixer.D"] = t(m["D"])
            sd[f"{p}.mixer.norm.weight"] = t(m["norm_w"])
        elif cfg.bottleneck == "mamba_s4":
            sd[f"{p}.mixer.ssm.input_linear.weight"] = t(m["input_linear_w"]).T.contiguous()
            sd[f"{p}.mixer.ssm.input_linear.bias"] = t(m["input_linear_b"])
            k = m["kernel"]
            for name in ("A_real", "A_imag", "B", "C", "P", "inv_dt"):
                sd[f"{p}.mixer.ssm.layer.kernel.{name}"] = t(k[name])
            sd[f"{p}.mixer.ssm.layer.kernel.l_kernel"] = torch.tensor(int(k["l_kernel"]))
            sd[f"{p}.mixer.ssm.layer.D"] = t(m["ssm_D"])
            sd[f"{p}.mixer.ssm.output_linear.0.weight"] = t(m["output_linear_w"]).T.contiguous()
            sd[f"{p}.mixer.ssm.output_linear.0.bias"] = t(m["output_linear_b"])
        else:
            raise ValueError(cfg.bottleneck)
        sd[f"{p}.mixer.out_proj.weight"] = t(m["out_proj"]).T.contiguous()
    _export_norm(sd, "norm_f", bott["norm_f"], t)
    return sd


def _export_norm(sd, prefix, norm, t):
    sd[f"{prefix}.weight"] = t(norm["scale"])
    if "bias" in norm:
        sd[f"{prefix}.bias"] = t(norm["bias"])


def save_reference_checkpoint(path: str, params, cfg: CleanUMambaConfig,
                              n_iter: int = 0, run_id=None):
    """Write a reference-format ``.pkl`` (torch.save of
    {model_state_dict, network_config, iter, run_id})."""
    torch.save(
        {
            "model_state_dict": export_reference_state_dict(params, cfg),
            "network_config": cfg.to_reference_json(),
            "iter": n_iter,
            "run_id": run_id,
        },
        path,
    )


def _norm(sd, prefix):
    out = {"scale": _f32(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _f32(sd[f"{prefix}.bias"])
    return out


def _convert_bottleneck(sd, cfg: CleanUMambaConfig):
    bt = cfg.bottleneck
    if bt == "lstm":
        layers = []
        l = 0
        while f"tsfm_Mamba_layers.weight_ih_l{l}" in sd:
            layers.append(
                {
                    "w_ih": _lin_w(sd[f"tsfm_Mamba_layers.weight_ih_l{l}"]),
                    "w_hh": _lin_w(sd[f"tsfm_Mamba_layers.weight_hh_l{l}"]),
                    "b_ih": _f32(sd[f"tsfm_Mamba_layers.bias_ih_l{l}"]),
                    "b_hh": _f32(sd[f"tsfm_Mamba_layers.bias_hh_l{l}"]),
                }
            )
            l += 1
        return {"layers": layers}

    if bt == "mha":
        layers = []
        l = 0
        while f"tsfm_encoder.layer_stack.{l}.slf_attn.w_qs.weight" in sd:
            p = f"tsfm_encoder.layer_stack.{l}"
            layers.append(
                {
                    "w_qs": _lin_w(sd[f"{p}.slf_attn.w_qs.weight"]),
                    "w_ks": _lin_w(sd[f"{p}.slf_attn.w_ks.weight"]),
                    "w_vs": _lin_w(sd[f"{p}.slf_attn.w_vs.weight"]),
                    "fc": _lin_w(sd[f"{p}.slf_attn.fc.weight"]),
                    "attn_norm": _norm(sd, f"{p}.slf_attn.layer_norm"),
                    "ffn_w1": _lin_w(sd[f"{p}.pos_ffn.w_1.weight"]),
                    "ffn_b1": _f32(sd[f"{p}.pos_ffn.w_1.bias"]),
                    "ffn_w2": _lin_w(sd[f"{p}.pos_ffn.w_2.weight"]),
                    "ffn_b2": _f32(sd[f"{p}.pos_ffn.w_2.bias"]),
                    "ffn_norm": _norm(sd, f"{p}.pos_ffn.layer_norm"),
                }
            )
            l += 1
        # tsfm_encoder.layer_norm is the encoder INPUT norm in CleanUNet
        # (applied before the layer stack) — see bottleneck_mha docstring.
        return {"layers": layers, "enc_norm": _norm(sd, "tsfm_encoder.layer_norm")}

    layers = []
    l = 0
    while f"tsfm_Mamba_layers.{l}.norm.weight" in sd:
        p = f"tsfm_Mamba_layers.{l}.mixer"
        if bt == "mamba":
            mixer = {
                "in_proj": _lin_w(sd[f"{p}.in_proj.weight"]),
                # (C, 1, K) -> (K, C)
                "conv_w": _f32(sd[f"{p}.conv1d.weight"])[:, 0, :].T.contiguous(),
                "conv_b": _f32(sd[f"{p}.conv1d.bias"]),
                "x_proj": _lin_w(sd[f"{p}.x_proj.weight"]),
                "dt_proj_w": _lin_w(sd[f"{p}.dt_proj.weight"]),
                "dt_proj_b": _f32(sd[f"{p}.dt_proj.bias"]),
                "A_log": _f32(sd[f"{p}.A_log"]),
                "D": _f32(sd[f"{p}.D"]),
                "out_proj": _lin_w(sd[f"{p}.out_proj.weight"]),
            }
        elif bt == "mamba2":
            mixer = {
                "in_proj": _lin_w(sd[f"{p}.in_proj.weight"]),
                "conv_w": _f32(sd[f"{p}.conv1d.weight"])[:, 0, :].T.contiguous(),
                "conv_b": _f32(sd[f"{p}.conv1d.bias"]),
                "dt_bias": _f32(sd[f"{p}.dt_bias"]),
                "A_log": _f32(sd[f"{p}.A_log"]),
                "D": _f32(sd[f"{p}.D"]),
                "norm_w": _f32(sd[f"{p}.norm.weight"]),
                "out_proj": _lin_w(sd[f"{p}.out_proj.weight"]),
            }
        elif bt == "mamba_s4":
            mixer = {
                "in_proj": _lin_w(sd[f"{p}.in_proj.weight"]),
                "conv_w": _f32(sd[f"{p}.conv1d.weight"])[:, 0, :].T.contiguous(),
                "conv_b": _f32(sd[f"{p}.conv1d.bias"]),
                "input_linear_w": _lin_w(sd[f"{p}.ssm.input_linear.weight"]),
                "input_linear_b": _f32(sd[f"{p}.ssm.input_linear.bias"]),
                "kernel": {
                    # complex tensors stored as (..., 2) real/imag pairs
                    "A_real": _f32(sd[f"{p}.ssm.layer.kernel.A_real"]),
                    "A_imag": _f32(sd[f"{p}.ssm.layer.kernel.A_imag"]),
                    "B": _f32(sd[f"{p}.ssm.layer.kernel.B"]),
                    "C": _f32(sd[f"{p}.ssm.layer.kernel.C"]),
                    "P": _f32(sd[f"{p}.ssm.layer.kernel.P"]),
                    "inv_dt": _f32(sd[f"{p}.ssm.layer.kernel.inv_dt"]),
                    # a static length: a plain int (what params.from_numpy makes of one)
                    "l_kernel": int(sd[f"{p}.ssm.layer.kernel.l_kernel"]),
                },
                "ssm_D": _f32(sd[f"{p}.ssm.layer.D"]),
                "output_linear_w": _lin_w(sd[f"{p}.ssm.output_linear.0.weight"]),
                "output_linear_b": _f32(sd[f"{p}.ssm.output_linear.0.bias"]),
                "out_proj": _lin_w(sd[f"{p}.out_proj.weight"]),
            }
        else:
            raise ValueError(bt)
        layers.append({"norm": _norm(sd, f"tsfm_Mamba_layers.{l}.norm"), "mixer": mixer})
        l += 1
    return {"layers": layers, "norm_f": _norm(sd, "norm_f")}
