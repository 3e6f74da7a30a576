"""Model / training configuration (the port's own copy of
``cleanumamba_tpu/config.py``; stdlib only).

Mirrors the reference's two-layer JSON config system
(the reference's configs/config.json + configs/exp/models/*.json, consumed at
src/training/train.py:393-410) as typed dataclasses.  Unknown keys raise
instead of silently passing through.

The architecture hyperparameters mirror ``CleanUMamba.__init__``
(reference src/network/CleanUMamba.py:33-54).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence, Union


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class CleanUMambaConfig:
    """Architecture config (reference CleanUMamba.py:33-54 keyword-for-keyword).

    ``bottleneck`` selects the sequence model in the middle of the U-Net.  The
    reference expresses this with three booleans (``LSTM``, ``mamba_s4``,
    ``mamba_v2``) plus a separate "CleanUNet" network name for MHA; we accept
    those spellings in :func:`from_reference_json` and normalise to a string.
    """

    channels_input: int = 1
    channels_output: int = 1
    channels_H: int = 64
    max_H: int = 768
    encoder_n_layers: int = 8
    kernel_size: int = 4
    stride: int = 2
    encoder_groups: Union[int, Sequence[int]] = 1
    bypass_channels: Union[int, Sequence[int]] = 0
    glu_activation: str = "Sigmoid"
    tsfm_n_layers: int = 3
    tsfm_n_head: int = 8
    tsfm_d_model: int = 512
    tsfm_d_inner: int = 2048
    rms_norm: bool = False
    residual_projection: bool = False
    norm_epsilon: float = 1e-5
    normalize_input: bool = True
    # Bottleneck family: "mamba" | "mamba2" | "mamba_s4" | "lstm" | "mha"
    bottleneck: str = "mamba"
    # Mamba SSM geometry (reference ssm_cfg, CleanUMamba.py:141-152)
    d_conv: int = 4

    def __post_init__(self):
        if self.glu_activation not in ("Sigmoid", "ReLU", "SiLU", "GELU"):
            raise ValueError(f"glu_activation={self.glu_activation!r} not supported")
        if self.bottleneck not in ("mamba", "mamba2", "mamba_s4", "lstm", "mha"):
            raise ValueError(f"bottleneck={self.bottleneck!r} not supported")

    # --- derived SSM geometry (reference CleanUMamba.py:141-152 + mamba defaults)
    @property
    def d_state(self) -> int:
        return self.tsfm_d_model // self.tsfm_n_head

    @property
    def expand(self) -> int:
        return self.tsfm_d_inner // self.tsfm_d_model

    @property
    def d_inner(self) -> int:
        return self.tsfm_d_inner

    @property
    def dt_rank(self) -> int:
        # mamba-ssm default: ceil(d_model / 16)
        return _ceil_div(self.tsfm_d_model, 16)

    @property
    def total_stride(self) -> int:
        # reference CleanUMamba.py:248-250
        return self.stride ** self.encoder_n_layers

    # --- per-layer encoder/decoder widths (reference CleanUMamba.py:104-136)
    def encoder_widths(self) -> List[int]:
        """Output channels of each encoder level (after GLU)."""
        widths = []
        h = self.channels_H
        for _ in range(self.encoder_n_layers):
            widths.append(h)
            h = min(h * 2, self.max_H)
        return widths

    def group_of_layer(self, i: int) -> int:
        g = self.encoder_groups
        g = g[i] if isinstance(g, (list, tuple)) else g
        return g if i > 0 else 1

    def bypass_of_layer(self, i: int) -> int:
        bp = self.bypass_channels
        return bp[i] if isinstance(bp, (list, tuple)) else bp

    def valid_length(self, length: int) -> int:
        """Nearest valid input length (reference CleanUMamba.py:225-246)."""
        D, K, S = self.encoder_n_layers, self.kernel_size, self.stride
        for _ in range(D):
            if length < K:
                length = 1
            else:
                length = 1 + int(math.ceil((length - K) / S))
        for _ in range(D):
            length = (length - 1) * S + K
        return int(length)

    @property
    def frame_length(self) -> int:
        """Streaming frame length = valid_length(1) (reference CleanUMamba.py:214)."""
        return self.valid_length(1)

    @classmethod
    def from_reference_json(cls, network: str, network_config: dict) -> "CleanUMambaConfig":
        """Build from a reference experiment JSON's (network, network_config).

        Handles the reference's spellings: ``LSTM``/``mamba_s4``/``mamba_v2``
        booleans, the "CleanUNet" network name for the MHA variant, and
        ignores keys that do not affect the computation (``encoder_norm``,
        ``fused_add_norm``, ``use_fast_path``, device/dtype).
        """
        cfg = dict(network_config)
        bottleneck = "mamba"
        if cfg.pop("LSTM", False):
            bottleneck = "lstm"
        if cfg.pop("mamba_s4", False):
            bottleneck = "mamba_s4"
        if cfg.pop("mamba_v2", False):
            bottleneck = "mamba2"
        if network == "CleanUNet":
            bottleneck = "mha"
            # CleanUNet's transformer LayerNorms are built with eps=1e-6
            # (jadore attention-is-all-you-need-pytorch convention), unlike
            # the mamba-ssm default 1e-5.
            cfg.setdefault("norm_epsilon", 1e-6)
        elif network != "CleanUMamba":
            raise ValueError(f"unknown network {network!r}")
        # Keys that only select CUDA/Triton fast paths or are unused.
        for k in ("encoder_norm", "fused_add_norm", "use_fast_path", "device", "dtype"):
            cfg.pop(k, None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"unknown network_config keys: {sorted(unknown)}")
        return cls(bottleneck=bottleneck, **cfg)

    def to_reference_json(self) -> dict:
        """Round-trip back to the reference network_config dict shape."""
        d = {
            "channels_input": self.channels_input,
            "channels_output": self.channels_output,
            "channels_H": self.channels_H,
            "max_H": self.max_H,
            "encoder_n_layers": self.encoder_n_layers,
            "kernel_size": self.kernel_size,
            "stride": self.stride,
            "tsfm_n_layers": self.tsfm_n_layers,
            "tsfm_n_head": self.tsfm_n_head,
            "tsfm_d_model": self.tsfm_d_model,
            "tsfm_d_inner": self.tsfm_d_inner,
        }
        if self.bottleneck == "lstm":
            d["LSTM"] = True
        elif self.bottleneck == "mamba_s4":
            d["mamba_s4"] = True
        elif self.bottleneck == "mamba2":
            d["mamba_v2"] = True
        return d


@dataclasses.dataclass(frozen=True)
class STFTLossConfig:
    """reference configs/config.json loss_config.stft_config"""

    sc_lambda: float = 0.5
    mag_lambda: float = 0.5
    band: str = "full"
    hop_sizes: Sequence[int] = (50, 120, 240)
    win_lengths: Sequence[int] = (240, 600, 1200)
    fft_sizes: Sequence[int] = (512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    cross_entropy: int = 0
    ell_p: int = 1
    ell_p_lambda: float = 1.0
    stft_lambda: float = 1.0
    stft_config: STFTLossConfig = dataclasses.field(default_factory=STFTLossConfig)
    kd_p: float = 0.0


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """reference configs/config.json train_config.optimization"""

    n_iters: int = 1_000_000
    batch_size_total: int = 2
    batch_size_per_device: int = 2
    n_devices: int = 1
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    betas: Sequence[float] = (0.9, 0.999)
    eps: float = 1e-8
    clip_grad_norm_max: float = 10.0
    weight_decay: float = 0.0
    # bf16 compute replaces the reference's AMP+GradScaler
    # (train.py:156-160); bf16 needs no loss scaling.
    bf16: bool = True
    # checkpoint the model forward inside the grad: the backward
    # recomputes activations instead of storing them — ~1.3x compute for an
    # O(depth) -> O(1) activation-memory cut, the lever for very long
    # crops / large batch (no reference equivalent; torch checkpointing
    # unused there)
    remat: bool = False

    @property
    def grad_accum_steps(self) -> int:
        # reference train.py:232-233
        per_step = self.batch_size_per_device * self.n_devices
        assert self.batch_size_total % per_step == 0
        return self.batch_size_total // per_step


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    exp_path: str = "exp"
    log_directory: str = "./exp"
    ckpt_iter: Union[str, int] = "max"
    iters_per_ckpt: int = 10_000
    iters_per_valid: int = 1_000
    # None = full test set per mid-training validate (reference
    # train.py:338-356 validates the whole set)
    valid_max_items: Optional[int] = None
    optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    # dataset
    data_root: str = ""
    crop_length_sec: float = 10.0
    sample_rate: int = 16000
    # "dns" | "VCTK-DEMAND" (reference trainset_config "dataset",
    # dataset.py:51-54)
    dataset: str = "dns"


def load_experiment_config(exp_json_path: str) -> "tuple[str, CleanUMambaConfig, dict]":
    """Load a reference-style experiment JSON.

    Returns (network_name, CleanUMambaConfig, raw dict).
    """
    with open(exp_json_path) as f:
        raw = json.load(f)
    network = raw.get("network", "CleanUMamba")
    cfg = CleanUMambaConfig.from_reference_json(network, raw["network_config"])
    return network, cfg, raw


def load_train_config(config_json_path: str) -> TrainConfig:
    """Load a reference-style global config.json into a TrainConfig."""
    with open(config_json_path) as f:
        raw = json.load(f)
    tc = raw.get("train_config", {})
    log = tc.get("log", {})
    opt = tc.get("optimization", {})
    loss = tc.get("loss_config", {})
    stft = loss.get("stft_config", {})
    ts = raw.get("trainset_config", {})
    return TrainConfig(
        log_directory=log.get("directory", "./exp"),
        ckpt_iter=log.get("ckpt_iter", "max"),
        iters_per_ckpt=log.get("iters_per_ckpt", 10_000),
        iters_per_valid=log.get("iters_per_valid", 1_000),
        valid_max_items=log.get("valid_max_items", None),
        optimization=OptimizationConfig(
            n_iters=opt.get("n_iters", 1_000_000),
            batch_size_total=opt.get("batch_size_total", 2),
            batch_size_per_device=opt.get("batch_size_per_gpu", 2),
            n_devices=opt.get("n_gpus", 1),
            optimizer=opt.get("optimizer", "adam"),
            learning_rate=opt.get("learning_rate", 1e-4),
            betas=tuple(opt.get("betas", (0.9, 0.999))),
            eps=opt.get("eps", 1e-8),
            clip_grad_norm_max=opt.get("clip_grad_norm_max", 10.0),
            weight_decay=opt.get("weight_decay", 0.0),
            bf16=bool(opt.get("autocast", True)),
            remat=bool(opt.get("remat", False)),
        ),
        loss=LossConfig(
            cross_entropy=loss.get("cross_entropy", 0),
            ell_p=loss.get("ell_p", 1),
            ell_p_lambda=loss.get("ell_p_lambda", 1.0),
            stft_lambda=loss.get("stft_lambda", 1.0),
            stft_config=STFTLossConfig(
                sc_lambda=stft.get("sc_lambda", 0.5),
                mag_lambda=stft.get("mag_lambda", 0.5),
                band=stft.get("band", "full"),
                hop_sizes=tuple(stft.get("hop_sizes", (50, 120, 240))),
                win_lengths=tuple(stft.get("win_lengths", (240, 600, 1200))),
                fft_sizes=tuple(stft.get("fft_sizes", (512, 1024, 2048))),
            ),
            kd_p=loss.get("kd_p", 0.0),
        ),
        data_root=ts.get("root", ""),
        crop_length_sec=ts.get("crop_length_sec", 10.0),
        sample_rate=ts.get("sample_rate", 16000),
        dataset=ts.get("dataset", "dns"),
    )
