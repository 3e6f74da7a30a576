"""LSTM bottleneck (port of ``cleanumamba_tpu/models/bottleneck_lstm.py``).

A stack of LSTM layers (hidden = input = d_model) with no residuals and no
norms, torch gate order (i, f, g, o), weights stored ``(in, 4H)``.  The cell
state is fp32 whatever the activation dtype.
"""

from __future__ import annotations

import math

import torch

from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform


def init(gen: torch.Generator, d_model: int, n_layers: int):
    """torch LSTM default init: every leaf ~ U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / math.sqrt(d_model)
    return [{"w_ih": uniform(gen, (d_model, 4 * d_model), bound),
             "w_hh": uniform(gen, (d_model, 4 * d_model), bound),
             "b_ih": uniform(gen, (4 * d_model,), bound),
             "b_hh": uniform(gen, (4 * d_model,), bound)} for _ in range(n_layers)]


def _cell(p, x, h, c):
    """One LSTM cell on a token.  x, h (B, .) in the activation dtype; c fp32."""
    g = (x @ p["w_ih"].to(x.dtype) + h @ p["w_hh"].to(x.dtype)
         + (p["b_ih"] + p["b_hh"]).to(x.dtype))
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f).float() * c + (torch.sigmoid(i) * torch.tanh(gg)).float()
    h = (torch.sigmoid(o).float() * torch.tanh(c)).to(x.dtype)
    return h, c


def init_cache(layers, batch_size: int, dtype=torch.float32, device="cpu"):
    H = layers[0]["w_hh"].shape[0]
    return [{"h": torch.zeros((batch_size, H), dtype=dtype, device=device),
             "c": torch.zeros((batch_size, H), dtype=torch.float32, device=device)}
            for _ in layers]


def step(layers, cache, x):
    """Single-token streaming step.  x: (B, d_model) -> (cache', (B, d_model))."""
    new_cache = []
    for p, st in zip(layers, cache):
        h, c = _cell(p, x, st["h"], st["c"])
        new_cache.append({"h": h, "c": c})
        x = h
    return new_cache, x


def forward(layers, x):
    """Offline forward.  x: (B, T, d_model) -> (B, T, d_model), zero initial state."""
    cache = init_cache(layers, x.shape[0], x.dtype, x.device)
    ys = []
    for t in range(x.shape[1]):
        cache, y = step(layers, cache, x[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1) if ys else x
