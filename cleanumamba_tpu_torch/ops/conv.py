"""1-D convolution ops, channels-last (port of ``cleanumamba_tpu/ops/conv.py``).

Weight layouts are the JAX package's:

- ``conv1d``:           w ``(K, Cin//groups, Cout)``
- ``conv_transpose1d``: w ``(K, Cin, Cout)``
- ``causal_depthwise_conv``: w ``(K, C)``
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x, w, b=None, stride: int = 1, groups: int = 1):
    """Valid (no padding) 1-D convolution.  x: (B, L, Cin), w: (K, Cin//groups, Cout)."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0).to(x.dtype),
                 stride=stride, groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv1d_strided_matmul(x, w, b=None, stride: int = 2):
    """K == 2*stride strided conv as one ``(B*T, K*Cin) @ (K*Cin, Cout)``
    matmul: window t is the concatenation of S-sample groups t and t+1."""
    K, Cin, Cout = w.shape
    S = stride
    if K != 2 * S:
        raise ValueError(f"conv1d_strided_matmul needs K == 2*stride, got K={K}, S={S}")
    B, L, C = x.shape
    T = (L - K) // S + 1
    xg = x[:, : (T + 1) * S, :].reshape(B, T + 1, S * C)
    win = torch.cat([xg[:, :-1, :], xg[:, 1:, :]], dim=-1)  # (B, T, K*C)
    y = win @ w.reshape(K * Cin, Cout).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv_transpose1d(x, w, b=None, stride: int = 2):
    """Transposed conv matching torch ``ConvTranspose1d`` (no padding).

    x: (B, T, Cin), w: (K, Cin, Cout) -> (B, (T-1)*S + K, Cout): one matmul
    producing all K taps per step, then an overlap-add.
    """
    K, Cin, Cout = w.shape
    S = stride
    B, T, C = x.shape
    if C != Cin:
        raise ValueError(f"conv_transpose1d: input has {C} channels, weight expects {Cin}")
    z = torch.einsum("btc,kco->btko", x, w.to(x.dtype))  # (B, T, K, Cout)
    out_len = (T - 1) * S + K
    if K == 2 * S:
        # output group u (S samples) = z[u, :S] + z[u-1, S:]
        zeros = torch.zeros_like(z[:, :1, :S])
        lo = torch.cat([z[:, :, :S], zeros], dim=1)  # groups 0..T
        hi = torch.cat([zeros, z[:, :, S:]], dim=1)  # shifted by one group
        y = (lo + hi).reshape(B, (T + 1) * S, Cout)[:, :out_len]
    else:
        y = x.new_zeros((B, out_len, Cout))
        for k in range(K):
            y[:, k : k + (T - 1) * S + 1 : S, :] += z[:, :, k, :]
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_depthwise_conv(x, w, b=None):
    """Causal depthwise conv, x: (B, L, C), w: (K, C): torch
    ``Conv1d(C, C, K, groups=C, padding=K-1)`` truncated to L."""
    K, _ = w.shape
    L = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = torch.zeros_like(x)
    for k in range(K):
        y = y + xp[:, k : k + L, :] * w[k].to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "Sigmoid": torch.sigmoid,
    "ReLU": torch.relu,
    "SiLU": F.silu,
    "GELU": _gelu_tanh,
}


def glu_activation(x, activation: str = "Sigmoid", bypass_channels: int = 0):
    """GLU with optional un-gated bypass channels.

    x: (..., nX + 2*nAB) -> (..., nX + nAB), out = cat([X, A * act(B)]).
    """
    act = ACTIVATIONS[activation]
    nX = bypass_channels
    nAB = (x.shape[-1] - nX) // 2
    gated = x[..., nX : nX + nAB] * act(x[..., nX + nAB :])
    if nX == 0:
        return gated
    return torch.cat([x[..., :nX], gated], dim=-1)
