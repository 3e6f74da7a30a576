"""The plain reference of CleanUNet (Kong et al., "Speech Denoising in the
Waveform Domain with Self-Attention", ICASSP 2022, arXiv:2202.07931): the
offline forward and streaming as prime + one block.

Plain PyTorch in fp32 from the paper's equations; it imports nothing of the
program.  The U-Net (strided conv, ReLU, 1x1, GLU down; 1x1, GLU,
transposed conv, ReLU up; the skips; the input normalised by its std) is
the one CleanUMamba keeps, taken from :mod:`portbench.reference.model`.  The
bottleneck is CleanUNet's transformer: a 1x1 conv to d_model, a LayerNorm of
the input, then per layer

    a = concat_h softmax(q_h k_h^T / sqrt(d_k) + causal mask) v_h    (q, k, v = x W_q, x W_k, x W_v)
    x = LN(a W_fc + x)
    x = LN(W_2 relu(W_1 x + b_1) + b_2 + x)

post-norm, no positional encoding, no bias on the four attention matrices,
LayerNorm eps 1e-6; then a 1x1 conv back.  Every product goes through
:meth:`Prec.mm` (the attention's two products too), so a lower precision
stands in for the program as the control.  TF32 is turned off on both
backends at each call.

Departure from the published model: :func:`stream` attends each token to
the last ``window`` tokens of its utterance (itself included), as a live
stream that holds a ring of ``window`` keys and values must; the published
model, and :func:`forward`, attend to every earlier token.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.model import (
    CASTS,
    Prec,
    _decode,
    _std,
    _tree_map,
    dec_level,
    enc_level,
    layer_norm,
    pointwise,
    stored,
    valid_length,
)

__all__ = ["Prec", "stored", "attention", "transformer", "forward", "stream"]


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def attention(q, k, v, n_head: int, window, m: Prec, chunk: int = 256):
    """Causal multi-head attention over (B, T, d): query t attends to keys
    max(0, t - window + 1) .. t (``window`` None: 0 .. t), computed a chunk
    of queries at a time over the keys the chunk can reach."""
    B, T, d = q.shape
    dk = d // n_head
    qh, kh, vh = (t.reshape(B, T, n_head, dk).transpose(1, 2) for t in (q, k, v))
    outs = []
    for c0 in range(0, T, chunk):
        c1 = min(T, c0 + chunk)
        k0 = 0 if window is None else max(0, c0 - window + 1)
        s = m.mm(qh[:, :, c0:c1], kh[:, :, k0:c1].transpose(-1, -2)) / math.sqrt(dk)
        i = torch.arange(c0, c1, device=q.device)[:, None]
        j = torch.arange(k0, c1, device=q.device)[None, :]
        ok = (j <= i) if window is None else (j <= i) & (j > i - window)
        s = s.masked_fill(~ok, float("-inf"))
        outs.append(m.mm(torch.softmax(s, dim=-1), vh[:, :, k0:c1]))
    return torch.cat(outs, 2).transpose(1, 2).reshape(B, T, d)


def transformer(P, x, geom, m: Prec, window=None):
    """CleanUNet's bottleneck over (B, T, d_model) tokens."""
    eps = geom.get("norm_epsilon", 1e-6)
    bp = P["bottleneck"]
    x = layer_norm(bp["enc_norm"], x, eps)
    for lp in bp["layers"]:
        q, k, v = (m.mm(x, lp[n]) for n in ("w_qs", "w_ks", "w_vs"))
        a = m.mm(attention(q, k, v, geom["tsfm_n_head"], window, m), lp["fc"])
        x = layer_norm(lp["attn_norm"], a + x, eps)
        f = m.mm(torch.relu(m.mm(x, lp["ffn_w1"]) + lp["ffn_b1"]), lp["ffn_w2"]) + lp["ffn_b2"]
        x = layer_norm(lp["ffn_norm"], f + x, eps)
    return x


def forward(P, noisy, geom, m: Prec = Prec()):
    """Offline denoising, the published model: noisy (B, L) -> (B, L)."""
    _exact()
    B, L = noisy.shape
    x = noisy.float()
    if m.precision in CASTS:  # mixed precision casts every weight and the input
        P, x = _tree_map(m.r, P), m.r(x)
    norm = geom.get("normalize_input", True)
    if norm:
        std = _std(x)
        x = x / std
    x = F.pad(x, (0, valid_length(L, geom) - L))[..., None]
    skips = []
    for ep in P["encoder"]:
        x = enc_level(ep, x, geom, m)
        skips.append(x)
    x = transformer(P, pointwise(P["tsfm_conv1"], x, m), geom, m)
    x = pointwise(P["tsfm_conv2"], x, m)
    D = len(P["decoder"])
    for j, dp in enumerate(P["decoder"]):
        x = dec_level(dp, x + skips[D - 1 - j][:, :x.shape[1]], geom, m)
        if j != D - 1:
            x = torch.relu(x)
    y = x[:, :L, 0]
    return y * std if norm else y


def stream(P, geom, audio, window: int, m: Prec = Prec()):
    """A session's denoised output, as :func:`portbench.reference.model.stream`
    gives it for CleanUMamba: ``audio`` (B, n) fed from its start, the first
    frame of ``frame_length`` samples, then every ``total_stride`` new ones;
    returns (B, total_stride * (1 + frames after the first)).  The first
    frame's token and the later frames' tokens go through the transformer as
    one sequence, each attending to the last ``window`` tokens."""
    _exact()
    D, K, S = geom["encoder_n_layers"], geom["kernel_size"], geom["stride"]
    ts, fl = S ** D, valid_length(1, geom)
    strides = [S ** (D - 1 - i) for i in range(D)]
    x = audio.float()
    B = x.shape[0]
    N = (x.shape[1] - fl) // ts
    # the running std of every frame, in float64 on the host
    stds = _std(x.unfold(1, fl, ts)[:, :N + 1])[..., 0].double().cpu()
    ema = torch.empty_like(stds)
    for t in range(N + 1):
        n = t + 1  # frame t's count; the first frame's std is its own
        ema[:, t] = stds[:, t] if t == 0 else stds[:, t] / n + (1 - 1 / n) * ema[:, t - 1]
    ema = (ema.float().to(x.device) if geom.get("normalize_input", True)
           else torch.ones(ema.shape, dtype=torch.float32, device=x.device))
    # the first frame whole
    h = (x[:, :fl] / ema[:, :1])[..., None]
    outs0 = []
    for ep in P["encoder"]:
        h = enc_level(ep, h, geom, m)
        outs0.append(h)
    tokens = [pointwise(P["tsfm_conv1"], outs0[-1], m)]
    if N > 0:  # every later frame's encoder as one block
        per = K + S * (strides[0] - 1)
        ends = fl + ts * torch.arange(1, N + 1)
        idx = (ends[:, None] - per + torch.arange(per)).to(x.device)  # (N, per)
        sl = x[:, idx] / ema[:, 1:, None]  # (B, N, per)
        new0 = enc_level(P["encoder"][0], sl.reshape(B * N, per, 1), geom, m)
        skips = [torch.cat([outs0[0][:, strides[0]:], new0.reshape(B, N * strides[0], -1)], 1)]
        for i in range(1, D):
            prev = skips[-1]
            n_new = N * strides[i]
            new = enc_level(P["encoder"][i], prev[:, prev.shape[1] - (K + S * (n_new - 1)):],
                            geom, m)
            skips.append(torch.cat([outs0[i][:, strides[i]:], new], 1))
        tokens.append(pointwise(P["tsfm_conv1"], skips[-1], m))
    tok = pointwise(P["tsfm_conv2"], transformer(P, torch.cat(tokens, 1), geom, m, window), m)
    y0, tails = _decode(P, geom, outs0, tok[:, :1], None, m)
    out = [y0[:, :ts, 0] * ema[:, :1]]
    if N > 0:
        y, _ = _decode(P, geom, skips, tok[:, 1:], tails, m)
        out.append((y[:, :N * ts, 0].reshape(B, N, ts) * ema[:, 1:, None]).reshape(B, N * ts))
    return torch.cat(out, 1)
