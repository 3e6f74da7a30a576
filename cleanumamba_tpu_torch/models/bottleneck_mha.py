"""Causal multi-head-attention bottleneck, the "CleanUNet" variant (port of
``cleanumamba_tpu/models/bottleneck_mha.py``).

A post-norm transformer encoder with a causal mask and no positional
encoding; the module-level ``enc_norm`` is applied to the INPUT of the layer
stack.  Per layer:

    a   = softmax(QK^T / sqrt(d_k) + causal mask) V -> fc -> + residual -> LN
    ffn = W2 relu(W1 a + b1) + b2 -> + residual -> LN

Streaming keeps a ring KV cache of ``max_len`` positions per layer and one
position counter shared by the batch.
"""

from __future__ import annotations

import math

import torch

from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform
from cleanumamba_tpu_torch.ops.norms import layer_norm


def init(gen: torch.Generator, cfg):
    d, d_inner = cfg.tsfm_d_model, cfg.tsfm_d_inner

    def lin(fan_in, shape):
        return uniform(gen, shape, 1.0 / math.sqrt(fan_in))

    def ln():
        return {"scale": torch.ones((d,)), "bias": torch.zeros((d,))}

    layers = [{"w_qs": lin(d, (d, d)), "w_ks": lin(d, (d, d)), "w_vs": lin(d, (d, d)),
               "fc": lin(d, (d, d)), "attn_norm": ln(),
               "ffn_w1": lin(d, (d, d_inner)), "ffn_b1": lin(d, (d_inner,)),
               "ffn_w2": lin(d_inner, (d_inner, d)), "ffn_b2": lin(d_inner, (d,)),
               "ffn_norm": ln()} for _ in range(cfg.tsfm_n_layers)]
    return {"layers": layers, "enc_norm": ln()}


def _ln(p, x, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _ffn(p, x, eps):
    f = torch.relu(x @ p["ffn_w1"].to(x.dtype) + p["ffn_b1"].to(x.dtype))
    f = f @ p["ffn_w2"].to(x.dtype) + p["ffn_b2"].to(x.dtype)
    return _ln(p["ffn_norm"], f + x, eps)


def _causal_attention(q, k, v, n_head: int):
    """Plain matmul + softmax attention with the causal mask, fp32 logits."""
    B, T, d = q.shape
    d_k = d // n_head
    q, k, v = (t.reshape(B, T, n_head, d_k).transpose(1, 2) for t in (q, k, v))
    logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d_k)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    out = torch.softmax(logits, dim=-1).to(v.dtype) @ v
    return out.transpose(1, 2).reshape(B, T, d)


def forward(params, x, cfg):
    """Offline forward.  x: (B, T, d_model) -> (B, T, d_model)."""
    eps = cfg.norm_epsilon
    x = _ln(params["enc_norm"], x, eps)
    for p in params["layers"]:
        q = x @ p["w_qs"].to(x.dtype)
        k = x @ p["w_ks"].to(x.dtype)
        v = x @ p["w_vs"].to(x.dtype)
        a = _causal_attention(q, k, v, cfg.tsfm_n_head) @ p["fc"].to(x.dtype)
        x = _ffn(p, _ln(p["attn_norm"], a + x, eps), eps)
    return x


def mha_max_len(cfg) -> int:
    """Slots of the streaming ring KV cache: at least 10 s of audio at the
    bottleneck's token rate."""
    return max(1, (16000 * 10) // cfg.total_stride)


def init_cache(params, cfg, batch_size: int, max_len: int, dtype=torch.float32, device="cpu"):
    """Ring KV cache: ``max_len`` slots per layer, one shared position."""
    d = params["layers"][0]["w_qs"].shape[0]
    n = len(params["layers"])
    return {"k": torch.zeros((n, batch_size, max_len, d), dtype=dtype, device=device),
            "v": torch.zeros((n, batch_size, max_len, d), dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def ring_mask(pos, max_len: int):
    """(slot one-hot, valid) over the ring's ``max_len`` slots, both (max_len,)
    bool: the slot this step writes (``pos mod max_len``) and the slots
    written so far (0..min(pos, max_len - 1)).  ``pos`` is a 0-d int tensor;
    no host read."""
    idx = torch.arange(max_len, device=pos.device)
    return idx == pos % max_len, idx <= torch.clamp(pos, max=max_len - 1)


def step(params, cfg, cache, x):
    """Single-token streaming step.  x: (B, d_model) -> (cache', (B, d_model)).

    Attends to at most ``max_len`` past positions (the ring); beyond that the
    window slides."""
    eps, n_head = cfg.norm_epsilon, cfg.tsfm_n_head
    max_len = cache["k"].shape[2]
    onehot, valid = ring_mask(cache["pos"], max_len)
    new_k, new_v = [], []
    x = _ln(params["enc_norm"], x, eps)
    B, d = x.shape
    d_k = d // n_head
    for li, p in enumerate(params["layers"]):
        q = x @ p["w_qs"].to(x.dtype)
        k = x @ p["w_ks"].to(x.dtype)
        v = x @ p["w_vs"].to(x.dtype)
        kc = torch.where(onehot[None, :, None], k[:, None, :], cache["k"][li])
        vc = torch.where(onehot[None, :, None], v[:, None, :], cache["v"][li])
        new_k.append(kc)
        new_v.append(vc)
        kh = kc.reshape(B, max_len, n_head, d_k)
        vh = vc.reshape(B, max_len, n_head, d_k)
        logits = torch.einsum("bhd,bshd->bhs", q.reshape(B, n_head, d_k).float(), kh.float())
        logits = logits / math.sqrt(d_k)
        logits = torch.where(valid[None, None, :], logits, torch.full_like(logits, -1e9))
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.einsum("bhs,bshd->bhd", attn, vh).reshape(B, d) @ p["fc"].to(x.dtype)
        x = _ffn(p, _ln(p["attn_norm"], a + x, eps), eps)
    return {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": cache["pos"] + 1}, x
