"""Causal multi-head-attention bottleneck, the "CleanUNet" variant (port of
``cleanumamba_tpu/models/bottleneck_mha.py``).

A post-norm transformer encoder with a causal mask and no positional
encoding; the module-level ``enc_norm`` is applied to the INPUT of the layer
stack.  Per layer:

    a   = softmax(QK^T / sqrt(d_k) + causal mask) V -> fc -> + residual -> LN
    ffn = W2 relu(W1 a + b1) + b2 -> + residual -> LN

Streaming keeps, for each row of the batch (a session), a ring of the keys
and values of its last ``W`` tokens in every layer and its own count of the
tokens written: a row attends to ``min(pos + 1, W)`` slots, whatever the
other rows' ages.  A step writes this token's key and value into the ring in
place (K6, ``ops/cuda/kv_attention.py``), at ``pos mod W`` of every row;
the rest of its state is new tensors.
"""

from __future__ import annotations

import math

import torch

from cleanumamba_tpu_torch.models.bottleneck_mamba import uniform
from cleanumamba_tpu_torch.ops.cuda.kv_attention import kv_attention
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


def init_cache(params, cfg, batch_size: int, max_len=None, dtype=torch.float32, device="cpu"):
    """Empty rings: ``k``, ``v`` (batch, layers, window, d_model) and ``pos``
    (batch,) int32.  ``max_len``: the window W, ``mha_max_len(cfg)`` when
    None."""
    d = params["layers"][0]["w_qs"].shape[0]
    n = len(params["layers"])
    W = mha_max_len(cfg) if max_len is None else max_len
    return {"k": torch.zeros((batch_size, n, W, d), dtype=dtype, device=device),
            "v": torch.zeros((batch_size, n, W, d), dtype=dtype, device=device),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}


def ring_mask(pos, max_len: int):
    """(slot one-hot, valid), each (B, max_len) bool, of rows at positions
    ``pos`` (B,): the slot a step writes (``pos mod max_len``) and the slots
    written so far with it (0..min(pos, max_len - 1)).  No host read."""
    idx = torch.arange(max_len, device=pos.device)[None, :]
    pos = pos[:, None]
    return idx == pos % max_len, idx <= torch.clamp(pos, max=max_len - 1)


def step(params, cfg, cache, x):
    """Single-token streaming step.  x: (B, d_model) -> (cache', (B, d_model)).

    A row attends to at most W past tokens (its ring); beyond that the window
    slides.  The rings of ``cache`` are written in place and returned as
    they are; ``pos`` comes back advanced by one, in a new tensor.  The
    write is idempotent: a second call on the same ``cache`` and ``x``
    writes the same slots with the same values and returns the same output
    (K6 reads the token's own slot from its new key and value), which
    ``graphs.StepGraphs``' warm-up runs rely on.  Not traceable by
    ``torch.export`` on a card (K6 is not a custom op): ``export.
    export_stream`` refuses an mha model."""
    eps, n_head = cfg.norm_epsilon, cfg.tsfm_n_head
    pos = cache["pos"]
    x = _ln(params["enc_norm"], x, eps)
    for li, p in enumerate(params["layers"]):
        q = x @ p["w_qs"].to(x.dtype)
        k = x @ p["w_ks"].to(x.dtype)
        v = x @ p["w_vs"].to(x.dtype)
        a = kv_attention(q, k, v, cache["k"][:, li], cache["v"][:, li], pos, n_head)
        x = _ffn(p, _ln(p["attn_norm"], a @ p["fc"].to(x.dtype) + x, eps), eps)
    return {"k": cache["k"], "v": cache["v"], "pos": pos + 1}, x
