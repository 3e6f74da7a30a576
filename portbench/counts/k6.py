"""K6, one token of attention over per-row KV rings (``ops/cuda/
kv_attention.py`` -> ``csrc/kv_attention.cu::kv_attention_kernel``; one
launch a layer).

Operations per attended position and layer: q . k and the value weighted
into the output, 2 d_model each, and one exp a head.  Bytes, each input
read once and each output written once: per attended position and layer
its key and value (the token's own among them, read from k and v); per live
row and layer q read, the output written, and the new key and value written
into the ring.  A paused row's mask and position are left out."""

PATTERN = r"\bkv_attention_kernel\b"


def cost(geom: dict, positions: int, rows: int, esize: int = 4):
    """(operations, bytes) of the launches that attended ``positions`` slots
    in all for ``rows`` live rows, summed over the layers."""
    L, d, H = geom["tsfm_n_layers"], geom["tsfm_d_model"], geom["tsfm_n_head"]
    ops = L * positions * (4 * d + H)
    nbytes = L * (2 * d * positions + 4 * d * rows) * esize
    return ops, nbytes
