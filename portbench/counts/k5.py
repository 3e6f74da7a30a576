"""K5, the whole streamed frame in one launch (``ops/cuda/stream_mega.py`` ->
``csrc/stream_mega.cu::mega_kernel``).

Operations: the model's FLOPs of one frame (``model_flops.frame_flops``).
Bytes, each once: every weight in the pack's dtype, the streaming state read
and written in fp32 (the input tail, every encoder level's cached suffix,
the decoder tails, each layer's conv state and SSM state), the frame's new
samples and its output."""

from portbench.counts import model_flops

PATTERN = r"\bmega_kernel\b"


def state_floats(geom: dict) -> int:
    """fp32 values of one stream's state."""
    D, K, S = geom["encoder_n_layers"], geom["kernel_size"], geom["stride"]
    lens = [1]
    for _ in range(D - 1):
        lens.append((lens[-1] - 1) * S + K)
    lens = lens[::-1]  # a frame's output positions at each level
    fl = (lens[0] - 1) * S + K
    new = model_flops.frame_positions(geom)
    w = model_flops.widths(geom)
    enc = sum((n - s) * h for n, s, (_, h) in zip(lens, new, w))
    dec = sum(S * cin for cin, _ in w)  # a tail of S outputs of each level's input width
    di, dm = geom["tsfm_d_inner"], geom["tsfm_d_model"]
    N = dm // geom["tsfm_n_head"]
    bott = geom["tsfm_n_layers"] * (geom.get("d_conv", 4) * di + di * N)
    return (fl - S ** D) + 2 + enc + dec + bott  # input tail, std and count, caches


def cost(geom: dict, batch: int = 1, wsize: int = 4):
    """(operations, bytes) of one launch over ``batch`` streams."""
    ops = batch * model_flops.frame_flops(geom)
    hop = geom["stride"] ** geom["encoder_n_layers"]
    nbytes = (model_flops.param_count(geom) * wsize
              + batch * (2 * state_floats(geom) + 2 * hop) * 4)
    return ops, nbytes

