"""K1's roofline share in the training step, percent: the bound of one
launch at the step's shape (``counts/k1.py``; batch x the bottleneck's
tokens x d_inner x d_state, u, B and C in the compute dtype) times the
launches, over K1's device time in the traced steps."""

from portbench.counts import k1, model_flops
from portbench.readers import roofline


def read(rec):
    g, c = rec["geom"], rec["counts"]
    L = model_flops.level_lengths(g, c["samples"])[-1]
    N = g["tsfm_d_model"] // g["tsfm_n_head"]
    esize = 2 if c["compute"] == "bf16" else 4
    return roofline(rec["trace"], k1.PATTERN, k1.cost(c["batch"], L, g["tsfm_d_inner"], N, esize))
