"""K1's roofline share in the offline forward, percent: the bound of one
launch at the clip's shape (``counts/k1.py``, fp32) times the launches,
over K1's device time in the traced calls."""

from portbench.counts import k1, model_flops
from portbench.readers import roofline


def read(rec):
    g, c = rec["geom"], rec["counts"]
    L = model_flops.level_lengths(g, c["clip_samples"])[-1]
    N = g["tsfm_d_model"] // g["tsfm_n_head"]
    return roofline(rec["trace"], k1.PATTERN, k1.cost(c["batch"], L, g["tsfm_d_inner"], N, 4))
