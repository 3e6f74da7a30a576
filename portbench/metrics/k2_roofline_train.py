"""K2's roofline share in the training step, percent: the bound of one call
(``counts/k2.py``) times the calls, over the device time of all its
launches (the walk and the finishing sums) in the traced steps."""

from portbench.counts import k2, model_flops
from portbench.readers import roofline


def read(rec):
    g, c = rec["geom"], rec["counts"]
    L = model_flops.level_lengths(g, c["samples"])[-1]
    N = g["tsfm_d_model"] // g["tsfm_n_head"]
    esize = 2 if c["compute"] == "bf16" else 4
    return roofline(rec["trace"], k2.PATTERN, k2.cost(c["batch"], L, g["tsfm_d_inner"], N, esize),
                    call_pattern=k2.CALL_PATTERN)
