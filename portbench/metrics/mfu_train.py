"""3 x the model's forward FLOPs of each step's batch x the steps of the
window, over its wall time and the bf16 peak (989 TFLOP/s), percent."""

from portbench.counts import model_flops
from portbench.readers import mfu


def read(rec):
    c = rec["counts"]
    flops = 3 * model_flops.offline_flops(rec["geom"], c["samples"], c["batch"]) * c["steps"]
    return mfu(flops, c["window_s"], "bf16")
