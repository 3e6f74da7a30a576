"""The model's forward FLOPs of each clip x the clips of the window, over its
wall time and the fp32 peak (67 TFLOP/s; TF32 off), percent."""

from portbench.counts import model_flops
from portbench.readers import mfu


def read(rec):
    c = rec["counts"]
    flops = model_flops.offline_flops(rec["geom"], c["clip_samples"], c["batch"]) * c["clips"]
    return mfu(flops, c["window_s"], c["compute"])
