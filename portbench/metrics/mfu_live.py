"""The model FLOPs of the live rows stepped (a frame's FLOPs at batch 1 each)
over the summed wall time of the calls into the program (``feed`` and
``flush``) and the published peak of the compute dtype, percent, over the
whole window."""

from portbench.counts import model_flops
from portbench.readers import mfu


def read(rec):
    c = rec["counts"]
    flops = c.get("live_rows", 0) * model_flops.frame_flops(rec["geom"])
    return mfu(flops, c["feed_s"] + c.get("flush_s", 0.0), c["compute"])
