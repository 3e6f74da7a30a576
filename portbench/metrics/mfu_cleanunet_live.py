"""CleanUNet's FLOPs of the live rows stepped (a frame's at batch 1 each,
``counts/cleanunet_flops.py``) and of the positions they attended (the
program's counter ``SessionMultiplexer.kv_positions``) over the summed wall
time of the calls into the program (``feed`` and ``flush``) and the fp32
peak, percent, over the whole window."""

from portbench.counts import cleanunet_flops
from portbench.readers import mfu


def read(rec):
    c, g = rec["counts"], rec["geom"]
    if "kv_positions" not in c:
        return None
    flops = (c.get("live_rows", 0) * cleanunet_flops.frame_flops(g)
             + cleanunet_flops.attention_flops(g, c["kv_positions"]))
    return mfu(flops, c["feed_s"] + c.get("flush_s", 0.0), "fp32")
