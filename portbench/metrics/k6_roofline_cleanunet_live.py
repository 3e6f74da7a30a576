"""K6's roofline share in the live tick, percent: the bound of the traced
slice's attention (``counts/k6.py``, fp32: the positions its live rows
attended, from the program's counter ``SessionMultiplexer.kv_positions``,
and one live row a tick, the fewest a tick steps) over K6's device time in
the slice."""

from portbench.counts import k6, peaks
from portbench.readers import kernel


def read(rec):
    c, t = rec["counts"], rec["trace"]
    if not t or not c.get("kv_positions_traced"):
        return None
    _, seconds = kernel(t, k6.PATTERN)
    if seconds <= 0:
        return None
    ops, nbytes = k6.cost(rec["geom"], c["kv_positions_traced"], c["ticks_traced"])
    return 100.0 * peaks.bound_s(ops, nbytes) / seconds
