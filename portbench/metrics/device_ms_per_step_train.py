"""Device busy time per training step, in ms, over the traced steps."""

from portbench.readers import device_ms_per


def read(rec):
    return device_ms_per(rec, "trace_steps")
