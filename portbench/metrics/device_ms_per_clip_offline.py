"""Device busy time per clip denoised, in ms, over the traced calls."""

from portbench.readers import device_ms_per


def read(rec):
    return device_ms_per(rec, "trace_clips")
