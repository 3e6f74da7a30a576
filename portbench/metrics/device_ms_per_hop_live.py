"""Device busy time per hop fed, in ms, over the traced slice of the window."""

from portbench.readers import device_ms_per


def read(rec):
    return device_ms_per(rec, "trace_hops")
