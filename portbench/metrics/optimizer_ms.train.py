"""Device ms per update of the operations launched inside the span around
the optimizer's ``step``."""


def read(trace):
    return trace.device_ms_per_unit("train", "optimizer")
