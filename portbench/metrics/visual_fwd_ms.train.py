"""Device ms per update of the operations launched inside the span around
``model.visual``'s forward."""


def read(trace):
    return trace.device_ms_per_unit("train", "visual")
