"""Device ms per update of the operations launched inside the spans around
``model.textual``'s and ``model.backward_textual``'s forwards."""


def read(trace):
    return trace.device_ms_per_unit("train", "textual", "backward_textual")
