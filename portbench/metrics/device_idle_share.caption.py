"""Share of the traced stretch of caption batches in which no operation ran
on the device."""


def read(trace):
    return trace.idle_share() if trace.kind == "caption" else None
