"""Share of the traced stretch of train updates in which no operation ran
on the device."""


def read(trace):
    return trace.idle_share() if trace.kind == "train" else None
