"""Device ms per update inside the program's ``bn_fwd`` spans: every
BatchNorm forward (``modules/normalization.py``), timed on the stream
between CUDA events."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "train", "bn_fwd", "device_s", 1e3)
