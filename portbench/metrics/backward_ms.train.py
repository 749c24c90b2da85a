"""Device ms per update inside the program's ``backward`` spans: the
backward of every micro-step (``engine/trainer.py``), timed on the stream
between CUDA events."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "train", "backward", "device_s", 1e3)
