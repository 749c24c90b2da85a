"""Device ms per caption batch inside the program's ``prefill`` spans:
the head's ``init_decode`` (the 49-token prefix through the decoder,
``engine/captioner.py``), timed on the stream between CUDA events."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "caption", "prefill", "device_s", 1e3)
