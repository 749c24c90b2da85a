"""Device ms per caption batch inside the program's ``decode_step`` spans:
the decoder's step and its log-softmax (``engine/captioner.py``), timed
on the stream between CUDA events."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "caption", "decode_step", "device_s", 1e3)
