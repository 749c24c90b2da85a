"""Device ms per caption batch inside the program's ``beam_select`` spans:
the repetition penalty, both top-k and the winners' tokens
(``utils/beam_search.py``), timed on the stream between CUDA events."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "caption", "beam_select", "device_s", 1e3)
