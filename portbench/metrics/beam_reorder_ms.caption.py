"""Device ms per caption batch inside the program's ``beam_reorder`` spans:
the predictions' and the self-attention caches' reorder after the winners
(``utils/beam_search.py``), timed on the stream between CUDA events."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "caption", "beam_reorder", "device_s", 1e3)
