"""Host ms per caption batch inside the program's ``host_sync`` spans: the
search loop's stop condition, launched and waited for on the host."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "caption", "host_sync", "host_s", 1e3)
