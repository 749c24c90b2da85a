"""Host syncs per caption batch: the program's ``host_sync`` spans, one per
test of the search loop's stop condition (``utils/beam_search.py``)."""
from portbench.program_spans import per_unit


def read(trace):
    return per_unit(trace, "caption", "host_sync", "count")
