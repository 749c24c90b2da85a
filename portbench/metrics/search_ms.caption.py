"""Host ms per caption batch inside the caption call and outside the
visual span: the decode steps and the beam bookkeeping."""


def read(trace):
    if trace.kind != "caption" or not trace.units:
        return None
    return 1e3 * (trace.span_s("caption")
                  - trace.span_s("visual")) / trace.units
