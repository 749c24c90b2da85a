"""Host ms per update inside the ``train_step`` call (it returns before
the device has finished)."""


def read(trace):
    if trace.kind != "train" or not trace.units:
        return None
    return 1e3 * trace.span_s("train_step") / trace.units
