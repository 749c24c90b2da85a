"""Share of the traced caption batches' decode steps that replayed a CUDA
graph (``engine/captioner.py DecodeGraphs``), in percent, from the
program's ``decode_graph`` notes: one a step, ``"replay"`` or
``"eager"``. Nothing to read for a program that notes no steps."""
import importlib

NAME = "decode_graph"


def read(trace):
    if trace.kind != "caption":
        return None
    try:
        tracing = importlib.import_module("virtex_tpu_torch.utils.tracing")
    except ImportError:
        return None
    notes = getattr(tracing, "notes", None)
    steps = notes(NAME) if notes is not None else []
    if not steps:
        return None
    return 100.0 * steps.count("replay") / len(steps)
