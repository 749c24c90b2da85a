"""The routed experts' grouped launches over the traced caption batches:
the bound of every launch of the stretch, from the shapes the program
noted in its tracing store (``portbench/moe_yardstick.py``), over the
device time of those kernels, in percent. Nothing to read for a program
that notes no such launches, or where the launches and the notes differ in
number."""
import importlib

from portbench.moe_yardstick import expert_bound_s, is_expert_kernel

NAME = "moe_experts"


def read(trace):
    if trace.kind != "caption":
        return None
    try:
        tracing = importlib.import_module("virtex_tpu_torch.utils.tracing")
    except ImportError:
        return None
    notes = getattr(tracing, "notes", None)
    shapes = notes(NAME) if notes is not None else []
    launches = [(a, b) for name, a, b, _ in trace.kernels
                if is_expert_kernel(name)]
    spent = sum(b - a for a, b in launches) / 1e6
    if not shapes or len(launches) != len(shapes) or spent <= 0:
        return None
    return 100.0 * expert_bound_s(shapes) / spent
