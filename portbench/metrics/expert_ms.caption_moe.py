"""Device ms per caption batch of the routed experts' grouped GEMM
launches (``ops/moe.py``), found by kernel name
(``moe_yardstick.is_expert_kernel``), eager or replayed."""
from portbench.moe_yardstick import is_expert_kernel


def read(trace):
    if trace.kind != "caption" or not trace.units:
        return None
    spent = [b - a for name, a, b, _ in trace.kernels
             if is_expert_kernel(name)]
    if not spent:
        return None
    return 1e3 * sum(spent) / 1e6 / trace.units
