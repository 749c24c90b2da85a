r"""
The bound of the routed experts' grouped launches (``virtex_tpu_torch/
ops/moe.py``): the least time the card could take for one launch's work,
from the shape the program notes for it, by ``yardstick.bound``.

It counts the work, not the implementation: each expert's bf16 weights
read once (every expert of the layer, as a served batch routes to all of
them), the dispatched rows read and the projection's outputs written once,
and 2·rows·k·H·F FLOPs a projection at the bf16 rate (gate and up are two
projections in one launch).
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from portbench.yardstick import BF16, bound

# The GEMM kernel of a ``torch._grouped_mm`` call carries one of these in
# its lowercased name (CUTLASS's grouped GEMM on sm90); its small set-up
# kernel does not.
KERNEL_NAMES = ("groupproblemshape",)


def expert_bound(rows: int, top_k: int, E: int, H: int, F: int,
                 projection: str, elem: int = BF16) -> Tuple[float, str]:
    """One launch of ``projection`` ("gate_up" or "down") over ``rows``
    tokens of ``top_k`` experts each."""
    n = rows * top_k
    if projection == "gate_up":
        width_in, width_out, products = H, 2 * F, 2
    elif projection == "down":
        width_in, width_out, products = F, H, 1
    else:
        raise ValueError(f"unknown projection {projection!r}")
    moved = (E * H * F * products + n * width_in + n * width_out) * elem
    return bound(moved, products * 2 * n * H * F)


def expert_bound_s(shapes: Iterable[Sequence]) -> float:
    """Seconds of the bounds of launches noted (rows, k, E, H, F,
    projection)."""
    return sum(expert_bound(*s)[0] for s in shapes)


def is_expert_kernel(name: str) -> bool:
    name = name.lower()
    return any(k in name for k in KERNEL_NAMES)
