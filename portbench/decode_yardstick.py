r"""
The bound of the decode attention (``virtex_tpu_torch/ops/
decode_attention.py``): the least time the card could take for one
launch's work, from the shape the program notes for it, by
``yardstick.bound``.

It counts the work, not the implementation: q read and the output written
once, and the valid positions of each K/V row read once, however many
query rows share the row (an image's beams share its cross K/V; a self
cache row serves one beam).
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from portbench.yardstick import BF16, bound


def decode_attention_bound(R: int, kv_rows: int, n_valid: int, N: int,
                           D: int, elem: int = BF16) -> Tuple[float, str]:
    """One launch: q (R, N, D) read and the output written once, K and V
    read at ``n_valid`` positions of each of ``kv_rows`` rows; 2 products
    of 2·R·N·n_valid·D FLOPs at the bf16 rate."""
    moved = 2 * R * N * D * elem + 2 * kv_rows * n_valid * N * D * elem
    return bound(moved, 4 * R * N * n_valid * D)


def decode_attention_bound_s(shapes: Iterable[Sequence[int]]) -> float:
    """Seconds of the bounds of launches of shapes (R, K/V rows, n_valid,
    N, D)."""
    return sum(decode_attention_bound(*s)[0] for s in shapes)
