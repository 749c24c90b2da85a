r"""
What the per-layer readers read from the program's own spans
(``virtex_tpu_torch/utils/tracing.py``): the store of the profiler session
that traced the stretch, which the reader reads in the run's own process
once the window has closed.

A reading is per unit of the stretch (an update or a caption batch) and
belongs to it only when the store's outermost span of that kind
(``train_step`` or ``caption``) ran as many times as the trace has units;
otherwise, and for a program without spans, there is nothing to read.
"""
from __future__ import annotations

import importlib
from typing import Optional

UNIT_SPANS = {"train": "train_step", "caption": "caption"}


def per_unit(trace, kind: str, name: str, field: str,
             scale: float = 1.0) -> Optional[float]:
    """``field`` (``count``, ``host_s`` or ``device_s``) of the spans
    ``name`` over the traced stretch of ``kind``, per unit, times
    ``scale``; None where there is nothing to read (a span that never ran
    counts 0 and spends no host time; its device time is unknown)."""
    if trace.kind != kind or not trace.units:
        return None
    try:
        tracing = importlib.import_module("virtex_tpu_torch.utils.tracing")
    except ImportError:  # a program without spans
        return None
    table = tracing.summary()
    if table.get(UNIT_SPANS[kind], {}).get("count") != trace.units:
        return None
    value = table.get(name, {"count": 0, "host_s": 0.0,
                             "device_s": None})[field]
    return None if value is None else scale * value / trace.units
