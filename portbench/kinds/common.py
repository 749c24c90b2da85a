r"""
What the drivers share: the program's model built through its factories
on the run's device, the weights drawn from the seed and loaded into it,
the cuDNN flags of the configuration, the device's description, and the
measured window.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import torch

from portbench import trace

Shapes = List[Tuple[str, Tuple[int, ...]]]


def set_backend_flags(config) -> None:
    torch.backends.cudnn.benchmark = bool(config.CUDNN_BENCHMARK)
    torch.backends.cudnn.deterministic = bool(config.CUDNN_DETERMINISTIC)


def build_model(config, device):
    """The program's model of ``config`` (``PretrainingModelFactory``), its
    parameters allocated on ``device`` and drawn there from ``seed``
    afterwards."""
    from virtex_tpu_torch.factories import PretrainingModelFactory
    with torch.device(device):
        return PretrainingModelFactory.from_config(config, device)


def parameter_shapes(model) -> Shapes:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


@torch.no_grad()
def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the drawn weights (and any BatchNorm running statistics among
    them) into the program's model, by name."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    for name, value in weights.items():
        (params.get(name) if name in params else buffers[name]).copy_(value)


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def build_seconds() -> float:
    """Seconds this process spent building the program's kernels (0 when
    they were already built)."""
    from virtex_tpu_torch.ops import _build
    return float(_build.build_seconds or 0.0)


def window(run, session, traced_units: int):
    """Run ``session.unit()`` back to back for ``run.seconds``; with
    ``--trace 1`` a stretch of ``traced_units`` units runs under the
    profiler (``session.traced``) from ``trace.START`` of the window on.
    Returns the host seconds of each unit outside the stretch, the units
    run, the window's seconds (to the device's last work) and the trace
    or None."""
    times, traced = [], None
    t0 = time.perf_counter()
    trace_at = t0 + run.seconds * trace.START
    while time.perf_counter() - t0 < run.seconds:
        if run.trace and traced is None and time.perf_counter() >= trace_at:
            traced = session.traced(traced_units)
            continue
        a = time.perf_counter()
        session.unit()
        times.append(time.perf_counter() - a)
    if run.trace and traced is None:
        traced = session.traced(traced_units)
    sync(session.device)
    units = len(times) + (traced_units if traced is not None else 0)
    return times, units, time.perf_counter() - t0, traced
