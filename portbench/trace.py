r"""
The traced stretch of a ``--trace 1`` run: a few steady calls inside the
window under ``torch.profiler`` (CPU and CUDA activity), and what the
per-layer readers read from it.

Spans are named host ranges that the benchmark opens around calls into
the program's layers (``record_function("pb::<name>")``), from outside:
forward hooks on modules and wrappers on instances. A kernel belongs to a
span when the host call that launched it (the runtime event with the
kernel's correlation id) lies inside the span on the same thread. Device
busy time is the union of the device events' intervals. Counters and
shapes that the drivers record go in ``facts``.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "pb::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
START = 0.5  # the stretch starts this far into the window


class Spans:
    """Open and close named spans from hooks: a stack per name."""

    def __init__(self):
        self._open: Dict[str, list] = {}

    def enter(self, name: str) -> None:
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        self._open.setdefault(name, []).append(rf)

    def exit(self, name: str) -> None:
        self._open[name].pop().__exit__(None, None, None)

    def span(self, name: str):
        return torch.profiler.record_function(PREFIX + name)

    def hook(self, module: torch.nn.Module, name: str):
        """Forward pre- and post-hooks that open and close span ``name``;
        returns their handles."""
        return [module.register_forward_pre_hook(
                    lambda *_: self.enter(name)),
                module.register_forward_hook(lambda *_: self.exit(name))]


class Trace:
    """What one stretch gave: its wall seconds, the device's busy seconds,
    the units (updates or batches) and images it ran, the device events,
    the spans, and the drivers' ``facts``."""

    def __init__(self, kind: str, units: int, images: int, window_s: float,
                 events: List[dict], facts: dict):
        self.kind, self.units, self.images = kind, units, images
        self.window_s, self.facts = window_s, facts
        spans, device, launches = [], [], {}
        for e in events:
            cat, name = e.get("cat"), e.get("name", "")
            if cat == "user_annotation" and name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], float(e["ts"]),
                              float(e["ts"]) + float(e.get("dur", 0.0)),
                              e.get("tid")))
            elif cat in DEVICE_CATS:
                device.append(e)
            elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (float(e["ts"]),
                                                      e.get("tid"))
        self.spans = spans
        self.kernels = []  # (name, start_us, end_us, span names)
        for e in device:
            ts = float(e["ts"])
            launch = launches.get(e.get("args", {}).get("correlation"))
            owners = frozenset() if launch is None else frozenset(
                s[0] for s in spans
                if s[3] == launch[1] and s[1] <= launch[0] <= s[2])
            self.kernels.append((e.get("name", ""), ts,
                                 ts + float(e.get("dur", 0.0)), owners))
        self.intervals = _union(sorted((k[1], k[2]) for k in self.kernels))
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6

    # -- what the readers ask ------------------------------------------------
    def device_s(self, span: Optional[str] = None,
                 names: Tuple[str, ...] = ()) -> Optional[float]:
        """Device seconds of the events launched inside ``span`` (any span
        when None) whose lowercased name holds one of ``names`` (any name
        when empty); None when the trace holds no device event."""
        if not self.kernels:
            return None
        total = 0.0
        for name, a, b, owners in self.kernels:
            if span is not None and span not in owners:
                continue
            if names and not any(n in name.lower() for n in names):
                continue
            total += b - a
        return total / 1e6

    def device_ms_per_unit(self, kind: str, *spans: str) -> Optional[float]:
        """Device ms per unit launched inside any of ``spans``, for a trace
        of ``kind``; None where there is nothing to read."""
        if self.kind != kind or not self.units or not self.kernels:
            return None
        return 1e3 * sum(self.device_s(s) for s in spans) / self.units

    def span_s(self, name: str) -> float:
        """Host seconds inside span ``name``, summed."""
        return sum(b - a for n, a, b, _ in self.spans if n == name) / 1e6

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.kernels:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for name, a, b, _ in self.kernels:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = []
        for (_, end), (start, _) in zip(self.intervals, self.intervals[1:]):
            mid = (end + start) / 2
            open_ = [s for s in self.spans if s[1] <= mid <= s[2]]
            label = (min(open_, key=lambda s: s[2] - s[1])[0] if open_
                     else "outside every span")
            gaps.append((label, (start - end) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:TOP]]}


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def profile(kind: str, run_units, units: int, images_per_unit: int,
            device, facts: dict) -> Trace:
    """Run ``run_units(units)`` under the profiler, from a synchronised
    start to a synchronised end, and read the trace."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_units(units)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    return Trace(kind, units, units * images_per_unit, window, events, facts)
