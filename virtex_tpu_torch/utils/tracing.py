r"""
Named spans at the port's layer boundaries, recorded while a profiler
records and free otherwise.

``with span("bn_fwd", x): ...`` marks a stretch of the program. With no
recording profiler (``torch.autograd._profiler_enabled()`` false) it
returns one shared no-op context: no ``record_function``, no allocation,
no clock reading. Under a recording ``torch.profiler.profile`` it opens
``record_function("virtex::bn_fwd")``, a range on the profiler's timeline
beside the device kernels it launches, and keeps a :class:`Record` in
memory: the host start and end on ``time.time_ns()`` (the clock of the
exported trace, whose ``ts + baseTimeNanoseconds / 1000`` is unix µs),
its parent on this thread, its unit (the outermost open span: one update
or one batch), and, when ``where`` (a tensor or a device) is on CUDA, a
pair of timing events on the current stream.

A span's device seconds are the stream's time between its two events: its
kernels and whatever idle the host left between them, which is its busy
time while the launch queue stays full. They are read lazily, after the
end events have completed, by :func:`summary`.

``note("decode_attention", shape)`` keeps a value beside the records
(a kernel's launch shape), under a recording profiler only; :func:`notes`
returns a name's values in the order they were noted.

One profiler session is one store: the first span or note recorded after
a span or note that came with the profiler off starts the records and the
notes afresh. A reader that calls :func:`summary` or :func:`notes` once
the profiler has stopped reads the last session, as long as no span or
note has come since with the profiler on.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "virtex::"

_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_records: List["Record"] = []
_notes: Dict[str, list] = {}
_stale = False  # a span or note came unprofiled since the last record
_local = threading.local()  # .stack: this thread's open records
_unit: Optional["Record"] = None  # the outermost open record, any thread
_streams: Dict[tuple, "torch.cuda.Stream"] = {}  # by (id, device, type)


class Record:
    """One span as it ran. ``parent`` is the span open around it on its
    thread; ``unit`` the outermost span open when it started, on any
    thread (a backward thread's spans belong to the update that runs
    it)."""

    __slots__ = ("name", "parent", "unit", "thread", "start_ns", "end_ns",
                 "events", "_device_s")

    def __init__(self, name: str, parent: Optional["Record"],
                 unit: Optional["Record"]):
        self.name, self.parent = name, parent
        self.unit = unit or self
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0
        self.events = None
        self._device_s: Optional[float] = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self) -> Optional[float]:
        """Stream seconds between the span's events; None without them.
        Waits for the end event."""
        if self.events is None:
            return None
        if self._device_s is None:
            start, end = self.events
            end.synchronize()
            self._device_s = start.elapsed_time(end) / 1e3
        return self._device_s


class _Span:
    __slots__ = ("record", "function", "stream")

    def __init__(self, name: str, where):
        _fresh()
        stack = _stack()
        parent = stack[-1] if stack else None
        self.record = Record(name, parent, parent.unit if parent else _unit)
        _records.append(self.record)
        self.function = torch.profiler.record_function(PREFIX + name)
        self.stream = _cuda_stream(where)

    def __enter__(self):
        global _unit
        r = self.record
        stack = _stack()
        if not stack and _unit is None:
            _unit = r
        stack.append(r)
        r.start_ns = time.time_ns()
        self.function.__enter__()
        if self.stream is not None:
            r.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            r.events[0].record(self.stream)
        return r

    def __exit__(self, *exc):
        global _unit
        r = self.record
        if r.events is not None:
            r.events[1].record(self.stream)
        self.function.__exit__(*exc)
        r.end_ns = time.time_ns()
        _stack().pop()
        if _unit is r:
            _unit = None
        return False


def _fresh() -> None:
    """Start the store afresh if a span or note came with the profiler off
    since the last record."""
    global _records, _notes, _stale
    if _stale:
        _records, _notes, _stale = [], {}, False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_stream(where):
    """The current CUDA stream of ``where``'s device; None off CUDA. The
    stream objects are kept by id: ``torch.cuda.current_stream`` builds a
    new one under a device guard, which costs more than the rest of an
    event's record."""
    if where is None:
        return None
    device = where.device if isinstance(where, torch.Tensor) else \
        torch.device(where)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = torch._C._cuda_getCurrentStream(index)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def recording() -> bool:
    """Whether a profiler records, and spans and notes are kept."""
    return _profiling()


def span(name: str, where=None):
    """A context over one stretch of the program named ``name``; its
    device seconds are read on the CUDA stream of ``where`` (a tensor or a
    device) when that is a card. A no-op unless a profiler records."""
    global _stale
    if not _profiling():
        _stale = True
        return _OFF
    return _Span(name, where)


def note(name: str, value) -> None:
    """Keep ``value`` under ``name`` in the session's store; a no-op unless
    a profiler records."""
    global _stale
    if not _profiling():
        _stale = True
        return
    _fresh()
    _notes.setdefault(name, []).append(value)


def notes(name: str) -> list:
    """The values noted under ``name`` in the last profiler session."""
    return list(_notes.get(name, ()))


def records() -> List[Record]:
    """The records of the last profiler session, finished ones, in the
    order they started."""
    return [r for r in _records if r.end_ns]


def summary() -> Dict[str, dict]:
    """Per span name of the last session: ``count``, ``host_s``,
    ``self_host_s`` (less its children's host seconds) and ``device_s``
    (None where no record of the name holds CUDA events)."""
    done = records()
    out: Dict[str, dict] = {}
    for r in done:
        s = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                    "self_host_s": 0.0, "device_s": None})
        s["count"] += 1
        s["host_s"] += r.host_s
        s["self_host_s"] += r.host_s
        if r.events is not None:
            s["device_s"] = (s["device_s"] or 0.0) + r.device_s
    finished = set(map(id, done))
    for r in done:
        if id(r.parent) in finished:
            out[r.parent.name]["self_host_s"] -= r.host_s
    return out


def per_unit_line() -> str:
    """One line: each span's ms per ``train_step`` span, host and device
    (``-`` off CUDA), the longest host time first; empty when the session
    holds no ``train_step``."""
    table = summary()
    n = table.get("train_step", {}).get("count", 0)
    if not n:
        return ""
    parts = []
    for name, s in sorted(table.items(), key=lambda kv: -kv[1]["host_s"]):
        device = ("-" if s["device_s"] is None
                  else f"{1e3 * s['device_s'] / n:.3f}")
        parts.append(f"{name} {1e3 * s['host_s'] / n:.3f}/{device}")
    return (f"spans, ms per train_step (host/device) over {n}: "
            + ", ".join(parts))
