r"""
How the port's kernels are launched and counted, for every wrapper in
``ops/``.

:func:`launch` calls a C entry point of the kernels' library
(``ops/_build.py``) on the current stream of its tensor's device, that
device made current only where it is not already, raises with the
kernel's name on a CUDA error, and counts the launch under its key,
(kernel, variant): ``k1``, ``k2`` (``mma`` | ``scalar``); ``k4_sums``,
``k4_dx``, ``bn_stats``, ``bn_apply`` (``vector`` | ``scalar``);
``decode_attention``, ``beam_select`` (``vector``). :func:`count` adds
other facts to the same count: ``("k4_dy", "copy")``, a K4 stage-1 launch
whose dy was copied to rows first, and ``("decode_graph", "replay" |
"capture")`` (``engine/captioner.py``). :func:`snapshot` returns the
count as a :class:`collections.Counter` (``after - before`` is what ran
between two snapshots); :func:`reset` clears it. A launch given a
``note`` (the decode attention's (R, K/V rows, n_valid, N, D), beam
select's (rows, V, values kept a row)) notes it under its kernel's name in
the store of ``utils/tracing.py``, which keeps notes only while a profiler
records.

A launch made while a CUDA graph is captured runs only at the graph's
replays: inside :func:`capturing` it is recorded for the capturer, not
counted or noted, and the capturer hands the records to :func:`replayed`
at each replay. A launch adds one count under a key its wrapper built
once; no span, no CUDA device query.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Iterator, List, Optional, Tuple

import torch

from virtex_tpu_torch.ops import _build
from virtex_tpu_torch.utils.tracing import note as _note

MAX_SMEM_BYTES = 227 * 1024  # shared memory one Hopper block can use

Key = Tuple[str, str]

_counts: "collections.Counter[Key]" = collections.Counter()
_captured: Optional[list] = None  # the launches of the graph being captured


def snapshot() -> "collections.Counter[Key]":
    """The launches and facts counted since import or the last reset."""
    return collections.Counter(_counts)


def reset() -> None:
    _counts.clear()


def count(key: Key, note=None) -> None:
    """Count one launch (or fact) under ``key`` and, given a ``note``, note
    it under its kernel's name; inside :func:`capturing`, record both for
    the capturer instead."""
    if _captured is not None:
        _captured.append((key, note))
        return
    _counts[key] += 1
    if note is not None:
        _note(key[0], note)


@contextlib.contextmanager
def capturing() -> Iterator[List[tuple]]:
    """Inside, launches are captured into a CUDA graph and not run: the
    list yielded collects them in place of the count and the notes."""
    global _captured
    outer, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = outer


def replayed(launches) -> None:
    """Count and note the launches :func:`capturing` recorded: one replay
    of the graph they were captured into."""
    for key, value in launches:
        count(key, value)


def launch(key: Key, entry: str, t: torch.Tensor, *args, note=None) -> None:
    """Launch the library's C function ``entry`` with ``args`` and the
    current stream of t's device, that device current; raise if it
    returns an error; count it under ``key``."""
    index = t.device.index
    fn = getattr(_build.library(), entry)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        _build.check(err, f"{key[0]} launch ({entry})")
    count(key, note)


def aligned_16(t: torch.Tensor) -> bool:
    """Whether a kernel can stage ``t`` (B, T, N, D), unit stride along D,
    with 16-byte loads: its base pointer and the strides of its B, T and N
    dimensions longer than 1 are multiples of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        stride * size % 16 == 0
        for n, stride in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def aligned_operand(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy where it is not aligned_16 (a
    contiguous view at an odd offset stays one under ``contiguous()``)."""
    return t if aligned_16(t) else t.clone(
        memory_format=torch.contiguous_format)
