r"""
The decode attention's bound (``portbench/decode_yardstick.py``) against
counts worked by hand, and its roofline reader on hand-made traces: the
shapes come from the program's tracing store, the time from the kernel's
launches; nothing to read off a caption stretch, without notes, without
the kernel, for launches and notes that differ in number, or for a
program without the store.
"""
from __future__ import annotations

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import decode_yardstick as dy, harness, trace, yardstick as y
from portbench.tests.test_pb_harness import REPO
from virtex_tpu_torch.utils import tracing

METRIC = "decode_attention_roofline.caption"
KERNEL = "void (anonymous namespace)::decode_attention_kernel<64, 8>(Args)"


def test_bound_by_hand():
    # 10 query rows, 2 K/V rows (5 rows each) of 3 valid positions, 2 heads
    # of 8, bf16: q and the output 320 bytes each, K and V 192 each.
    t, by = dy.decode_attention_bound(10, 2, 3, 2, 8)
    assert by == "bytes"
    assert t == pytest.approx((2 * 320 + 2 * 192) / y.HBM_BYTES_PER_S)
    # The caption cell's cross launch: the K/V once per image, not per beam.
    cross = dy.decode_attention_bound(1280, 256, 49, 32, 64)[0]
    assert cross == pytest.approx(
        (2 * 1280 * 32 * 64 * 2 + 2 * 256 * 49 * 32 * 64 * 2)
        / y.HBM_BYTES_PER_S)
    assert dy.decode_attention_bound_s([(10, 2, 3, 2, 8)] * 3) == \
        pytest.approx(3 * t)


def _stretch(kind="caption", launches=2, name=KERNEL):
    events = [{"cat": "kernel", "name": name, "ts": 10.0 * i, "dur": 4.0,
               "tid": 1, "args": {"correlation": i}}
              for i in range(launches)]
    events.append({"cat": "kernel", "name": "gemm", "ts": 100.0,
                   "dur": 50.0, "tid": 1, "args": {"correlation": 99}})
    return trace.Trace(kind, 1, 1, 1.0, events, {})


def _noted(*shapes):
    with tracing.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for s in shapes:
            tracing.note("decode_attention", s)


def _read(stretch):
    return harness.read_metric(METRIC, stretch, REPO)


def test_reader_divides_the_noted_bounds_by_the_kernels_time():
    shapes = [(1280, 256, 49, 32, 64), (1280, 1280, 7, 32, 64)]
    _noted(*shapes)
    got = _read(_stretch())
    assert got == pytest.approx(100 * dy.decode_attention_bound_s(shapes)
                                / 8e-6)


def test_reader_finds_nothing_where_it_should():
    _noted((8, 8, 1, 1, 64))
    assert _read(_stretch("train", launches=1)) is None
    assert _read(_stretch(launches=2)) is None         # 2 launches, 1 note
    assert _read(_stretch(launches=1, name="gemv")) is None
    _noted()
    assert _read(_stretch(launches=0)) is None


def test_a_program_without_notes_reads_nothing(monkeypatch):
    _noted((8, 8, 1, 1, 64))
    monkeypatch.delattr(tracing, "notes")
    assert _read(_stretch(launches=1)) is None
    monkeypatch.setitem(sys.modules, "virtex_tpu_torch.utils.tracing", None)
    assert _read(_stretch(launches=1)) is None
