r"""
The reader of ``decode_graph_share.caption`` on the program's notes: the
share of the stretch's decode steps noted ``"replay"``; nothing to read
off a caption stretch, without notes, or for a program without the store.
"""
from __future__ import annotations

import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, trace
from portbench.tests.test_pb_harness import REPO
from virtex_tpu_torch.utils import tracing

METRIC = "decode_graph_share.caption"


def _noted(*kinds):
    with tracing.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]), \
            tracing.span("caption"):
        for kind in kinds:
            tracing.note("decode_graph", kind)


def _read(kind="caption"):
    return harness.read_metric(METRIC, trace.Trace(kind, 1, 1, 1.0, [], {}),
                               REPO)


def test_an_entry_of_the_benchmark_for_the_caption_cell():
    (entry,) = [m for m in harness.load_json(
        f"{REPO}/BENCHMARK.json")["per_layer"] if m["name"] == METRIC]
    assert entry["workloads"] == ["caption.r50h2048.beam"]
    assert entry["moves"] == "caption_images_per_s"


@pytest.mark.parametrize("kinds, share", [
    (["replay"] * 30, 100.0),
    (["eager"] * 30, 0.0),
    (["eager", "replay", "replay", "replay"], 75.0)])
def test_reads_the_share_of_replayed_steps(kinds, share):
    _noted(*kinds)
    assert _read() == pytest.approx(share)


def test_reads_nothing_where_it_should():
    _noted()
    assert _read() is None                   # no notes
    _noted("replay")
    assert _read("train") is None


def test_a_program_without_notes_reads_nothing(monkeypatch):
    _noted("replay")
    monkeypatch.delattr(tracing, "notes")
    assert _read() is None
    monkeypatch.setitem(sys.modules, "virtex_tpu_torch.utils.tracing", None)
    assert _read() is None
