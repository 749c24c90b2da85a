r"""
The readers of the program's own spans (``portbench/program_spans.py``) on
the CPU at a tiny size: a traced caption run reads the search loop's host
syncs and their host ms, the device-ms readers find nothing off CUDA, and
every reader returns None for a stretch that is not the store's (another
kind, another number of units) or a program without spans.
"""
from __future__ import annotations

import os
import sys

import pytest

from portbench import harness, trace
from portbench.tests import tiny
from portbench.tests.test_pb_harness import REPO, TINY_LIMITS, _run, bench

READERS = {"train": ("bn_fwd_ms.train", "backward_ms.train"),
           "caption": ("decode_ms.caption", "beam_select_ms.caption",
                       "beam_reorder_ms.caption", "search_syncs.caption",
                       "sync_wait_ms.caption")}
DEVICE_MS = {"bn_fwd_ms.train", "backward_ms.train", "decode_ms.caption",
             "beam_select_ms.caption", "beam_reorder_ms.caption"}


def _read(name, stretch):
    return harness.read_metric(name, stretch, REPO)


def test_every_reader_is_an_entry_of_the_benchmark():
    entries = {m["name"]: m for m in bench()["per_layer"]}
    for kind, names in READERS.items():
        for name in names:
            assert entries[name]["source"] == "program_span"
            assert os.path.isfile(os.path.join(REPO, "portbench", "metrics",
                                               f"{name}.py"))


@pytest.mark.parametrize("kind", ["train", "caption"])
def test_a_tiny_traced_run_reads_the_programs_spans(kind, tmp_path):
    root = tiny.write_root(str(tmp_path), TINY_LIMITS)
    out = _run(root, f"tiny.{kind}", trace=1)
    assert out["correct"] is True
    for name in READERS[kind]:
        # off CUDA the spans hold no events: no device ms
        assert (name in out["metrics"]) == (name not in DEVICE_MS), name
    if kind == "caption":
        steps = tiny.tiny_config()["config"]["MODEL"]["DECODER"][
            "MAX_DECODING_STEPS"]
        syncs = out["metrics"]["search_syncs.caption"]
        assert syncs == {"value": steps - 1, "unit": "syncs"}
        assert out["metrics"]["sync_wait_ms.caption"]["value"] > 0

    # The store now holds this run's traced stretch of one unit.
    units = 1
    for name in READERS[kind]:
        here = _read(name, trace.Trace(kind, units, 1, 1.0, [], {}))
        assert (here is None) == (name in DEVICE_MS), name
        assert _read(name, trace.Trace(kind, units + 1, 1, 1.0, [],
                                       {})) is None, name
        other = "train" if kind == "caption" else "caption"
        assert _read(name, trace.Trace(other, units, 1, 1.0, [],
                                       {})) is None, name
        assert _read(name, trace.Trace(kind, 0, 0, 1.0, [], {})) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "virtex_tpu_torch.utils.tracing", None)
    for kind, names in READERS.items():
        for name in names:
            assert _read(name, trace.Trace(kind, 1, 1, 1.0, [], {})) is None
