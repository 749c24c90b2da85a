r"""
The harness on the CPU at a tiny size: what ``BENCHMARK.json`` names is
found by name, a new cell, mix, configuration or per-layer metric is a new
file and an entry, a run's result line has the contract's keys, and
``correct`` comes out false when the timed path is broken underneath
(the harness's look for a card skipped).
"""
from __future__ import annotations

import json
import os
import re

import pytest
import torch

from portbench import control, harness
from portbench.tests import tiny

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 4294967311
# Limits of the tiny cells: their sound runs read under 4e-3 (each group's
# median leaf), under 3e-3 (the textual heads' worst leaf) and 0.0 (caption
# gap), bf16 against fp32 on the CPU.
TINY_LIMITS = {
    "train": {**{f"{k}_median_gap.{g}": 0.05 for k in ("grad", "change")
                 for g in ("visual", "textual", "backward_textual")},
              **{f"{k}_worst_gap.{g}": 0.05 for k in ("grad", "change")
                 for g in ("textual", "backward_textual")}},
    "caption": {"caption_gap": 0.5}}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_every_name_has_its_files():
    b = bench()
    pkg = os.path.join(REPO, "portbench")
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    for w in b["workloads"]:
        with open(os.path.join(pkg, "traffic", f"{w['traffic']}.json"),
                  encoding="utf-8") as f:
            kind = json.load(f)["kind"]
        assert os.path.isfile(os.path.join(pkg, "kinds", f"{kind}.py"))
        assert os.path.isfile(os.path.join(pkg, "limits",
                                           f"{w['name']}.json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(pkg, "metrics",
                                           f"{m['name']}.py"))


def test_benchmark_json_keeps_the_contracts_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])
    for c in b["configs"]:
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in b["workloads"])


def _run(root, workload, trace=0, hook=None):
    return harness.run(["--workload", workload, "--seed", str(SEED),
                        "--seconds", "1", "--trace", str(trace)],
                       device="cpu", root=root, driver_hook=hook)


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.caption"])
def test_a_run_prints_the_contracts_keys(workload, tmp_path):
    root = tiny.write_root(str(tmp_path), TINY_LIMITS)
    out = _run(root, workload)
    assert out["correct"] is True
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    for check in out["checks"].values():
        assert check["value"] <= check["limit"]
    traced = _run(root, workload, trace=1)
    assert "busy_s" in traced["device"] and "breakdown" in traced
    assert all(m in {x["name"] for x in bench()["per_layer"]}
               for m in traced["metrics"])


def test_new_cell_mix_config_and_metric_are_files_and_entries(tmp_path):
    root = tiny.write_root(str(tmp_path), TINY_LIMITS)
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        b = json.load(f)
    cfg = tiny.tiny_config()
    cfg["config"]["DATA"]["VOCAB_SIZE"] = 200
    with open(os.path.join(pkg, "configs", "tiny2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pkg, "traffic", "tiny_train.json")) as f:
        mix = json.load(f)
    mix["caption_length_counts"] = {"10": 4}
    with open(os.path.join(pkg, "traffic", "tiny_train_long.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pkg, "limits", "tiny2.train.json"), "w") as f:
        json.dump(TINY_LIMITS["train"], f)
    with open(os.path.join(pkg, "metrics", "units_traced.train.py"),
              "w") as f:
        f.write("def read(trace):\n    return trace.units\n")
    b["configs"].append({"name": "tiny2", "source": "test", "reduced": [],
                         "file": "portbench/configs/tiny2.json", "why": "t"})
    b["workloads"].append({"name": "tiny2.train", "config": "tiny2",
                           "traffic": "tiny_train_long", "chips": 1,
                           "why": "t"})
    for m in b["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("tiny2.train")
    b["per_layer"].append({"name": "units_traced.train", "unit": "units",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "train_images_per_s",
                           "workloads": ["tiny2.train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    out = _run(root, "tiny2.train")
    assert out["correct"] and "train_images_per_s" in out["metrics"]
    traced = _run(root, "tiny2.train", trace=1)
    assert traced["metrics"]["units_traced.train"]["value"] >= 1


# -- faults of the timed path -------------------------------------------------
def _session_fault(patch):
    """A driver hook that applies ``patch(session)`` once the driver's
    session is built."""
    def hook(driver, run):
        plain = driver.Session.__init__

        def init(self, run_):
            plain(self, run_)
            patch(self)
        driver.Session = type("Broken", (driver.Session,),
                              {"__init__": init})
    return hook


def _unchanged_state(s):
    s.optimizer.step = lambda: torch.zeros(())


def _half_batch(s):
    plain = s.step_fn

    def step_fn(batch):
        return plain({k: v[:v.shape[0] // 2] for k, v in batch.items()})
    s.step_fn = step_fn


def _altered_token(s):
    plain = s.caption_fn

    def caption_fn(images, generator=None):
        out = plain(images).clone()
        out[0, 2] = (out[0, 2] + 1) % 300
        return out
    s.caption_fn = caption_fn


def _unchanged_decode_state(s):
    textual = s.model.textual
    plain = textual.decode_step

    def decode_step(token, position, caches):
        kept = [{k: v.clone() for k, v in c.items()} for c in caches]
        logits, _ = plain(token, position, caches)
        return logits, kept
    textual.decode_step = decode_step


def _half_captions(s):
    plain = s.caption_fn

    def caption_fn(images, generator=None):
        half = plain(images[:images.shape[0] // 2])
        return torch.cat([half, half])[:images.shape[0]]
    s.caption_fn = caption_fn


@pytest.mark.parametrize("workload,patch", [
    ("tiny.train", _unchanged_state),
    ("tiny.train", _half_batch),
    ("tiny.train", control.textual_lr),
    ("tiny.train", control.FAULTS["self_attention_dv"]),
    ("tiny.caption", _altered_token),
    ("tiny.caption", _unchanged_decode_state),
    ("tiny.caption", _half_captions),
])
def test_a_broken_timed_path_is_not_correct(workload, patch, tmp_path):
    root = tiny.write_root(str(tmp_path), TINY_LIMITS)
    out = _run(root, workload, hook=_session_fault(patch))
    assert out["correct"] is False, out["checks"]
