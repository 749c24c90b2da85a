r"""
A checkout root of tiny cells, written into a temporary directory, for
the CPU tests: ResNet-50 at 64², a post-norm L1 H64 A4 F128 head, a
vocabulary of 300 and captions of up to 10 tokens; a train cell of 4
images a batch and a caption cell of 2 images, beam 3, 6 steps.
"""
from __future__ import annotations

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(PKG, *parts), encoding="utf-8") as f:
        return json.load(f)


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def tiny_config() -> dict:
    cfg = copy.deepcopy(_load("configs", "bicaptioning_R_50_L1_H1024.json"))
    c = cfg["config"]
    c["DATA"].update(IMAGE_CROP_SIZE=64, VOCAB_SIZE=300,
                     MAX_CAPTION_LENGTH=10)
    c["MODEL"]["TEXTUAL"]["NAME"] = "transdec_postnorm::L1_H64_A4_F128"
    c["MODEL"]["DECODER"].update(BEAM_SIZE=3, MAX_DECODING_STEPS=6)
    c["OPTIM"]["BATCH_SIZE"] = 4
    cfg["name"] = "tiny"
    return cfg


def write_root(root: str, limits=None) -> str:
    """A root holding ``BENCHMARK.json`` of the cells ``tiny.train`` and
    ``tiny.caption`` and their files; returns it."""
    with open(os.path.join(PKG, "..", "BENCHMARK.json"),
              encoding="utf-8") as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "test"},
        {"name": "tiny.caption", "config": "tiny", "traffic": "tiny_caption",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            train = m["name"].startswith("train") or ".train" in m["name"]
            m["workloads"] = ["tiny.train" if train else "tiny.caption"]
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    _dump(os.path.join(root, "portbench", "configs", "tiny.json"),
          tiny_config())
    train = _load("traffic", "train_synth_coco_lengths.json")
    train.update(caption_length_counts={"4": 1, "6": 1, "8": 1, "10": 1},
                 pool_batches=2, trace_units=1)
    caption = _load("traffic", "caption_beam_b256.json")
    caption.update(batch=2, pool_batches=2, trace_units=1)
    _dump(os.path.join(root, "portbench", "traffic", "tiny_train.json"),
          train)
    _dump(os.path.join(root, "portbench", "traffic", "tiny_caption.json"),
          caption)
    shutil.copytree(os.path.join(PKG, "metrics"),
                    os.path.join(root, "portbench", "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    limits = limits or {}
    _dump(os.path.join(root, "portbench", "limits", "tiny.train.json"),
          limits.get("train", {f"{k}_median_gap.{g}": 1.0
                               for k in ("grad", "change")
                               for g in ("visual", "textual",
                                         "backward_textual")}))
    _dump(os.path.join(root, "portbench", "limits", "tiny.caption.json"),
          limits.get("caption", {"caption_gap": 1.0}))
    return root
