r"""
The real-data closure of the port, and its synthetic rehearsal:

    tokenizer self-check -> checkpoint -> feature bit-check
    -> eval_captioning (CIDEr/SPICE) -> clf_voc07 (VOC07 mAP)
    -> clf_linear (IN-1k top-1)

Counterpart of ``scripts/reproduce_parity.sh``: the same steps, flags and
published values (the reference's model zoo page: VOC07 mAP 88.7 and IN-1k
top-1 53.8 for ``bicaptioning_R_50_L1_H2048``; the paper's best model
~94 CIDEr and ~18.5 SPICE). Each CLI's ``main`` runs in this process.

- ``--mode synthetic`` (the default) writes its own fixtures into
  ``--workdir``: a COCO-2017 tree, a VOC2007 tree and an ImageNet folder
  tree of random JPEGs (the port's encoder, ``DataPlane.encode_jpeg``) and
  a BPE tokenizer (``train_tokenizer``); then the tokenizer self-check
  (golden written, then verified), the binary SentencePiece export checked
  against the same golden, 4 pretraining iterations of a tiny model, the
  checkpoint loaded through ``model_zoo.get`` (the port's checkpoint is
  the reference ``.pth``, so no converter runs), the feature bit-check on
  ``--device`` written and then held on the CPU, and the three scoring
  CLIs.
- ``--mode real`` needs ``--coco-root`` and ``--zoo-dir`` (a directory of
  the published ``.pth`` files, or a URL that ``model_zoo.fetch``
  downloads): the tokenizer self-check of ``DATA.TOKENIZER_MODEL`` against
  ``tests/fixtures/coco_10k_tokenizer_golden.json``, the published
  checkpoint through ``model_zoo.get``, the bit-check (against
  ``--bitcheck-reference``, the JAX package's npz from
  ``tests/torch_bitcheck_jax.py``, if given; else the card against the
  CPU), and each score beside its published value.

    python -m virtex_tpu_torch.scripts.reproduce_parity [--device cpu]
    python -m virtex_tpu_torch.scripts.reproduce_parity --mode real \
        --coco-root /data/coco --voc-root /data/VOC2007 \
        --imagenet-root /data/imagenet --zoo-dir <dir-or-url> \
        [--bitcheck-reference jax.npz]

Exit 0 when every step passed, 1 when one failed, 2 on refused
arguments.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from virtex_tpu_torch.config import Config
from virtex_tpu_torch.data.tokenizers import (
    export_sentencepiece_model,
    train_tokenizer,
)
from virtex_tpu_torch.engine.checkpointing import read_checkpoint
from virtex_tpu_torch.model_zoo import model_zoo
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.scripts import (
    clf_linear,
    clf_voc07,
    eval_captioning,
    feature_bitcheck,
    pretrain_virtex,
    tokenizer_selfcheck,
)
from virtex_tpu_torch.utils.common import common_parser

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The flagship checkpoint of the closure; VOC and IN-1k run on it too.
MODEL_NAME = "bicaptioning_R_50_L1_H2048"
MODEL_CONFIG = "task_ablations/bicaptioning_R_50_L1_H2048.yaml"
# Published values (the reference's model zoo page; the paper's best).
EXPECT_VOC = {MODEL_NAME: 88.7}
EXPECT_IN1K = {MODEL_NAME: 53.8}
EXPECT_CIDER = "~94 (paper, best model)"
EXPECT_SPICE = "~18.5 (paper, best model)"
TOKENIZER_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                                "coco_10k_tokenizer_golden.json")
# Synthetic mode: the pretraining config cut to a tiny model.
SYNTH_CONFIG = os.path.join(REPO, "configs",
                            "_base_bicaptioning_R_50_L1_H1024.yaml")
SYNTH_CAPTIONS = [
    "a man riding a wave on top of a surfboard",
    "a cat sitting on the left side of a red couch",
    "two dogs playing with a frisbee in the park",
    "a group of people standing around a kitchen",
    "a plate of food with broccoli and rice on the right",
    "a red bus driving down a city street",
]
SYNTH_COCO_IMAGES, SYNTH_VOC_IMAGES, SYNTH_VOC_CLASSES = 16, 10, 4
SYNTH_IMAGENET_CLASSES, SYNTH_IMAGENET_PER_CLASS = 3, 4
SYNTH_ITERATIONS, SYNTH_BATCH, SYNTH_WORKERS = 4, 8, 2


class StepFailed(RuntimeError):
    """A step of the closure did not pass."""


def say(msg: str) -> None:
    print(f"\n=== {msg}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The port's real-data parity "
                                 "closure, or its synthetic rehearsal.")
    ap.add_argument("--mode", choices=("synthetic", "real"),
                    default="synthetic")
    ap.add_argument("--coco-root", default="")
    ap.add_argument("--voc-root", default="")
    ap.add_argument("--imagenet-root", default="")
    ap.add_argument("--zoo-dir", default=os.environ.get(
        model_zoo.ZOO_DIR_ENV, ""),
        help="directory of the published .pth files, or a base URL")
    ap.add_argument("--workdir", default=os.environ.get("WORKDIR") or
                    os.path.join(tempfile.gettempdir(), "virtex_parity"))
    ap.add_argument("--bitcheck-reference", default=None,
                    metavar="JAX.npz",
                    help="real mode: hold the bit-check to the JAX "
                         "package's results on the same .pth")
    ap.add_argument("--device", default="cuda",
                    help="Device to run on (default: the card); 'cpu' runs "
                         "on the CPU.")
    return ap


# -- fixtures ----------------------------------------------------------------
def _jpeg(plane: DataPlane, path: str, rng, size) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(plane.encode_jpeg(rng.randint(0, 255, (*size, 3),
                                              dtype=np.uint8)))


def write_coco(plane: DataPlane, root: str, n_images: int,
               size=(120, 160), seed: int = 0) -> None:
    """A COCO-2017 tree: {train,val}2017 JPEGs, two captions each, and one
    instance (categories 1, 18, 90) each."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in ("train", "val"):
        images, captions, instances = [], [], []
        for i in range(n_images):
            name = f"{i + 1:012d}.jpg"
            _jpeg(plane, os.path.join(root, f"{split}2017", name), rng, size)
            images.append({"id": i + 1, "file_name": name,
                           "height": size[0], "width": size[1]})
            captions += [{"id": len(captions) + 1, "image_id": i + 1,
                          "caption": SYNTH_CAPTIONS[(i + j)
                                                    % len(SYNTH_CAPTIONS)]}
                         for j in range(2)]
            instances.append({"id": i + 1, "image_id": i + 1,
                              "category_id": (1, 18, 90)[i % 3],
                              "bbox": [0, 0, 10, 10]})
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": captions}, f)
        with open(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": instances,
                       "categories": [{"id": c, "name": f"cat{c}"}
                                      for c in (1, 18, 90)]}, f)


def write_voc07(plane: DataPlane, root: str, n_images: int, n_classes: int,
                size=(100, 120), seed: int = 1) -> None:
    """A VOC2007 tree: JPEGImages and one-vs-all listings of trainval and
    test, each class present, absent and difficult in turn."""
    rng = np.random.RandomState(seed)
    names = [f"{i:06d}" for i in range(n_images)]
    for name in names:
        _jpeg(plane, os.path.join(root, "JPEGImages", f"{name}.jpg"), rng,
              size)
    os.makedirs(os.path.join(root, "ImageSets", "Main"), exist_ok=True)
    for split in ("trainval", "test"):
        for c in range(n_classes):
            with open(os.path.join(root, "ImageSets", "Main",
                                   f"class{c}_{split}.txt"), "w") as f:
                f.writelines(f"{name} {[1, -1, -1, 0][(i + c) % 4]}\n"
                             for i, name in enumerate(names))


def write_imagenet(plane: DataPlane, root: str, n_classes: int,
                   per_class: int, size=(80, 90), seed: int = 2) -> None:
    """An ImageNet folder tree: {train,val}/<wnid>/*.JPEG."""
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        for c in range(n_classes):
            for i in range(per_class):
                _jpeg(plane, os.path.join(root, split, f"n{c:08d}",
                                          f"img_{i}.JPEG"), rng, size)


# -- steps -------------------------------------------------------------------
def run_step(summary: Dict[str, Any], name: str, fn: Callable[[], Any]):
    """Run one step, timed; a step returning a nonzero int failed."""
    t0 = time.perf_counter()
    out = fn()
    summary["seconds"][name] = time.perf_counter() - t0
    if isinstance(out, int) and not isinstance(out, bool) and out != 0:
        raise StepFailed(f"{name} exited {out}")
    return out


def cli(module, argv: List[str], parser=None) -> Dict[str, Any]:
    """One of the port's CLIs, in this process."""
    return module.main((parser or module.build_parser()).parse_args(argv))


def check_loads(config: str, overrides: List[str], pth: str,
                device: str) -> int:
    """The checkpoint loads through ``model_zoo.get`` in full: every entry
    of the model equals the file's (``num_batches_tracked`` may be
    absent). Returns the number of entries."""
    model, _ = model_zoo.get(config, pretrained=True, checkpoint_path=pth,
                             overrides=overrides, device=device)
    problems = feature_bitcheck.checkpoint_mismatch(pth, model)
    saved = read_checkpoint(pth)
    saved = saved.get("model", saved)
    problems += [f"value {k}" for k, v in model.state_dict().items()
                 if k in saved and not torch.equal(v.cpu(), saved[k])]
    if problems:
        raise StepFailed(f"{pth} does not load in full through "
                         f"model_zoo.get: {problems[:10]}")
    print(f"{pth}: {len(saved)} entries loaded through model_zoo.get, "
          "equal to the file's")
    return 0


def bitcheck(config: str, overrides: List[str], pth: str, device: str,
             npz: str, reference: Optional[str] = None) -> int:
    """Against ``reference`` if given; else ``device`` written to ``npz``
    and the CPU held to it."""
    common = ["--config", config, "--checkpoint-path", pth]
    if overrides:
        common += ["--config-override", *overrides]
    if reference:
        return feature_bitcheck.main(common + ["--device", device,
                                               "--against", reference])
    rc = feature_bitcheck.main(common + ["--device", device, "--write", npz])
    return rc or feature_bitcheck.main(common + ["--device", "cpu",
                                                 "--against", npz])


def synthetic(args) -> Dict[str, Any]:
    """The rehearsal; returns each step's seconds and the scores."""
    w, device = os.path.abspath(args.workdir), args.device
    os.makedirs(w, exist_ok=True)
    summary: Dict[str, Any] = {"seconds": {}}
    coco, voc = os.path.join(w, "coco"), os.path.join(w, "VOC2007")
    imagenet, tok = os.path.join(w, "imagenet"), os.path.join(w, "tok.model")

    say(f"[synthetic] building fixtures in {w}")

    def fixtures():
        plane = DataPlane(decoder_for(device), threads=SYNTH_WORKERS)
        write_coco(plane, coco, SYNTH_COCO_IMAGES)
        write_voc07(plane, voc, SYNTH_VOC_IMAGES, SYNTH_VOC_CLASSES)
        write_imagenet(plane, imagenet, SYNTH_IMAGENET_CLASSES,
                       SYNTH_IMAGENET_PER_CLASS)
        train_tokenizer(SYNTH_CAPTIONS * 40, tok, vocab_size=300)
    run_step(summary, "fixtures", fixtures)
    tiny = ["DATA.TOKENIZER_MODEL", tok,
            "MODEL.VISUAL.NAME", "torchvision::resnet18",
            "MODEL.VISUAL.FEATURE_SIZE", "512",
            "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H128_A4_F256",
            "DATA.IMAGE_CROP_SIZE", "64"]

    say("[synthetic] tokenizer self-check rehearsal (golden write -> verify)")
    golden = os.path.join(w, "tok_golden.json")
    run_step(summary, "tokenizer_selfcheck", lambda: tokenizer_selfcheck.main(
        ["--model", tok, "--golden", golden, "--write-golden"])
        or tokenizer_selfcheck.main(["--model", tok, "--golden", golden]))

    say("[synthetic] binary SentencePiece export -> self-check against the "
        "JSON's golden")

    def sp_model():
        export_sentencepiece_model(tok, os.path.join(w, "tok.sp.model"))
        with open(golden) as f:
            entries = json.load(f)
        entries["model"] = "tok.sp.model"
        with open(os.path.join(w, "tok_sp_golden.json"), "w") as f:
            json.dump(entries, f, indent=1)
        return tokenizer_selfcheck.main(
            ["--model", os.path.join(w, "tok.sp.model"),
             "--golden", os.path.join(w, "tok_sp_golden.json")])
    run_step(summary, "sp_model", sp_model)

    say("[synthetic] short pretrain -> checkpoint (stands in for the "
        "published .pth)")
    flags = ["--cpu-workers", str(SYNTH_WORKERS), "--device", device]
    summary["pretrain"] = run_step(summary, "pretrain", lambda: cli(
        pretrain_virtex, [
            "--config", SYNTH_CONFIG,
            "--serialization-dir", os.path.join(w, "pretrain"),
            "--checkpoint-every", str(SYNTH_ITERATIONS), *flags,
            "--config-override", "OPTIM.NUM_ITERATIONS", str(SYNTH_ITERATIONS),
            "OPTIM.BATCH_SIZE", str(SYNTH_BATCH), "DATA.ROOT", coco, *tiny],
        common_parser()))
    pth = os.path.join(w, "pretrain", f"checkpoint_{SYNTH_ITERATIONS}.pth")

    say("[synthetic] the checkpoint loads through model_zoo.get")
    run_step(summary, "load", lambda: check_loads(SYNTH_CONFIG, tiny, pth,
                                                  device))

    say(f"[synthetic] feature bit-check ({device} written, the CPU held to "
        "it, same .pth)")
    run_step(summary, "bitcheck", lambda: bitcheck(
        SYNTH_CONFIG, tiny, pth, device,
        os.path.join(w, f"bitcheck_{device.replace(':', '')}.npz")))

    say("[synthetic] eval_captioning --calc-metrics (CIDEr on fixture COCO "
        "val)")
    summary["eval_captioning"] = run_step(summary, "eval_captioning",
                                          lambda: cli(eval_captioning, [
        "--config", SYNTH_CONFIG,
        "--serialization-dir", os.path.join(w, "evalcap"),
        "--checkpoint-path", pth, "--batch-size", str(SYNTH_BATCH),
        "--output", os.path.join(w, "preds.json"), "--calc-metrics", *flags,
        "--config-override", "DATA.ROOT", coco, *tiny,
        "MODEL.DECODER.MAX_DECODING_STEPS", "10"]))

    say("[synthetic] clf_voc07 (SVM mAP through the real CLI)")
    summary["clf_voc07"] = run_step(summary, "clf_voc07", lambda: cli(
        clf_voc07, [
            "--config", SYNTH_CONFIG,
            "--down-config", os.path.join(REPO, "configs", "downstream",
                                          "voc07_clf.yaml"),
            "--serialization-dir", os.path.join(w, "voc07"),
            "--weight-init", "virtex", "--checkpoint-path", pth, *flags,
            "--config-override", *tiny,
            "--down-config-override", "DATA.ROOT", voc,
            "DATA.IMAGE_CROP_SIZE", "64"]))

    say("[synthetic] clf_linear (linear probe through the real CLI)")
    summary["clf_linear"] = run_step(summary, "clf_linear", lambda: cli(
        clf_linear, [
            "--config", SYNTH_CONFIG,
            "--down-config", os.path.join(REPO, "configs", "downstream",
                                          "imagenet_clf.yaml"),
            "--serialization-dir", os.path.join(w, "linear"),
            "--weight-init", "virtex", "--checkpoint-path", pth, *flags,
            "--config-override", *tiny,
            "--down-config-override", "DATA.ROOT", imagenet,
            "DATA.IMAGE_CROP_SIZE", "64",
            "OPTIM.NUM_ITERATIONS", str(SYNTH_ITERATIONS),
            "OPTIM.BATCH_SIZE", str(SYNTH_BATCH), "OPTIM.WARMUP_STEPS", "2"]))

    say("[synthetic] rehearsal complete — every closure step ran.")
    print("Real invocation: python -m virtex_tpu_torch.scripts."
          "reproduce_parity --mode real \\\n  --coco-root /data/coco "
          "--voc-root /data/VOC2007 \\\n  --imagenet-root /data/imagenet "
          "--zoo-dir <dir-or-url> [--bitcheck-reference jax.npz]")
    return summary


def real(args) -> Dict[str, Any]:
    """The closure on real data and the published checkpoint."""
    w, device = os.path.abspath(args.workdir), args.device
    os.makedirs(w, exist_ok=True)
    summary: Dict[str, Any] = {"seconds": {}}
    config = os.path.join(REPO, "configs", MODEL_CONFIG)
    flags = ["--device", device]

    say("[0/5] tokenizer self-check (the .model reader against the pinned "
        "golden)")
    tokmodel = Config(config).DATA.TOKENIZER_MODEL
    run_step(summary, "tokenizer_selfcheck", lambda: tokenizer_selfcheck.main(
        ["--model", tokmodel, "--golden", TOKENIZER_GOLDEN]))

    say(f"[1/5] fetch {MODEL_NAME} and load it through model_zoo.get")
    zoo = args.zoo_dir
    pth = (model_zoo.fetch(f"{zoo.rstrip('/')}/{MODEL_NAME}.pth")
           if zoo.startswith(("http://", "https://", "file://"))
           else os.path.join(zoo, f"{MODEL_NAME}.pth"))
    run_step(summary, "load", lambda: check_loads(config, [], pth, device))

    say("[2/5] feature bit-check on the published weights")
    run_step(summary, "bitcheck", lambda: bitcheck(
        config, [], pth, device, os.path.join(w, "bitcheck.npz"),
        args.bitcheck_reference))

    say(f"[3/5] eval_captioning on COCO val2017 (expect CIDEr "
        f"{EXPECT_CIDER}, SPICE {EXPECT_SPICE})")
    summary["eval_captioning"] = run_step(summary, "eval_captioning",
                                          lambda: cli(eval_captioning, [
        "--config", config, "--serialization-dir", os.path.join(w, "evalcap"),
        "--checkpoint-path", pth, "--batch-size", "32",
        "--output", os.path.join(w, "preds.json"), "--calc-metrics", *flags,
        "--config-override", "DATA.ROOT", args.coco_root]))
    metrics = summary["eval_captioning"].get("metrics", {})
    print(f"CIDEr {metrics.get('CIDEr')} (expect {EXPECT_CIDER}), SPICE "
          f"{metrics.get('SPICE')} (expect {EXPECT_SPICE})")

    for step, root, flag, module, down, expect, key in (
            ("[4/5] clf_voc07", args.voc_root, "--voc-root", clf_voc07,
             "voc07_clf.yaml", EXPECT_VOC[MODEL_NAME], "mAP"),
            ("[5/5] clf_linear IN-1k", args.imagenet_root, "--imagenet-root",
             clf_linear, "imagenet_clf.yaml", EXPECT_IN1K[MODEL_NAME],
             "value")):
        say(f"{step} (expect {expect})")
        if not root:
            raise StepFailed(f"{step} needs {flag}")
        name = module.__name__.rsplit(".", 1)[-1]
        summary[name] = run_step(summary, name, lambda: cli(module, [
            "--config", config,
            "--down-config", os.path.join(REPO, "configs", "downstream",
                                          down),
            "--serialization-dir", os.path.join(w, name),
            "--weight-init", "virtex", "--checkpoint-path", pth, *flags,
            "--down-config-override", "DATA.ROOT", root]))
        print(f"{step}: {summary[name].get(key)} (expect {expect})")
    say("done — compare the three numbers above with the expected values.")
    return summary


def rehearse(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse, refuse or run; returns the run's summary. Raises
    :class:`StepFailed` when a step fails and ``SystemExit(2)`` on refused
    arguments."""
    args = build_parser().parse_args(argv)
    if args.mode == "real" and not (args.coco_root and args.zoo_dir):
        print("--mode real needs --coco-root and --zoo-dir")
        raise SystemExit(2)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    return (real if args.mode == "real" else synthetic)(args)


def main(argv: Optional[List[str]] = None) -> int:
    try:
        rehearse(argv)
    except StepFailed as e:
        print(f"reproduce_parity: FAIL — {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
