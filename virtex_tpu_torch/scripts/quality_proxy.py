r"""
The port's end-to-end learning proof: train on a synthetic COCO whose
captions a model can learn, then score through the CLIs a user runs.

Counterpart of the JAX package's ``tests/quality_proxy_smoke.py``
(``--mode proxy``) and ``tests/overfit_smoke.py`` (``--mode overfit``):

- ``--mode proxy`` writes the learnable COCO (:func:`make_learnable_coco`:
  the colour of an image decides its caption; 240 train and 48 val
  images), trains a 120-piece tokenizer on its captions, runs
  ``pretrain_virtex`` with the JAX proxy's overrides (resnet18 at 128²,
  ``transdec_postnorm::L1_H128_A4_F512``, batch 32, AdamW at 1e-3 without
  Lookahead, warmup 40; ``--iterations`` 400, ``--accum`` 1), then
  ``eval_captioning --calc-metrics`` on its last checkpoint twice: by beam
  search and by nucleus sampling. The last line is one JSON object with
  the JAX script's keys; the run passes when beam CIDEr ≥ 100 and nucleus
  CIDEr ≥ 80. ``--width full`` runs the same at the flagship's widths
  (``configs/_base_bicaptioning_R_50_L1_H1024.yaml``: R-50 at 224², L1
  H1024 A16 F4096, bf16, dropout 0.1) on 512 train images of 256², batch
  256 in two micro-steps, 100 iterations unless ``--iterations`` says
  otherwise.
- ``--mode overfit`` trains through the engine API (``make_train_step``,
  ``TrainState``) on one fixed batch: the 8 random images of the
  rehearsal's COCO (:func:`reproduce_parity.write_coco`), each with the
  caption a ``RandomState(0)`` draw picks; resnet18 at 64²,
  ``L1_H128_A4_F256``, dropout 0, captions of 16 tokens, AdamW, 300
  steps. Then beam search with ``prefix_mode="sos"`` (SOS kept at position
  0, as in training) must give back at least 6 of the 8 captions exactly,
  and the last loss must be under 1.0.

``--config-override`` pairs go after the recipe's (a smaller run on the
CPU). The CLIs' ``main`` run in this process. Everything runs on the card
unless ``--device cpu`` is passed; nothing falls back to the CPU. Exit 0
when the gates pass, 1 when one misses.

    python -m virtex_tpu_torch.scripts.quality_proxy --accum 2
    python -m virtex_tpu_torch.scripts.quality_proxy --mode overfit
    python -m virtex_tpu_torch.scripts.quality_proxy --width full
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.data.tokenizers import train_tokenizer
from virtex_tpu_torch.engine.captioner import (
    decode_predictions,
    make_caption_fn,
)
from virtex_tpu_torch.engine.train_state import TrainState, step_seed
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    OptimizerFactory,
    PretrainingDatasetFactory,
    PretrainingModelFactory,
    TokenizerFactory,
)
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.parallel import shard_batch
from virtex_tpu_torch.scripts import eval_captioning, pretrain_virtex
from virtex_tpu_torch.scripts.reproduce_parity import (
    SYNTH_CAPTIONS,
    write_coco,
)
from virtex_tpu_torch.utils.common import common_parser

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (BGR base colour, caption), the JAX fixture's table
# (tests/utils_fixtures.py LEARNABLE_CLASSES): colours far apart, so that
# colour jitter cannot cross classes, and no left/right words, which the
# paired flip would swap.
LEARNABLE_CLASSES = [
    ((40, 40, 220), "a bright red ball on the table"),
    ((60, 200, 60), "green grass covers the field"),
    ((220, 80, 40), "a deep blue ocean under the sky"),
    ((40, 220, 220), "a yellow taxi waits at the corner"),
    ((200, 60, 200), "purple flowers bloom in the garden"),
    ((210, 210, 60), "a cyan sign hangs above the door"),
]
NOISE = 25          # each pixel's offset from its class colour, uniform
PROXY_VOCAB = 120   # pieces of the proxy's tokenizer,
TOKENIZER_REPEATS = 50  # trained on the six captions this many times over
# The JAX proxy's gates: random captions score ~0 CIDEr, a learnt mapping
# several hundred; nucleus sampling draws, so its bar is lower.
BEAM_CIDER_GATE, NUCLEUS_CIDER_GATE = 100.0, 80.0
EVAL_BATCH = 16
LOG_EVERY = 20      # iterations between logged losses (each a host sync)
# tests/overfit_smoke.py: 8 images, 300 steps, its gates.
OVERFIT_IMAGES, OVERFIT_STEPS, OVERFIT_LOG_EVERY = 8, 300, 50
OVERFIT_VOCAB, OVERFIT_REPEATS = 300, 40
OVERFIT_LOSS_GATE, OVERFIT_MATCH_GATE = 1.0, 6
FLAGSHIP_CONFIG = os.path.join(REPO, "configs",
                               "_base_bicaptioning_R_50_L1_H1024.yaml")
# Each width's config file (None: the defaults), train images (the
# loader needs a batch's worth) and image side, iterations and
# accumulation unless the flags say otherwise, and the overrides that make
# it (the JAX proxy's, word for word, for "proxy").
WIDTHS: Dict[str, Dict[str, Any]] = {
    "proxy": {"config": None, "train": 240, "image": 160, "iterations": 400,
              "accum": 1,
              "model": ["DATA.IMAGE_CROP_SIZE", "128",
                        "MODEL.NAME", "bicaptioning",
                        "MODEL.VISUAL.NAME", "torchvision::resnet18",
                        "MODEL.VISUAL.FEATURE_SIZE", "512",
                        "MODEL.TEXTUAL.NAME",
                        "transdec_postnorm::L1_H128_A4_F512",
                        "OPTIM.BATCH_SIZE", "32"]},
    "full": {"config": FLAGSHIP_CONFIG, "train": 512, "image": 256,
             "iterations": 100, "accum": 2,
             "model": ["MODEL.NAME", "bicaptioning",
                       "OPTIM.BATCH_SIZE", "256"]},
}


def make_learnable_coco(plane: DataPlane, root: str, n_train: int = 240,
                        n_val: int = 48, size=(160, 160), seed: int = 0
                        ) -> str:
    """A COCO-2017 tree whose captions are a function of the image's
    colour: image i of a split has class i mod 6, its colour plus uniform
    noise in [−NOISE, NOISE], one caption. The JAX fixture's draws, JSON
    and file names (``tests/utils_fixtures.py make_learnable_coco``); the
    JPEGs come from the port's encoder, given the colour as RGB."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split, n_images in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, f"{split}2017")
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        for i in range(n_images):
            color, caption = LEARNABLE_CLASSES[i % len(LEARNABLE_CLASSES)]
            noise = rng.randint(-NOISE, NOISE + 1, (*size, 3))
            bgr = np.clip(np.asarray(color, np.int16) + noise, 0, 255)
            fname = f"{i + 1:012d}.jpg"
            with open(os.path.join(img_dir, fname), "wb") as f:
                f.write(plane.encode_jpeg(bgr[..., ::-1].astype(np.uint8)))
            images.append({"id": i + 1, "file_name": fname,
                           "height": size[0], "width": size[1]})
            annotations.append({"id": i + 1, "image_id": i + 1,
                                "caption": caption})
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return root


def proxy_overrides(root: str, width: str, iterations: int,
                    accum: int) -> List[str]:
    """The pretraining overrides of ``width``: the data, the model, then
    the JAX proxy's optimizer (AdamW learns the colour → caption mapping
    in 400 iterations where the default SGD does not)."""
    return ["DATA.ROOT", root,
            "DATA.TOKENIZER_MODEL", os.path.join(root, "tok.model"),
            "DATA.VOCAB_SIZE", str(PROXY_VOCAB),
            *WIDTHS[width]["model"],
            "OPTIM.NUM_ITERATIONS", str(iterations),
            "OPTIM.WARMUP_STEPS", "40",
            "OPTIM.OPTIMIZER_NAME", "adamw",
            "OPTIM.LR", "0.001",
            "OPTIM.CNN_LR", "0.001",
            "OPTIM.WEIGHT_DECAY", "0.0001",
            "OPTIM.LOOKAHEAD.USE", "False",
            "OPTIM.GRAD_ACCUM_STEPS", str(accum)]


def passes(beam_cider: float, nucleus_cider: float) -> bool:
    return (beam_cider >= BEAM_CIDER_GATE
            and nucleus_cider >= NUCLEUS_CIDER_GATE)


def run_proxy(args, root: str) -> Dict[str, Any]:
    """Fixtures, pretraining and the two scoring runs in ``root``. Returns
    what each measured: the pretraining CLI's result, each decoder's
    metrics and predictions, the val captions, the seconds of each step
    and the recipe's iterations and accumulation."""
    recipe = WIDTHS[args.width]
    iterations = args.iterations or recipe["iterations"]
    accum = args.accum or recipe["accum"]
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    plane = DataPlane(decoder_for(torch.device(args.device)),
                      threads=args.cpu_workers)
    make_learnable_coco(plane, root, n_train=recipe["train"],
                        size=(recipe["image"],) * 2)
    train_tokenizer([c for _, c in LEARNABLE_CLASSES] * TOKENIZER_REPEATS,
                    os.path.join(root, "tok.model"), vocab_size=PROXY_VOCAB)
    seconds["fixtures"] = time.perf_counter() - t0

    overrides = (proxy_overrides(root, args.width, iterations, accum)
                 + [str(v) for v in args.config_override])
    config = ["--config", recipe["config"]] if recipe["config"] else []
    flags = ["--device", args.device, "--cpu-workers", str(args.cpu_workers)]
    print(f"[1/3] pretraining {iterations} iterations on learnable COCO "
          f"({args.width} width, grad_accum={accum})", flush=True)
    t0 = time.perf_counter()
    serialization = os.path.join(root, "ser")
    pretrain = pretrain_virtex.main(common_parser().parse_args([
        *config, "--serialization-dir", serialization,
        "--checkpoint-every", str(iterations),
        "--log-every", str(LOG_EVERY), *flags,
        "--config-override", *overrides]))
    seconds["pretrain"] = time.perf_counter() - t0
    checkpoint = os.path.join(serialization, f"checkpoint_{iterations}.pth")
    if not os.path.isfile(checkpoint):
        raise FileNotFoundError(f"pretraining wrote no {checkpoint}")

    def score(name: str, extra: List[str]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        out = eval_captioning.main(eval_captioning.build_parser().parse_args([
            *config, "--serialization-dir", os.path.join(root, name),
            "--checkpoint-path", checkpoint, "--calc-metrics",
            "--batch-size", str(EVAL_BATCH), *flags,
            "--config-override", *overrides, *extra]))
        seconds[name] = time.perf_counter() - t0
        return out

    print("[2/3] eval_captioning --calc-metrics (beam search)", flush=True)
    beam = score("eval", [])
    print("[3/3] eval_captioning --calc-metrics (nucleus sampling)",
          flush=True)
    nucleus = score("eval_nucleus", ["MODEL.DECODER.NAME", "nucleus_sampling"])
    with open(os.path.join(root, "annotations", "captions_val2017.json")) as f:
        truth = {a["image_id"]: a["caption"]
                 for a in json.load(f)["annotations"]}
    return {"pretrain": pretrain, "beam": beam, "nucleus": nucleus,
            "truth": truth, "seconds": seconds, "iterations": iterations,
            "accum": accum}


def proxy_line(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX script's result line."""
    beam = summary["beam"]["metrics"]["CIDEr"]
    nucleus = summary["nucleus"]["metrics"]["CIDEr"]
    return {"quality_proxy_smoke": "PASS" if passes(beam, nucleus)
            else "FAIL",
            "val_CIDEr": round(beam, 2),
            "val_CIDEr_nucleus": round(nucleus, 2),
            "iterations": summary["iterations"],
            "grad_accum_steps": summary["accum"]}


def overfit_config(root: str, vocab_size: int, extra: List[str]) -> Config:
    """``tests/overfit_smoke.py``'s config, then ``extra``."""
    return Config(override_list=[
        "MODEL.NAME", "bicaptioning",
        "MODEL.VISUAL.NAME", "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H128_A4_F256",
        "MODEL.TEXTUAL.DROPOUT", 0.0,
        "DATA.ROOT", root,
        "DATA.TOKENIZER_MODEL", os.path.join(root, "tok.model"),
        "DATA.VOCAB_SIZE", vocab_size,
        "DATA.IMAGE_CROP_SIZE", 64,
        "DATA.MAX_CAPTION_LENGTH", 16,
        "DATA.IMAGE_TRANSFORM_TRAIN", ["smallest_resize", "center_crop"],
        "OPTIM.OPTIMIZER_NAME", "adamw", "OPTIM.LR", 0.001,
        "OPTIM.CNN_LR", 0.001, "OPTIM.WEIGHT_DECAY", 0.0001,
        "OPTIM.LOOKAHEAD.USE", False,
        "OPTIM.NUM_ITERATIONS", OVERFIT_STEPS, "OPTIM.WARMUP_STEPS", 20,
        *extra])


def run_overfit(args, root: str) -> Dict[str, Any]:
    """Train on one fixed batch, then caption it. Returns the logged
    losses, the last one, the captions and their ground truth, and the
    exact matches."""
    device = torch.device(args.device)
    t0 = time.perf_counter()
    plane = DataPlane(decoder_for(device), threads=args.cpu_workers)
    write_coco(plane, root, OVERFIT_IMAGES)
    tokenizer = train_tokenizer(SYNTH_CAPTIONS * OVERFIT_REPEATS,
                                os.path.join(root, "tok.model"),
                                vocab_size=OVERFIT_VOCAB)
    _C = overfit_config(root, tokenizer.get_vocab_size(),
                        [str(v) for v in args.config_override])
    dataset = PretrainingDatasetFactory.from_config(_C, plane, "train")
    # One batch of every image, each caption drawn by its own RandomState(0)
    items = dataset.get_batch(list(range(OVERFIT_IMAGES)),
                              [np.random.RandomState(0)
                               for _ in range(OVERFIT_IMAGES)])
    host_batch = dataset.collate_fn(items)
    batch = shard_batch(host_batch, device)
    fixtures = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.manual_seed(_C.RANDOM_SEED)
    model = PretrainingModelFactory.from_config(_C, device)
    optimizer = OptimizerFactory.from_config(_C, model.named_parameters())
    state = TrainState(model, optimizer)
    generator = torch.Generator(device=device)
    train_step = make_train_step(model, optimizer, generator=generator)
    losses: Dict[int, float] = {}
    for it in range(OVERFIT_STEPS):
        generator.manual_seed(step_seed(_C.RANDOM_SEED, it))
        metrics = train_step(batch)
        state.iteration = it + 1
        if it % OVERFIT_LOG_EVERY == 0 or it == OVERFIT_STEPS - 1:
            losses[it] = float(metrics["loss"])
            print(f"iter {it}: loss {losses[it]:.4f}", flush=True)
    train = time.perf_counter() - t0

    t0 = time.perf_counter()
    spec = ModelSpec.from_config(_C)
    caption_fn = make_caption_fn(model, CaptionDecoderFactory.from_spec(spec),
                                 sos_index=spec.sos_index, prefix_mode="sos")
    tokenizer = TokenizerFactory.from_config(_C)
    captions = decode_predictions(caption_fn(batch["image"]), tokenizer,
                                  spec.eos_index)
    special = (spec.unk_index, spec.sos_index, spec.eos_index)
    truth = [tokenizer.decode([t for t in row if t not in special])
             for row in host_batch["caption_tokens"].tolist()]
    matches = sum(c.strip() == g.strip() for c, g in zip(captions, truth))
    return {"losses": losses, "final_loss": losses[OVERFIT_STEPS - 1],
            "captions": captions, "truth": truth, "matches": matches,
            "steps": state.iteration,
            "seconds": {"fixtures": fixtures, "train": train,
                        "caption": time.perf_counter() - t0}}


def overfit_line(summary: Dict[str, Any]) -> Dict[str, Any]:
    ok = (summary["final_loss"] < OVERFIT_LOSS_GATE
          and summary["matches"] >= OVERFIT_MATCH_GATE)
    return {"overfit_smoke": "PASS" if ok else "FAIL",
            "final_loss": round(summary["final_loss"], 4),
            "exact_matches": summary["matches"],
            "images": OVERFIT_IMAGES, "steps": summary["steps"]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the port on learnable "
                                 "synthetic data and score it through the "
                                 "CLIs (or overfit one batch).")
    ap.add_argument("--mode", choices=("proxy", "overfit"), default="proxy")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="proxy",
                    help="proxy: resnet18 and an L1_H128 head (the JAX "
                         "proxy's); full: the flagship's widths")
    ap.add_argument("--iterations", type=int, default=None,
                    help="pretraining iterations (default: 400, or 100 at "
                         "full width)")
    ap.add_argument("--accum", type=int, default=None,
                    help="OPTIM.GRAD_ACCUM_STEPS (default: 1, or 2 at full "
                         "width)")
    ap.add_argument("--config-override", nargs="*", default=[],
                    help="dotted-key value pairs after the recipe's")
    ap.add_argument("--workdir", default=None,
                    help="keep the data, checkpoints and logs here (default: "
                         "a temporary directory, removed at the end)")
    ap.add_argument("--cpu-workers", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="Device to run on (default: the card); 'cpu' runs "
                         "on the CPU.")
    return ap


def run(args) -> Dict[str, Any]:
    """The mode's run; returns its summary and its result line under
    "line"."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    root = args.workdir or tempfile.mkdtemp(prefix="quality_proxy_")
    os.makedirs(root, exist_ok=True)
    try:
        if args.mode == "overfit":
            summary = run_overfit(args, root)
            summary["line"] = overfit_line(summary)
        else:
            summary = run_proxy(args, root)
            summary["line"] = proxy_line(summary)
    finally:
        if not args.workdir:
            shutil.rmtree(root, ignore_errors=True)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    summary = run(build_parser().parse_args(argv))
    if "captions" in summary:
        for c, g in list(zip(summary["captions"], summary["truth"]))[:4]:
            print(f"  pred: {c!r}  gt: {g!r}", flush=True)
        print(f"exact caption matches: {summary['matches']}/"
              f"{OVERFIT_IMAGES}", flush=True)
    else:
        for p in summary["beam"]["predictions"][:4]:
            print(f"  beam: {p['caption']!r}  gt: "
                  f"{summary['truth'][p['image_id']]!r}", flush=True)
    line = summary["line"]
    print(json.dumps(line), flush=True)
    return 0 if "PASS" in line.values() else 1


if __name__ == "__main__":
    raise SystemExit(main())
