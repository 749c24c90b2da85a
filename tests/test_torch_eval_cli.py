"""The port's evaluation and transfer entry points
(virtex_tpu_torch.scripts.eval_captioning and .clf_linear) against the JAX
package's scripts on the CPU, on the same weights.

A tiny config (the base config with resnet18 at 64², L1_H64, fp32) whose
weights are drawn from a numpy seed in JAX, saved as a JAX checkpoint
(orbax, ``{"state": {"params", "batch_stats"}}``) and bridged into a port
checkpoint (``{"model": state_dict_from_flax(...)}``).

- ``eval_captioning`` with beam search on ``make_fake_coco``'s 8 val images:
  the JAX script in one batch of 8 (tests/conftest.py gives JAX 8 CPU
  devices, and its script splits a batch over them), the port in batches
  of 3 (its last batch of 2 runs as it is): the predictions JSON is equal,
  and CIDEr equal to 1e-9;
  SPICE is 0.0 in both. Nucleus sampling: every caption re-encodes without
  an unknown token, and a second run from the same seed is equal.
  ``--images`` gives string ids.
- ``clf_linear``, the linear probe on a fake ImageNet tree (3 classes of
  colour-coded images), 3 iterations of 8 images, ``--weight-init virtex`` from the
  checkpoint above, checkpoints every iteration: the final top-1, the
  top-1 at each checkpoint, the saved iterations and the best iteration
  equal the JAX script's, and the classifier saved at the last iteration
  is within FC_TOL of the JAX one's scale. Both backbones run in bf16 (the
  class default, whatever DTYPE says), so their features differ by bf16
  roundings; ``fc`` starts at zero in both (its draw is each framework's
  own). Neither writes tensorboard events (the GPU machine has no
  tensorboard; the JAX script skips its writer without it).
"""
import importlib.util
import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tests.torch_parity import drawn_variables
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.utils_fixtures import make_fake_coco, make_tokenizer
from virtex_tpu.config import Config as JaxConfig
from virtex_tpu.data.loader import DataLoader as JaxLoader
from virtex_tpu.factories import PretrainingDatasetFactory as JaxDatasets
from virtex_tpu.factories import PretrainingModelFactory as JaxModels
from virtex_tpu.utils.common import common_parser as jax_common_parser
from virtex_tpu_torch.data.tokenizers import SentencePieceBPETokenizer
from virtex_tpu_torch.scripts import clf_linear, eval_captioning
from virtex_tpu_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "_base_bicaptioning_R_50_L1_H1024.yaml")
PROBE = os.path.join(REPO, "configs", "downstream", "imagenet_clf.yaml")
CIDER_TOL = 1e-9
FC_TOL = 2e-2  # measured 4.8e-3: three SGD steps on bf16 features
CLASS_COLOURS = [(220, 40, 40), (40, 200, 60), (40, 60, 220)]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_cli")
    root = make_fake_coco(str(tmp / "coco"), n_images=8)
    tokenizer = make_tokenizer(tmp).model_path
    overrides = ["DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tokenizer,
                 "DATA.VOCAB_SIZE", "300", "DATA.IMAGE_CROP_SIZE", "64",
                 "DATA.MAX_CAPTION_LENGTH", "16",
                 "MODEL.VISUAL.NAME", "torchvision::resnet18",
                 "MODEL.VISUAL.FEATURE_SIZE", "512",
                 "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H64_A2_F128",
                 "MODEL.DECODER.BEAM_SIZE", "3",
                 "MODEL.DECODER.MAX_DECODING_STEPS", "10", "DTYPE", "float32"]
    jcfg = JaxConfig(CONFIG, list(overrides))
    jds = JaxDatasets.from_config(jcfg, split="val")
    batch = next(iter(JaxLoader(jds, 4, shuffle=False, num_workers=0,
                                infinite=False)))
    variables = drawn_variables(JaxModels.from_config(jcfg), batch, seed=0,
                                output_bias_std=1.0)
    jax_ckpt = str(tmp / "jax_checkpoint")
    ocp.PyTreeCheckpointer().save(jax_ckpt, {"state": variables})
    port_ckpt = str(tmp / "checkpoint.pth")
    torch.save({"model": state_dict_from_flax(variables)}, port_ckpt)
    return tmp, root, tokenizer, overrides, jax_ckpt, port_ckpt


def _eval_args(parser, run, ckpt, overrides, *extra, workers="2",
               batch="3"):
    return parser.parse_args(
        ["--config", CONFIG, "--serialization-dir", str(run),
         "--checkpoint-path", ckpt, "--batch-size", batch, "--cpu-workers",
         workers, "--calc-metrics", "--output", str(run / "preds.json"),
         *extra, "--config-override", *overrides])


def _jax_eval_parser():
    parser = jax_common_parser()
    parser.add_argument("--images", "--data-root", dest="data_root",
                        default=None)
    parser.add_argument("--checkpoint-path", default=None)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--output", default=None)
    parser.add_argument("--calc-metrics", action="store_true")
    return parser


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.strip().splitlines()
                       if ln.startswith("{")][-1])


def test_beam_captions_and_cider_equal_the_jax_cli(setup, capsys,
                                                  monkeypatch):
    tmp, _, _, overrides, jax_ckpt, port_ckpt = setup
    # The JAX script's common_setup would switch the process's JAX PRNG to
    # "rbg" for every later test; keep threefry.
    monkeypatch.setenv("VIRTEX_TPU_THREEFRY", "1")
    _jax_script("eval_captioning").main(_eval_args(
        _jax_eval_parser(), tmp / "jax_eval", jax_ckpt, overrides,
        workers="0", batch="8"))
    want_metrics = _last_json(capsys.readouterr().out)
    got = eval_captioning.main(_eval_args(
        eval_captioning.build_parser(), tmp / "port_eval", port_ckpt,
        overrides, "--device", "cpu"))
    got_metrics = _last_json(capsys.readouterr().out)
    with open(tmp / "jax_eval" / "preds.json") as f:
        want = json.load(f)
    with open(tmp / "port_eval" / "preds.json") as f:
        assert json.load(f) == got["predictions"] == want
    assert len(want) == 8 and len({p["image_id"] for p in want}) == 8
    assert got_metrics == got["metrics"]
    assert set(got_metrics) == set(want_metrics) == {"CIDEr", "SPICE"}
    assert abs(got_metrics["CIDEr"] - want_metrics["CIDEr"]) <= \
        CIDER_TOL * max(1.0, abs(want_metrics["CIDEr"]))
    assert got_metrics["SPICE"] == want_metrics["SPICE"] == 0.0


def test_nucleus_captions_are_in_the_vocabulary_and_seeded(setup):
    tmp, root, tokenizer, overrides, _, port_ckpt = setup
    nucleus = overrides + ["MODEL.DECODER.NAME", "nucleus_sampling"]
    runs = [eval_captioning.main(_eval_args(
        eval_captioning.build_parser(), tmp / f"nucleus_{i}", port_ckpt,
        nucleus, "--device", "cpu")) for i in range(2)]
    assert runs[0]["predictions"] == runs[1]["predictions"]
    assert 0.0 <= runs[0]["metrics"]["CIDEr"] <= 1000.0
    tok = SentencePieceBPETokenizer(tokenizer)
    captions = [p["caption"] for p in runs[0]["predictions"]]
    assert len(captions) == 8 and any(captions)
    for caption in captions:
        assert 0 not in tok.encode(caption), caption
    directory = eval_captioning.main(_eval_args(
        eval_captioning.build_parser(), tmp / "nucleus_dir", port_ckpt,
        nucleus, "--device", "cpu", "--images",
        os.path.join(root, "val2017")))
    ids = [p["image_id"] for p in directory["predictions"]]
    assert ids == [f"{i:012d}" for i in range(1, 9)]


# -- clf_linear ----------------------------------------------------------------
def _colour_imagenet(root, per_class=4, seed=0):
    """{split}/{wnid}/*.JPEG whose class is its colour, with shading and
    noise."""
    import cv2
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:72, 0:96].astype(np.float32)
    for split in ("train", "val"):
        for c, colour in enumerate(CLASS_COLOURS):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                img = (np.asarray(colour, np.float32)
                       + rng.uniform(-30, 30) * (y / 72)[..., None]
                       + rng.uniform(-30, 30) * (x / 96)[..., None]
                       + rng.randint(-10, 11, (72, 96, 3)))
                img = np.clip(img, 0, 255).astype(np.uint8)
                cv2.imwrite(os.path.join(d, f"{i}.JPEG"), img[:, :, ::-1])
    return root


def _clf_args(parser, run, ckpt, root, workers, *extra):
    return parser.parse_args(
        [*extra, "--down-config", PROBE, "--serialization-dir", str(run),
         "--weight-init", "virtex", "--checkpoint-path", ckpt,
         "--checkpoint-every", "1", "--log-every", "1", "--cpu-workers",
         workers, "--down-config-override", "DATA.ROOT", root,
         "DATA.IMAGE_CROP_SIZE", "64", "MODEL.VISUAL.NAME",
         "torchvision::resnet18", "OPTIM.BATCH_SIZE", "8",
         "OPTIM.NUM_ITERATIONS", "3", "OPTIM.LR", "0.001"])


def _jax_clf_parser():
    parser = jax_common_parser()
    parser.add_argument("--down-config", required=True)
    parser.add_argument("--down-config-override", nargs="*", default=[])
    parser.add_argument("--weight-init", default="virtex")
    parser.add_argument("--checkpoint-path", default=None)
    return parser


def _saved(run) -> tuple:
    names = sorted(os.path.splitext(n)[0] for n in os.listdir(run)
                   if n.startswith("checkpoint_"))
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    return names, best["iteration"], best["metric"]


def test_linear_probe_equals_the_jax_cli(setup, capsys, monkeypatch):
    import sys

    import flax.linen as fnn
    tmp, _, _, _, jax_ckpt, port_ckpt = setup
    root = _colour_imagenet(str(tmp / "colours" / "imagenet"))
    monkeypatch.setenv("VIRTEX_TPU_THREEFRY", "1")   # as above
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(fnn.initializers, "normal",
                        lambda stddev=0.01: fnn.initializers.zeros)
    monkeypatch.setattr(torch.nn.init, "normal_",
                        lambda t, mean=0.0, std=1.0: torch.nn.init.zeros_(t))

    _jax_script("clf_linear").main(_clf_args(
        _jax_clf_parser(), tmp / "jax_clf", jax_ckpt, root, "0"))
    jax.effects_barrier()
    want = _last_json(capsys.readouterr().out)
    got = clf_linear.main(_clf_args(
        clf_linear.build_parser(), tmp / "port_clf", port_ckpt, root, "2",
        "--device", "cpu"))
    assert _last_json(capsys.readouterr().out) == want
    assert want["metric"] == got["metric"] == "imagenet_top1"
    assert round(got["value"], 3) == want["value"]
    assert all(np.isfinite(v) for v in got["losses"].values())
    saved = _saved(tmp / "port_clf")
    assert saved[0] == ["checkpoint_1", "checkpoint_2", "checkpoint_3",
                        "checkpoint_best"]
    assert saved == _saved(tmp / "jax_clf")
    assert sorted(got["top1"]) == [1, 2, 3]
    losses = [got["losses"][i] for i in (1, 2, 3)]
    assert losses[-1] < losses[0], losses
    fc = ocp.PyTreeCheckpointer().restore(
        str(tmp / "jax_clf" / "checkpoint_3"))["state"]["params"]["fc"]
    model = torch.load(str(tmp / "port_clf" / "checkpoint_3.pth"),
                       weights_only=True)["model"]
    for name, want in (("fc.weight", np.asarray(fc["kernel"]).T),
                       ("fc.bias", np.asarray(fc["bias"]))):
        gap = np.abs(model[name].numpy() - want).max()
        assert gap <= FC_TOL * np.abs(want).max(), (name, gap)
