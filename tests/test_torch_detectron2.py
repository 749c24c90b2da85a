"""The port's Detectron2 export (virtex_tpu_torch.modules.visual_backbones
detectron2_backbone_state_dict and virtex_tpu_torch.scripts.eval_detectron2)
against the JAX package's, on the CPU.

- the rename on weights bridged from seeded JAX variables
  (``state_dict_from_flax``), resnet18 and resnet50: the same names, the
  same bits;
- ``infer_resnet_depth`` on both visual-name grammars;
- the port script's ``.pkl`` against the JAX script's in each
  ``--weight-init``: ``torchvision`` (one ``.pth``) and ``virtex`` (the
  JAX script reads an orbax checkpoint that the JAX package's
  ``import_torch_checkpoint.py`` makes of the ``.pth`` the port reads):
  the same names and bits; ``random``: the same names and shapes;
- the Detectron2-driving half against ``tests/detectron2_stub``: the ROI
  head, the config, the weight load, the resume and the evaluators.
"""
import argparse
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    drawn_variables,
    init_batch,
    one_torch_thread,
)
from tests.torchvision_stub import make_torch_resnet18_sd
from virtex_tpu.config import Config as JaxConfig
from virtex_tpu.factories import PretrainingModelFactory as JaxFactory
from virtex_tpu.modules.visual_backbones import (
    detectron2_backbone_state_dict as jax_export,
)
from virtex_tpu.utils.checkpoint_convert import export_virtex_checkpoint
from virtex_tpu_torch.modules.visual_backbones import (
    ResNetVisualBackbone,
    detectron2_backbone_state_dict,
    detectron2_name,
)
from virtex_tpu_torch.scripts import eval_detectron2
from virtex_tpu_torch.utils.weights import state_dict_from_flax

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BASE = os.path.join(REPO, "configs", "_base_bicaptioning_R_50_L1_H1024.yaml")


def visual_overrides(arch: str) -> list:
    return ["MODEL.VISUAL.NAME", f"torchvision::{arch}",
            "MODEL.VISUAL.FEATURE_SIZE", 512 if arch == "resnet18" else 2048]


def pretraining_overrides(arch: str) -> list:
    return visual_overrides(arch) + [
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H32_A4_F64",
        "DATA.VOCAB_SIZE", 100, "DATA.IMAGE_CROP_SIZE", 64,
        "DATA.MAX_CAPTION_LENGTH", 8]


def seeded_variables(arch: str, seed: int) -> dict:
    cfg = JaxConfig(BASE, pretraining_overrides(arch))
    return drawn_variables(JaxFactory.from_config(cfg), init_batch(cfg, 64),
                           seed)


def load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same_export(got: dict, want: dict, bits: bool = True) -> None:
    assert got["matching_heuristics"] is want["matching_heuristics"] is True
    assert got["__author__"] == want["__author__"]
    assert sorted(got["model"]) == sorted(want["model"])
    for name, value in want["model"].items():
        ours = got["model"][name]
        assert isinstance(ours, np.ndarray) and ours.dtype == np.float32
        assert ours.shape == np.shape(value), name
        if bits:
            assert np.array_equal(ours, np.asarray(value)), name


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_rename_equals_the_jax_export(arch):
    variables = seeded_variables(arch, seed=1)
    p, s = variables["params"]["visual"], variables["batch_stats"]["visual"]
    visual = ResNetVisualBackbone(arch, dtype=torch.float32)
    sd = state_dict_from_flax({"params": {"visual": p},
                               "batch_stats": {"visual": s}})
    visual.load_state_dict({k[len("visual."):]: v for k, v in sd.items()},
                           strict=True)
    got = detectron2_backbone_state_dict(visual)
    assert_same_export(got, jax_export(p["cnn"], s["cnn"]))
    blocks = {k.split(".")[0] + "." + k.split(".")[1] for k in got["model"]
              if k.startswith("res")}
    assert len(blocks) == {"resnet18": 8, "resnet50": 16}[arch]


def test_names_map_one_to_one():
    visual = ResNetVisualBackbone("resnet50", dtype=torch.float32)
    names = [k for k in visual.cnn.state_dict()
             if not k.endswith("num_batches_tracked")]
    assert len({detectron2_name(k) for k in names}) == len(names)
    assert detectron2_name("layer3.5.downsample.1.running_var") == \
        "res4.5.shortcut.norm.running_var"
    with pytest.raises(KeyError):
        detectron2_name("fc.weight")


@pytest.mark.parametrize("name", [
    "torchvision::resnet50", "torchvision::resnet101", "resnet50",
    "torchvision::wide_resnet50_2", "detectron2::FPN_R_101_asdf",
    "something_else"])
def test_infer_resnet_depth_equals_the_jax_script(name):
    jax_script = load_jax_script("eval_detectron2")
    assert eval_detectron2.infer_resnet_depth(name) == \
        jax_script.infer_resnet_depth(name)


def run_port(tmp_path, weight_init, checkpoint=None, arch="resnet18",
             extra=()):
    args = eval_detectron2.build_parser().parse_args([
        "--config-override", *map(str, visual_overrides(arch)),
        "--serialization-dir", str(tmp_path / "port"),
        "--weight-init", weight_init, "--device", "cpu", *extra]
        + (["--checkpoint-path", checkpoint] if checkpoint else []))
    result = eval_detectron2.main(args)
    with open(result["output"], "rb") as f:
        exported = pickle.load(f)
    assert result["output"] == str(tmp_path / "port" /
                                   "virtex_backbone_d2.pkl")
    return exported, result


def test_torchvision_mode_equals_the_jax_script(tmp_path):
    sd = make_torch_resnet18_sd()
    path = str(tmp_path / "tv.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    want = load_jax_script("eval_detectron2").gather_backbone_weights(
        JaxConfig(None, visual_overrides("resnet18")), "torchvision", path)
    got, _ = run_port(tmp_path, "torchvision", path)
    assert_same_export(got, want)
    assert np.array_equal(got["model"]["res2.0.conv1.weight"],
                          sd["layer1.0.conv1.weight"])


def test_virtex_mode_equals_the_jax_script(tmp_path):
    """The port reads the ``.pth``; the JAX script reads the orbax
    checkpoint that the JAX package's importer makes of it."""
    variables = seeded_variables("resnet18", seed=3)
    pth = str(tmp_path / "pretrain.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          export_virtex_checkpoint(variables).items()}}, pth)
    orbax = str(tmp_path / "orbax")
    load_jax_script("import_torch_checkpoint").main(argparse.Namespace(
        config=BASE, config_override=pretraining_overrides("resnet18"),
        checkpoint_path=pth, output=orbax, iteration=1))
    want = load_jax_script("eval_detectron2").gather_backbone_weights(
        JaxConfig(None, visual_overrides("resnet18")), "virtex", orbax)
    got, _ = run_port(tmp_path, "virtex", pth)
    assert_same_export(got, want)
    cnn = variables["params"]["visual"]["cnn"]
    assert np.array_equal(got["model"]["stem.conv1.weight"],
                          np.transpose(cnn["conv1"]["kernel"], (3, 2, 0, 1)))


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_random_mode_has_the_jax_scripts_names_and_shapes(tmp_path, arch):
    want = load_jax_script("eval_detectron2").gather_backbone_weights(
        JaxConfig(None, visual_overrides(arch)), "random")
    got, _ = run_port(tmp_path, "random", arch=arch)
    assert_same_export(got, want, bits=False)


@pytest.mark.parametrize("weight_init,match", [
    ("virtex", "needs a checkpoint path"), ("imagenet", "unsupported")])
def test_virtex_without_a_checkpoint_and_imagenet_raise(tmp_path,
                                                        weight_init, match):
    """The JAX script exports the random init for ``virtex`` without a
    checkpoint; the port refuses, as its other CLIs do."""
    with pytest.raises(ValueError, match=match):
        run_port(tmp_path, weight_init)


def test_the_backbone_is_built_on_the_card_unless_asked(tmp_path):
    args = eval_detectron2.build_parser().parse_args([
        "--serialization-dir", str(tmp_path), "--weight-init", "random"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_detectron2.main(args)


# -- the Detectron2-driving half, against tests/detectron2_stub -------------
D2_YAML = """\
VERSION: 2
MODEL:
  ROI_HEADS:
    NAME: Res5ROIHeadsExtraNorm
  RESNETS:
    NORM: BN
DATASETS:
  TEST: [voc_2007_test, coco_2017_val, lvis_v0.5_val]
SOLVER:
  MAX_ITER: 2
"""


@pytest.fixture
def d2_stub(monkeypatch):
    """The stub on the path, its records cleared, no cached detectron2
    modules on either side of the test."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "detectron2"]:
        del sys.modules[mod]
    monkeypatch.syspath_prepend(os.path.join(HERE, "detectron2_stub"))
    import detectron2.checkpoint as ckpt
    import detectron2.evaluation as ev
    ckpt.LOAD_RECORDS.clear()
    ckpt.RESUME_RECORDS.clear()
    ev.INSTANTIATED.clear()
    yield ckpt, ev
    for mod in [m for m in sys.modules if m.split(".")[0] == "detectron2"]:
        del sys.modules[mod]


def d2_extra(tmp_path, *flags):
    (tmp_path / "d2.yaml").write_text(D2_YAML)
    return ["--d2-config", str(tmp_path / "d2.yaml"), "--cpu-workers", "2",
            "--checkpoint-every", "100", "--d2-config-override",
            "SOLVER.BASE_LR", "0.01", *flags]


def test_train_path_loads_the_backbone_and_trains(tmp_path, d2_stub):
    ckpt, _ = d2_stub
    exported, result = run_port(tmp_path, "random",
                                extra=d2_extra(tmp_path))
    assert result["results"] is None  # it trained
    [load] = ckpt.LOAD_RECORDS
    assert load["n_loaded"] >= 10, load
    pairs = dict(load["pairs"])
    assert pairs["backbone.stem.conv1.weight"] == "stem.conv1.weight"
    assert pairs["backbone.res2.0.conv1.norm.running_var"] == \
        "res2.0.conv1.norm.running_var"
    assert exported["model"]["stem.conv1.weight"].shape == (64, 3, 7, 7)


def test_eval_only_selects_all_three_evaluators(tmp_path, d2_stub):
    _, ev = d2_stub
    _, result = run_port(tmp_path, "random",
                         extra=d2_extra(tmp_path, "--eval-only"))
    assert {(cls, name) for cls, name, _ in ev.INSTANTIATED} == {
        ("PascalVOCDetectionEvaluator", "voc_2007_test"),
        ("COCOEvaluator", "coco_2017_val"),
        ("LVISEvaluator", "lvis_v0.5_val")}
    assert result["results"] == {
        f"{name}/bbox/{k}": v for name in ("voc_2007_test", "coco_2017_val",
                                           "lvis_v0.5_val")
        for k, v in (("AP", 42.0), ("AP50", 60.0))}


def test_resume_points_the_checkpointer_at_the_output_dir(tmp_path,
                                                          d2_stub):
    ckpt, _ = d2_stub
    run_port(tmp_path, "random",
             extra=d2_extra(tmp_path, "--resume", "--eval-only"))
    [rec] = ckpt.RESUME_RECORDS
    assert rec["save_dir"] == str(tmp_path / "port")
    assert rec["resume"] is True and rec["path"] == ""
    assert rec["has_optimizer"] and rec["has_scheduler"]
    assert not ckpt.LOAD_RECORDS


def test_the_depth_and_run_flags_reach_the_d2_config(tmp_path, d2_stub):
    from virtex_tpu_torch.config import Config
    args = eval_detectron2.build_parser().parse_args(
        ["--config-override", *map(str, visual_overrides("resnet18")),
         "--serialization-dir", str(tmp_path / "run")]
        + d2_extra(tmp_path))
    d2c = eval_detectron2.build_detectron2_config(
        Config(None, args.config_override), args)
    assert d2c.MODEL.RESNETS.DEPTH == 18
    assert d2c.DATALOADER.NUM_WORKERS == 2
    assert d2c.SOLVER.CHECKPOINT_PERIOD == 100
    assert d2c.SOLVER.BASE_LR == 0.01
    assert d2c.OUTPUT_DIR == str(tmp_path / "run")
    eval_detectron2.register_extra_norm_roi_heads()
    eval_detectron2.register_extra_norm_roi_heads()  # idempotent
    from detectron2.modeling.roi_heads import ROI_HEADS_REGISTRY
    head = ROI_HEADS_REGISTRY.get("Res5ROIHeadsExtraNorm")(d2c)
    assert isinstance(head.res5.norm, torch.nn.BatchNorm2d)
