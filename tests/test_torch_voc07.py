"""The port's VOC07 transfer (virtex_tpu_torch.scripts.clf_voc07,
utils/svm.py, ``average_precision``, ``VOC07ClassificationDataset``)
against sklearn and the JAX package's script on the CPU.

- ``stratified_kfold`` equals ``StratifiedKFold(3)`` index for index;
  ``average_precision`` equals ``average_precision_score`` to 1e-12.
- The solver against ``LinearSVC`` with the JAX script's arguments at
  n > d (300 × 64), where sklearn takes its primal solver as at VOC07's
  5011 × 2048: w and b within 1e-3 relative (sklearn stops at its tol
  1e-4; measured ≤ 6e-5), decision values within 1e-3 of their scale; per
  class, the chosen cost equals the script's wherever its CV AP margin
  exceeds 1e-3, and the test AP is within 1e-3 of
  ``train_test_single_svm``'s.
- The dataset's instances and labels equal the JAX class's.
- The CLI against the JAX script on one weight set (a JAX checkpoint and
  its bridged port checkpoint) and one fake VOC tree, both backbones in
  fp32: features within 1e-4 of their scale, and the mAP within MAP_TOL.
"""
import importlib.util
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tests.torch_parity import caption_batch, drawn_variables, rel_err
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.utils_fixtures import make_fake_voc07
from virtex_tpu.config import Config as JaxConfig
from virtex_tpu.data.datasets.downstream import (
    VOC07ClassificationDataset as JaxVOC07,
)
from virtex_tpu.factories import PretrainingModelFactory as JaxModels
from virtex_tpu.factories import VisualBackboneFactory as JaxBackbones
from virtex_tpu.utils.common import common_parser as jax_common_parser
from virtex_tpu_torch.data.datasets.downstream import (
    VOC07ClassificationDataset,
)
from virtex_tpu_torch.data.native_pipeline import make_pipeline
from virtex_tpu_torch.factories import VisualBackboneFactory
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.scripts import clf_voc07
from virtex_tpu_torch.utils import svm
from virtex_tpu_torch.utils.metrics import average_precision
from virtex_tpu_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "_base_bicaptioning_R_50_L1_H1024.yaml")
VOC_CONFIG = os.path.join(REPO, "configs", "downstream", "voc07_clf.yaml")
SVM_TOL = 1e-3
# The CLIs' printed mAP (×100, 3 decimals). Both fit the same features
# (measured within 8e-7 of their scale) by solvers that agree to <= 6e-5
# relative in w, so a class's test AP could move only where two test
# scores lie that close and swap, or two costs' CV APs tie that closely.
# One swap among a class's ~10 test positives moves the mean AP over 4
# classes by whole points, so the bound allows none: one unit of the last
# printed digit. Measured equal (98.988 both).
MAP_TOL = 1e-3


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- folds and average precision ---------------------------------------------
def _label_vectors():
    rng = np.random.RandomState(0)
    fixture = np.asarray([[1, -1, -1, 0][i % 4] for i in range(24)])
    return {
        "balanced": np.tile([1, -1], 15),
        "unbalanced": np.r_[np.ones(4), -np.ones(37)],
        "first_negative": np.r_[-1, -1, 1, rng.choice([1, -1], 40)],
        "random_300": rng.choice([1, -1], 300, p=[0.1, 0.9]),
        "fixture": svm.binary_labels(fixture),
        "three_values": fixture,
        "rare_class": np.r_[-np.ones(20), 1, 1],
        "odd_length": rng.choice([1, -1], 31),
    }


@pytest.mark.parametrize("name", sorted(_label_vectors()))
def test_stratified_kfold_matches_sklearn(name):
    from sklearn.model_selection import StratifiedKFold
    y = _label_vectors()[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # fewer members than folds
        want = list(StratifiedKFold(3).split(np.zeros((y.size, 1)), y))
    got = svm.stratified_kfold(y)
    assert len(got) == len(want) == 3
    for (a_train, a_test), (b_train, b_test) in zip(got, want):
        np.testing.assert_array_equal(a_train, b_train)
        np.testing.assert_array_equal(a_test, b_test)


def _ap_cases():
    rng = np.random.RandomState(1)
    y = rng.choice([1, -1], 50)
    return {
        "random": (y, rng.randn(50)),
        "tied": (y, rng.randint(0, 4, 50).astype(np.float64)),
        "all_tied": (y, np.zeros(50)),
        "no_positive": (-np.ones(20), rng.randn(20)),
        "all_positive": (np.ones(9), rng.randn(9)),
        "zero_one_labels": (rng.choice([1, 0], 40), rng.randn(40)),
        "one_sample": (np.ones(1), np.ones(1)),
    }


@pytest.mark.parametrize("name", sorted(_ap_cases()))
def test_average_precision_matches_sklearn(name):
    from sklearn.metrics import average_precision_score
    y, score = _ap_cases()[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # no positive class
        want = average_precision_score(y, score)
    got = average_precision(y, score)
    assert abs(got - want) <= 1e-12, (got, want)
    if name == "no_positive":
        assert got == 0.0 and want == 0.0   # what sklearn 1.x gives


# -- the solver against LinearSVC ---------------------------------------------
def _features(n, d, seed, classes=1):
    """L2-normalised rows with a linear class signal; labels in {1, 0, −1}
    (positive, negative, difficult) per class."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    scores = x @ rng.randn(d, classes) + 0.3 * rng.randn(n, classes)
    targets = np.where(scores > np.quantile(scores, 0.8, axis=0), 1, 0)
    targets[rng.rand(n, classes) < 0.05] = -1
    return x, targets


@pytest.mark.parametrize("cost", svm.SVM_COSTS)
def test_solver_matches_linear_svc(cost):
    from sklearn.svm import LinearSVC
    x, targets = _features(300, 64, seed=3)
    y = svm.binary_labels(targets[:, 0])
    clf = LinearSVC(C=cost, class_weight={1: 2, -1: 1}, max_iter=2000,
                    penalty="l2", loss="squared_hinge", dual="auto").fit(x, y)
    costs = svm.row_costs(y, cost, np.arange(300))
    sol = svm.solve(torch.from_numpy(x), torch.from_numpy(y[None]),
                    torch.from_numpy(costs[None]))
    assert float(sol.grad_norm[0]) <= svm.GRAD_RTOL * float(sol.grad_norm0[0])
    got = np.r_[sol.w[0].numpy(), float(sol.b[0])]
    want = np.r_[clf.coef_[0], clf.intercept_]
    assert np.abs(got - want).max() <= SVM_TOL * np.abs(want).max()
    decision = x @ got[:-1] + got[-1]
    ref = clf.decision_function(x)
    assert np.abs(decision - ref).max() <= SVM_TOL * np.abs(ref).max()


def test_cost_choice_and_test_ap_match_the_jax_script():
    from sklearn.model_selection import cross_val_score
    from sklearn.svm import LinearSVC
    script = _jax_script("clf_voc07")
    classes = 4
    x, targets = _features(500, 64, seed=4, classes=classes)
    x_train, x_test = x[:300], x[300:]
    t_train, t_test = targets[:300], targets[300:]
    names = [f"class{c}" for c in range(classes)]
    results, stats = svm.train_test_svms(
        torch.from_numpy(x_train), t_train, torch.from_numpy(x_test), t_test,
        names)
    assert stats["grad_norm"].numel() == classes * (4 * 3 + 1)
    assert bool((stats["grad_norm"]
                 <= svm.GRAD_RTOL * stats["grad_norm0"]).all())
    for c, result in enumerate(results):
        y = svm.binary_labels(t_train[:, c])
        cv = [cross_val_score(LinearSVC(
            C=cost, class_weight={1: 2, -1: 1}, max_iter=2000, penalty="l2",
            loss="squared_hinge", dual="auto"), x_train, y, cv=3,
            scoring="average_precision").mean() for cost in svm.SVM_COSTS]
        assert np.allclose(result.cv_ap, cv, atol=SVM_TOL, rtol=0)
        best = int(np.argmax(cv))
        margin = min([cv[best] - v for i, v in enumerate(cv) if i != best])
        if margin > SVM_TOL:
            assert result.cost == svm.SVM_COSTS[best], (c, cv)
        name, ap = script.train_test_single_svm(
            (x_train, t_train[:, c], x_test, t_test[:, c], names[c]))
        assert name == result.name
        assert abs(result.ap - ap) <= SVM_TOL, (c, result.ap, ap)


def test_class_without_positives_raises():
    x, targets = _features(30, 8, seed=5)
    targets[:, 0] = np.where(targets[:, 0] == 1, 0, targets[:, 0])
    with pytest.raises(ValueError, match="one class"):
        svm.train_test_svms(torch.from_numpy(x), targets,
                            torch.from_numpy(x), targets, ["empty"])


def test_unconverged_fit_is_logged(monkeypatch, caplog):
    """A fit stopped by MAX_NEWTON_STEPS short of GRAD_RTOL is named in a
    warning; the converged ones are not."""
    x, targets = _features(120, 8, seed=6, classes=2)
    monkeypatch.setattr(svm, "MAX_NEWTON_STEPS", 1)
    with caplog.at_level("WARNING", logger="virtex_tpu_torch"):
        _, stats = svm.train_test_svms(torch.from_numpy(x), targets,
                                       torch.from_numpy(x), targets,
                                       ["cat", "dog"])
    short = int((stats["grad_norm"]
                 > svm.GRAD_RTOL * stats["grad_norm0"]).sum())
    warned = [r.getMessage() for r in caplog.records
              if "Newton's method stopped" in r.getMessage()]
    assert short > 0 and len(warned) == short
    assert any("class 'cat', cost" in m for m in warned)


# -- the dataset --------------------------------------------------------------
def test_voc07_dataset_equals_jax(tmp_path):
    root = make_fake_voc07(str(tmp_path / "VOC2007"), n_images=12,
                           n_classes=5)
    listing = os.path.join(root, "ImageSets", "Main", "class2_trainval.txt")
    with open(listing) as f:   # an image missing from one class's listing
        lines = f.readlines()
    with open(listing, "w") as f:
        f.writelines(lines[:3] + lines[4:])
    pipeline = make_pipeline(["smallest_resize", "center_crop", "normalize"],
                             32, DataPlane(decoder_for("cpu")), False,
                             resize_size=32)
    for split in ("trainval", "test"):
        ours = VOC07ClassificationDataset(root, split, pipeline)
        theirs = JaxVOC07(root, split)
        assert ours.class_names == theirs.class_names
        assert len(ours) == len(theirs) == 12
        for (p1, l1), (p2, l2) in zip(ours.instances, theirs.instances):
            assert p1 == p2
            np.testing.assert_array_equal(l1, l2)
    labels = np.stack([l for _, l in ours.instances])
    assert set(np.unique(labels)) == {-1, 0, 1}
    batch = ours.collate_fn(ours.get_batch([0, 5], [None, None]))
    assert batch["image"].shape == (2, 32, 32, 3)
    assert batch["label"].shape == (2, 5)


# -- the CLI against the JAX script -------------------------------------------
def _fp32_backbones(monkeypatch):
    """Both scripts build their backbone in bf16; hold them in fp32 here,
    so the features compare to 1e-4."""
    jax_create, port_create = JaxBackbones.create, VisualBackboneFactory.create
    monkeypatch.setattr(JaxBackbones, "create", lambda name, **kw: jax_create(
        name, dtype=jnp.float32, **kw))
    monkeypatch.setattr(VisualBackboneFactory, "create",
                        lambda name, **kw: port_create(
                            name, dtype=torch.float32, **kw))


class _SerialPool:
    """``mp.Pool`` for the JAX script, run in this process: a fork of a
    process running JAX may deadlock."""

    def __init__(self, processes=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return [fn(job) for job in jobs]


def _args(parser, run, ckpt, root, workers, batch, *extra):
    return parser.parse_args(
        [*extra, "--config", CONFIG, "--down-config", VOC_CONFIG,
         "--serialization-dir", str(run), "--weight-init", "virtex",
         "--checkpoint-path", ckpt, "--cpu-workers", workers,
         "--config-override", "MODEL.VISUAL.NAME", "torchvision::resnet18",
         "MODEL.VISUAL.FEATURE_SIZE", "512", "MODEL.TEXTUAL.NAME",
         "transdec_postnorm::L1_H64_A2_F128",
         "--down-config-override", "DATA.ROOT", root,
         "DATA.IMAGE_CROP_SIZE", "64", "OPTIM.BATCH_SIZE", batch])


TREE_IMAGES, TREE_CLASSES = 30, 4
TREE_COLOURS = [(60, 0, 0), (0, 60, 0), (0, 0, 60), (40, 40, -40)]


def _voc_tree(root, seed=0):
    """A VOC2007 tree whose trainval and test images differ: 64² JPEGs (the
    crop size, so no resize), each a grey base plus the colour of every
    class present, shaded, with ±10 noise, within [30, 225] (the port's
    data plane and the JAX package's cv2 stack then give equal pixels;
    tests/test_torch_downstream.py holds them where they resize). Labels
    raw 1 (p 0.35), 0 "difficult" (p 0.1), else −1."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "ImageSets", "Main"))
    y, x = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    for split in ("trainval", "test"):
        raw = rng.choice([1, 0, -1], (TREE_IMAGES, TREE_CLASSES),
                         p=[0.35, 0.1, 0.55])
        assert ((raw == 1).sum(0) >= 3).all()
        for i, labels in enumerate(raw):
            img = np.full((64, 64, 3), 128.0, np.float32)
            for c in np.flatnonzero(labels == 1):
                shade = rng.uniform(0.5, 1.0) + 0.3 * (y if c % 2 else x)
                img += shade[..., None] * np.asarray(TREE_COLOURS[c])
            img += rng.randint(-10, 11, img.shape)
            cv2.imwrite(os.path.join(root, "JPEGImages",
                                     f"{split}_{i:03d}.jpg"),
                        np.clip(img, 30, 225).astype(np.uint8))
        for c in range(TREE_CLASSES):
            with open(os.path.join(root, "ImageSets", "Main",
                                   f"class{c}_{split}.txt"), "w") as f:
                f.writelines(f"{split}_{i:03d} {raw[i, c]}\n"
                             for i in range(TREE_IMAGES))
    return root


def _last_json(text: str) -> dict:
    import json
    return json.loads([ln for ln in text.strip().splitlines()
                       if ln.startswith("{")][-1])


def _jax_parser():
    parser = jax_common_parser()
    parser.add_argument("--down-config", default=None)
    parser.add_argument("--down-config-override", nargs="*", default=[])
    parser.add_argument("--weight-init", default="virtex")
    parser.add_argument("--checkpoint-path", default=None)
    return parser


def test_clf_voc07_equals_the_jax_cli(tmp_path, capsys, monkeypatch):
    cfg = JaxConfig(CONFIG, ["MODEL.VISUAL.NAME", "torchvision::resnet18",
                             "MODEL.VISUAL.FEATURE_SIZE", 512,
                             "MODEL.TEXTUAL.NAME",
                             "transdec_postnorm::L1_H64_A2_F128",
                             "DATA.IMAGE_CROP_SIZE", 64])
    batch = caption_batch(2, 64, cfg.DATA.MAX_CAPTION_LENGTH,
                          cfg.DATA.VOCAB_SIZE, seed=0)
    variables = drawn_variables(JaxModels.from_config(cfg), batch, seed=0)
    jax_ckpt = str(tmp_path / "jax_checkpoint")
    ocp.PyTreeCheckpointer().save(jax_ckpt, {"state": variables})
    port_ckpt = str(tmp_path / "checkpoint.pth")
    torch.save({"model": state_dict_from_flax(variables)}, port_ckpt)
    root = _voc_tree(str(tmp_path / "VOC2007"))

    _fp32_backbones(monkeypatch)
    # The JAX script's common_setup would switch the process's JAX PRNG to
    # "rbg" for every later test; keep threefry.
    monkeypatch.setenv("VIRTEX_TPU_THREEFRY", "1")
    script = _jax_script("clf_voc07")
    monkeypatch.setattr(script, "mp", types.SimpleNamespace(Pool=_SerialPool))
    jax_feats = {}
    extract = script.extract_features

    def recording(model, variables, dataset, *a):
        out = extract(model, variables, dataset, *a)
        jax_feats[dataset.split] = out
        return out
    monkeypatch.setattr(script, "extract_features", recording)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # sklearn's dual solver at n < d
        script.main(_args(_jax_parser(), tmp_path / "jax", jax_ckpt, root,
                          "0", "8"))
    jax.effects_barrier()
    want = _last_json(capsys.readouterr().out)
    got = clf_voc07.main(_args(clf_voc07.build_parser(), tmp_path / "port",
                               port_ckpt, root, "2", "5", "--device", "cpu"))
    line = _last_json(capsys.readouterr().out)
    assert line["metric"] == want["metric"] == "voc07_mAP"
    assert abs(line["value"] - want["value"]) <= MAP_TOL, (line, want)
    assert abs(got["mAP"] - want["value"]) <= MAP_TOL
    for split in ("trainval", "test"):
        x, labels = got["features"][split]
        jx, jlabels = jax_feats[split]
        assert x.shape == (TREE_IMAGES, 512)
        np.testing.assert_array_equal(labels, jlabels)
        assert rel_err(x, jx, float(np.abs(jx).max())) <= 1e-4, split
    assert [r.name for r in got["results"]] == [f"class{c}" for c in
                                                range(4)]
    stats = got["solver"]
    assert bool((stats["grad_norm"]
                 <= svm.GRAD_RTOL * stats["grad_norm0"]).all())
