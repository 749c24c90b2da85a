"""The port's transfer pieces against the JAX package's on the CPU: the
downstream datasets (virtex_tpu_torch.data.datasets.downstream) through
``DownstreamDatasetFactory``, ``LinearClassifierModel``, the clf_linear
train step, and ``decode_predictions``.

- ImageNet (``make_fake_imagenet``), iNaturalist (a json tree as
  ``tests/test_downstream_data.py`` builds it) and an image directory:
  lengths, labels, ids and loader batches' labels equal the JAX datasets'.
- Pixels: the port decodes and resizes in the data plane, the JAX datasets
  in cv2 (INTER_AREA), so on smooth images at crop 64 the uint8 outputs
  agree within VAL_MEAN_TOL / VAL_MAX_TOL levels (val) and TRAIN_MEAN_TOL
  / TRAIN_MAX_TOL (train, the same crop and flip drawn from the same item
  ``RandomState``). Val resizes the short side to IMAGE_CROP_SIZE; the
  same images through the 256 resize of the pretraining val split miss the
  val tolerance many times over.
- A PNG in an image directory raises and names the file.
- ``LinearClassifierModel`` (resnet18 at 64², fp32) through the weight
  bridge: logits, loss and ``features`` within 1e-5 of their scale, in
  train and eval mode; frozen, no gradient reaches the CNN and its
  BatchNorm buffers do not move in a train-mode step.
- 3 steps of the clf_linear train step (the linear probe with its cosine
  schedule, the fine-tune with its multistep one) against the JAX
  ``make_train_step`` with ``build_optimizer`` as ``scripts/clf_linear.py``
  calls it: losses and final parameters within the bounds stated there.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import drawn_variables, rel_err, torch_batch
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.utils_fixtures import make_fake_imagenet
from virtex_tpu.config import Config as JaxConfig
from virtex_tpu.data.loader import DataLoader as JaxLoader
from virtex_tpu.data.loader import item_rng as jax_item_rng
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_train_step as jax_train_step
from virtex_tpu.factories import DownstreamDatasetFactory as JaxDatasets
from virtex_tpu.factories import LRSchedulerFactory as JaxSchedules
from virtex_tpu.models.downstream import (
    LinearClassifierModel as JaxClassifier,
)
from virtex_tpu.modules.visual_backbones import (
    ResNetVisualBackbone as JaxBackbone,
)
from virtex_tpu.optim import build_optimizer as jax_build_optimizer
from virtex_tpu_torch.config import Config
from virtex_tpu_torch.data.datasets.downstream import (
    ImageDirectoryDataset,
    VOC07ClassificationDataset,
)
from virtex_tpu_torch.data.loader import DataLoader, item_rng
from virtex_tpu_torch.data.native_pipeline import EvalPipeline, make_pipeline
from virtex_tpu_torch.data.transforms import EvalTransforms
from virtex_tpu_torch.engine.captioner import decode_predictions
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import (
    DownstreamDatasetFactory,
    VisualBackboneFactory,
)
from virtex_tpu_torch.models.downstream import LinearClassifierModel
from virtex_tpu_torch.native import DataPlane
from virtex_tpu_torch.scripts.clf_linear import build_optimizer
from virtex_tpu_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP, CLASSES, STEPS = 64, 10, 3
# uint8 levels, data plane against cv2 on smooth images (see the docstring;
# measured here: val mean <= 0.63, max 3; train mean <= 0.40, max 1)
VAL_MEAN_TOL, VAL_MAX_TOL = 1.0, 6
TRAIN_MEAN_TOL, TRAIN_MAX_TOL = 1.0, 4
MODEL_TOL = 1e-5  # fp32, of the output's scale


def _down_config(name: str, root: str, *extra):
    ov = ["DATA.ROOT", root, "DATA.IMAGE_CROP_SIZE", CROP,
          "MODEL.VISUAL.NAME", "torchvision::resnet18", *extra]
    path = os.path.join(REPO, "configs", "downstream", f"{name}.yaml")
    return JaxConfig(path, list(ov)), Config(path, list(ov))


def _smooth(rng, h, w) -> np.ndarray:
    """RGB8: shading in three directions and two soft discs."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (rng.uniform(60, 190, 3) + rng.uniform(-60, 60, 3)
           * (y / h)[..., None] + rng.uniform(-60, 60, 3)
           * (x / w)[..., None])
    for _ in range(2):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), 0.3 * min(h, w)
        d = np.sqrt((y - cy) ** 2 + (x - cx) ** 2) / r
        img += rng.uniform(-60, 60, 3) * np.exp(-d * d)[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def _write(path, rgb) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(str(path), rgb[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])


def make_smooth_imagenet(root, n_classes=3, per_class=3, seed=0):
    rng = np.random.RandomState(seed)
    sizes = [(90, 120), (120, 90), (100, 100), (75, 131)]
    for split in ("train", "val"):
        for c in range(n_classes):
            for i in range(per_class):
                h, w = sizes[(c + i) % len(sizes)]
                _write(os.path.join(root, split, f"n{c:08d}", f"{i}.JPEG"),
                       _smooth(rng, h, w))
    return root


def make_fake_inaturalist(root, n=6, seed=0):
    """annotations/{split}2018.json over JPEGs, as
    tests/test_downstream_data.py builds it, with smooth images."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in ("train", "val"):
        images, annotations = [], []
        for i in range(n):
            name = f"imgs/{split}_{i}.jpg"
            _write(os.path.join(root, name), _smooth(rng, 70 + 9 * i, 96))
            images.append({"id": 100 + i, "file_name": name})
            annotations.append({"image_id": 100 + i, "category_id": i % 4})
        with open(os.path.join(root, "annotations", f"{split}2018.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("downstream")
    return {"imagenet": make_smooth_imagenet(str(tmp / "imagenet")),
            "noise": make_fake_imagenet(str(tmp / "noise" / "imagenet")),
            "inaturalist": make_fake_inaturalist(str(tmp / "inaturalist"))}


@pytest.fixture(scope="module")
def plane():
    return DataPlane("libjpeg")


def _datasets(roots, plane, which, split):
    name = "imagenet_clf" if which != "inaturalist" else "inaturalist_clf"
    jcfg, cfg = _down_config(name, roots[which])
    return (JaxDatasets.from_config(jcfg, split),
            DownstreamDatasetFactory.from_config(cfg, plane, split))


def _paths_and_labels(ds):
    if hasattr(ds, "image_id_to_file_path"):  # the JAX iNaturalist reader
        return [(ds.image_id_to_file_path[i], c) for i, c in ds.instances]
    return [(p, int(c)) for p, c in ds.instances]


@pytest.mark.parametrize("which", ["imagenet", "noise", "inaturalist"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_instances_and_loader_labels_equal_the_jax_datasets(roots, plane,
                                                            which, split):
    jds, ds = _datasets(roots, plane, which, split)
    assert len(ds) == len(jds) > 0
    assert _paths_and_labels(ds) == _paths_and_labels(jds)
    if hasattr(jds, "wnid_to_idx"):
        assert ds.wnid_to_idx == jds.wnid_to_idx
    jl = JaxLoader(jds, 4, shuffle=True, num_workers=0, infinite=True,
                   collate_fn=jds.collate_fn)
    pl = DataLoader(ds, 4, shuffle=True, background=False, infinite=True)
    for jb, pb in zip(iter(jl), iter(pl)):
        np.testing.assert_array_equal(pb["label"], jb["label"])
        assert pb["image"].shape == jb["image"].shape == (4, CROP, CROP, 3)
        assert pb["image"].dtype == jb["image"].dtype == np.uint8
        break


def _pixel_gap(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.mean()), float(d.max())


@pytest.mark.parametrize("which", ["imagenet", "inaturalist"])
def test_val_pixels_match_the_jax_cv2_stack_at_the_crop_size(roots, plane,
                                                             which):
    jds, ds = _datasets(roots, plane, which, "val")
    for i in range(len(ds)):
        ref = jds[i]["image"]
        got = ds.get_batch([i], [None])[0]["image"]
        mean, worst = _pixel_gap(got, ref)
        assert mean <= VAL_MEAN_TOL and worst <= VAL_MAX_TOL, (i, mean,
                                                               worst)


def test_the_256_resize_of_the_pretraining_val_split_fails_the_gate(
        roots, plane):
    """The trap: the same images through the data plane's 256 resize (a
    centre square of 64/256 of the short side) are far off the JAX
    datasets' pixels, which resize to the crop size."""
    jds, ds = _datasets(roots, plane, "imagenet", "val")
    wrong = EvalPipeline(plane, CROP, EvalTransforms(resize_size=256),
                         emit_uint8=True)
    assert ds.pipeline.resize_size == CROP
    gaps = []
    for i in range(len(ds)):
        with open(ds.instances[i][0], "rb") as f:
            img, _ = wrong.batch([f.read()], [None])
        gaps.append(_pixel_gap(img[0], jds[i]["image"])[0])
    assert min(gaps) > 5 * VAL_MEAN_TOL, gaps


@pytest.mark.parametrize("which", ["imagenet", "inaturalist"])
def test_train_pixels_match_on_the_same_item_draws(roots, plane, which):
    jds, ds = _datasets(roots, plane, which, "train")
    for i in range(len(ds)):
        ref = jds.__getitem__(i, rng=jax_item_rng(0, 0, i))["image"]
        got = ds.get_batch([i], [item_rng(0, 0, i)])[0]["image"]
        mean, worst = _pixel_gap(got, ref)
        assert mean <= TRAIN_MEAN_TOL and worst <= TRAIN_MAX_TOL, (
            i, mean, worst)


def test_image_directory_ids_are_stems_and_a_png_raises(roots, plane,
                                                        tmp_path):
    from virtex_tpu.data import ImageDirectoryDataset as JaxDirectory
    src = os.path.join(roots["imagenet"], "val", "n00000000")
    jds = JaxDirectory(src)
    ds = ImageDirectoryDataset(src, EvalPipeline(plane))
    assert len(ds) == len(jds) == 3
    items = ds.get_batch(range(len(ds)), [None] * len(ds))
    assert [it["image_id"] for it in items] == [
        jds[i]["image_id"] for i in range(len(jds))]
    batch = ds.collate_fn(items)
    assert batch["image"].shape == (3, 224, 224, 3)
    assert batch["image"].dtype == np.float32
    # the default transform: 256, crop 224, normalized on the host
    for i in range(len(jds)):
        gap = np.abs(batch["image"][i] - jds[i]["image"]).mean()
        assert gap < 0.05, gap  # normalized units: ~3 levels
    png = tmp_path / "dir"
    png.mkdir()
    _write(str(png / "a.jpg"), _smooth(np.random.RandomState(1), 40, 50))
    cv2.imwrite(str(png / "b.png"), np.zeros((40, 50, 3), np.uint8))
    bad = ImageDirectoryDataset(str(png), EvalPipeline(plane))
    with pytest.raises(ValueError, match="b.png"):
        bad.get_batch([0, 1], [None, None])


def test_make_pipeline_takes_the_resize_size(plane):
    t = make_pipeline(["smallest_resize", "center_crop", "normalize"], CROP,
                      plane, True, resize_size=CROP)
    assert t.resize_size == CROP and t.emit_uint8
    assert make_pipeline(["smallest_resize", "center_crop"], CROP, plane,
                         False).resize_size == 256


# -- the model ---------------------------------------------------------------
def _models(frozen: bool, seed: int = 0):
    jm = JaxClassifier(visual=JaxBackbone("resnet18", frozen=frozen,
                                          dtype=jnp.float32),
                       num_classes=CLASSES)
    batch = _batch(seed)
    variables = drawn_variables(jm, batch, seed)
    rng = np.random.RandomState(seed + 7)
    variables["params"]["fc"]["kernel"] = (0.05 * rng.randn(
        *variables["params"]["fc"]["kernel"].shape)).astype(np.float32)
    variables["params"]["fc"]["bias"] = (0.5 * rng.randn(CLASSES)).astype(
        np.float32)
    visual = VisualBackboneFactory.create("torchvision::resnet18",
                                          frozen=frozen, dtype=torch.float32)
    model = LinearClassifierModel(visual, CLASSES)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, model


def _batch(seed: int, size: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(size, CROP, CROP, 3).astype(np.float32),
            "label": rng.randint(0, CLASSES, size).astype(np.int32)}


@pytest.mark.parametrize("train", [True, False])
def test_classifier_matches_jax_through_the_bridge(train):
    jm, variables, model = _models(frozen=False)
    batch = _batch(1)
    # features first: a train-mode forward moves the port's running
    # statistics, where flax returns them apart
    feats = jm.apply(variables, jnp.asarray(batch["image"]),
                     method=JaxClassifier.features)
    assert rel_err(model.train(train).features(
        torch.from_numpy(batch["image"])), feats,
        float(np.abs(feats).max())) <= MODEL_TOL
    assert model.training == train  # features() restores the mode
    ref, _ = jm.apply(variables, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, train=train,
                      mutable=["batch_stats"])
    got = {k: v.detach() if torch.is_tensor(v) else v
           for k, v in model(torch_batch(batch)).items()}
    scale = float(np.abs(ref["logits"]).max())
    assert rel_err(got["logits"], ref["logits"], scale) <= MODEL_TOL
    assert abs(float(got["loss"]) - float(ref["loss"])) <= \
        MODEL_TOL * abs(float(ref["loss"]))
    assert float(got["loss_components"]["classification"].detach()) == \
        float(got["loss"])
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(ref["predictions"]))


def test_frozen_backbone_gets_no_gradient_and_keeps_its_statistics():
    _, _, model = _models(frozen=True)
    before = {k: v.clone() for k, v in model.visual.state_dict().items()}
    out = model.train()(torch_batch(_batch(2)))
    out["loss"].backward()
    assert all(p.grad is None for p in model.visual.parameters())
    assert model.fc.weight.grad is not None
    for k, v in model.visual.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- the clf_linear train step -----------------------------------------------
CASES = {"probe": ("imagenet_clf", True, ["OPTIM.NUM_ITERATIONS", 5]),
         "finetune": ("inaturalist_clf", False,
                      ["OPTIM.NUM_ITERATIONS", 5, "OPTIM.LR_STEPS", "[2]"])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clf_linear_trajectory_matches_jax(case):
    name, frozen, extra = CASES[case]
    jcfg, cfg = _down_config(name, "datasets/imagenet", *extra)
    jm, variables, model = _models(frozen=frozen, seed=3)
    batches = [_batch(20 + s) for s in range(STEPS)]

    O = jcfg.OPTIM
    tx = jax_build_optimizer(
        variables["params"], optimizer_name=O.OPTIMIZER_NAME,
        schedule=JaxSchedules.from_config(jcfg), lr=O.LR, cnn_lr=O.LR,
        weight_decay=O.WEIGHT_DECAY, no_decay_pattern=O.NO_DECAY,
        momentum=O.SGD_MOMENTUM, clip_norm=O.CLIP_GRAD_NORM,
        use_lookahead=O.LOOKAHEAD.USE, lookahead_k=O.LOOKAHEAD.STEPS,
        lookahead_alpha=O.LOOKAHEAD.ALPHA,
        frozen_pattern="visual" if frozen else None)
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              tx)
    step = jax_train_step(jm, tx, donate=False, jit=True)
    ref = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        ref.append(float(m["loss"]))
    ref_final = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))

    port_step = make_train_step(model, build_optimizer(model, cfg))
    got = [float(port_step(torch_batch(b))["loss"]) for b in batches]
    final = model.state_dict()

    # The probe: the backbone is frozen (running statistics, no gradient),
    # so only fc trains and everything agrees to fp32 noise. The
    # fine-tune: 4 images of 64² make resnet18's backward ill-conditioned
    # (tests/test_torch_tasks.py: one ReLU flip moves the CNN's gradients
    # by ~2%), which its later losses and CNN parameters carry.
    loss_tol = 1e-5 if frozen else 2e-3
    for s, (a, r) in enumerate(zip(got, ref)):
        tol = 1e-5 if s == 0 else loss_tol
        assert abs(a - r) <= tol * abs(r), (s, got, ref)
    assert sorted(final) == sorted(ref_final)
    for key, want in ref_final.items():
        if key.endswith("num_batches_tracked"):
            continue
        want = want.numpy()
        tol = 5e-2 if key.startswith("visual.") and not frozen else 1e-4
        assert rel_err(final[key], want, float(np.abs(want).max()) + 1e-12) \
            <= tol, key
    if frozen:
        for key, value in state_dict_from_flax(variables).items():
            if key.startswith("visual."):
                assert torch.equal(final[key], value), key


def test_decode_predictions_equals_the_jax_function(tmp_path):
    from tests.utils_fixtures import make_tokenizer
    from virtex_tpu.engine.captioner import (
        decode_predictions as jax_decode,
    )
    from virtex_tpu_torch.data.tokenizers import SentencePieceBPETokenizer
    ref_tok = make_tokenizer(tmp_path)
    tok = SentencePieceBPETokenizer(ref_tok.model_path)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, ref_tok.get_vocab_size(), (16, 12))
    tokens[::3, 4] = 2  # an EOS mid-row
    tokens[1, 0] = 2    # at the start
    want = jax_decode(tokens, ref_tok)
    assert decode_predictions(tokens, tok) == want
    assert decode_predictions(torch.from_numpy(tokens), tok) == want
    assert want[1] == ""


def test_visual_backbone_factory_follows_the_jax_grammar():
    """``torchvision::<arch>`` or a bare arch, bf16 unless given; from a
    config, DTYPE and FROZEN as the JAX factory reads them; an unknown
    family raises."""
    from virtex_tpu.factories import VisualBackboneFactory as JaxFactory
    for name in ("torchvision::resnet18", "resnet18"):
        visual = VisualBackboneFactory.create(name)
        assert visual.dtype == torch.bfloat16 and not visual.frozen
        assert visual.cnn.out_channels == 512
    jcfg, cfg = _down_config("imagenet_clf", "datasets/imagenet",
                             "DTYPE", "float32")
    ref, got = JaxFactory.from_config(jcfg), VisualBackboneFactory.from_config(
        cfg)
    assert ref.name_or_arch == "resnet18" and ref.frozen and got.frozen
    assert (ref.dtype == jnp.float32) and got.dtype == torch.float32
    with pytest.raises(KeyError, match="family"):
        VisualBackboneFactory.create("detectron2::resnet18")
    with pytest.raises(KeyError, match="No downstream dataset"):
        DownstreamDatasetFactory.from_config(
            _down_config("imagenet_clf", "datasets/places365")[1], None)
    assert DownstreamDatasetFactory.PRODUCTS["datasets/VOC2007"] is \
        VOC07ClassificationDataset   # tests/test_torch_voc07.py
