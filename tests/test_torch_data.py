"""The port's data pipeline (virtex_tpu_torch.data, virtex_tpu_torch.native)
against the JAX package's on the CPU, with libjpeg, the decoder both use
here.

- The loaders' batches, from one seed, for the four pretext datasets, train
  and val: tokens, labels and ids equal, uint8 images bit-equal to the JAX
  package's native data plane. (Multilabel classification runs the cv2
  transforms in the JAX package; its images are held to the JAX native
  pipeline on the same draws, its labels to the JAX dataset.)
- The pixel work against cv2, at tests/test_native.py's tolerances.
- A loader restored from its state_dict gives the same stream.
- Two processes that build the data plane at once both load it.
- The committed JPEG reference of chip_smoke.py's decoder check is
  libjpeg's output; the decoder is chosen by what the machine has.
"""
import os
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest
import torch

from tests import make_torch_jpeg_reference as reference
from tests.utils_fixtures import make_fake_coco, make_tokenizer
from virtex_tpu.config import Config as JaxConfig
from virtex_tpu.data.loader import DataLoader as JaxLoader
from virtex_tpu.data.loader import item_rng as jax_item_rng
from virtex_tpu.data.native_pipeline import (
    NativeCaptionTrainPipeline,
    NativeEvalPipeline,
)
from virtex_tpu.factories import (
    PretrainingDatasetFactory as JaxDatasetFactory,
)
from virtex_tpu_torch import native
from virtex_tpu_torch.config import Config
from virtex_tpu_torch.data.loader import DataLoader, item_rng
from virtex_tpu_torch.data.transforms import (
    EvalTransforms,
    TrainTransforms,
    parse_transforms,
)
from virtex_tpu_torch.factories import PretrainingDatasetFactory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP, BATCH, SEED = 48, 4, 3
REFERENCE_IMAGES = list(reference.IMAGES)
MODELS = ["bicaptioning", "masked_lm", "token_classification",
          "multilabel_classification"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coco")
    root = make_fake_coco(str(tmp / "coco"), n_images=8)
    return root, make_tokenizer(tmp).model_path


def _overrides(coco, model_name):
    root, tok = coco
    textual = ("none" if model_name.endswith("classification")
               else "transdec_postnorm::L1_H64_A2_F128")
    return ["DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tok,
            "DATA.IMAGE_CROP_SIZE", CROP, "DATA.MAX_CAPTION_LENGTH", 12,
            "MODEL.NAME", model_name, "MODEL.TEXTUAL.NAME", textual]


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("model_name", MODELS)
def test_loader_batches_equal_the_jax_loader(coco, model_name, split):
    ov = _overrides(coco, model_name)
    jds = JaxDatasetFactory.from_config(JaxConfig(override_list=ov), split)
    ds = PretrainingDatasetFactory.from_config(
        Config(override_list=ov), native.DataPlane("libjpeg"), split)
    train = split == "train"
    kw = dict(shuffle=train, seed=SEED, infinite=train)
    n = 3 if train else 2
    ref = _batches(JaxLoader(jds, BATCH, num_workers=0, **kw), n)
    got = _batches(DataLoader(ds, BATCH, background=False, **kw), n)
    multilabel = model_name == "multilabel_classification"
    for b_got, b_ref in zip(got, ref):
        assert sorted(b_got) == sorted(b_ref)
        assert b_got["image"].dtype == np.uint8
        for k in b_ref:
            if k == "image" and multilabel:
                continue
            np.testing.assert_array_equal(b_got[k], b_ref[k], err_msg=k)
    if multilabel:
        _check_multilabel_images(jds, got, split)


def _check_multilabel_images(jds, got, split):
    """The port's multilabel images equal the JAX native pipeline's on the
    loader's draws: the ids give the files, the stream gives the rngs."""
    from virtex_tpu.data.loader import ShardedSampler
    sampler = ShardedSampler(len(jds), shuffle=split == "train", seed=SEED)
    pairs = sampler.iterate(0)
    paths = {image_id: path for image_id, path, _ in jds._samples}
    for batch in got:
        items = [next(pairs) for _ in range(BATCH)]
        jpegs = []
        for image_id in batch["image_id"]:
            with open(paths[int(image_id)], "rb") as f:
                jpegs.append(f.read())
        if split == "train":
            rngs = [jax_item_rng(SEED, e, i) for e, i in items]
            want, _ = NativeCaptionTrainPipeline(CROP, emit_uint8=True).batch(
                jpegs, [None] * BATCH, rngs)
        else:
            pipe = NativeEvalPipeline(CROP, emit_uint8=True)
            want = np.stack([pipe(j, None)[0] for j in jpegs])
        np.testing.assert_array_equal(batch["image"], want)


def test_float_images_when_the_host_normalizes(coco):
    ov = _overrides(coco, "bicaptioning") + ["DATA.DEVICE_NORMALIZE", False]
    jds = JaxDatasetFactory.from_config(JaxConfig(override_list=ov), "train")
    ds = PretrainingDatasetFactory.from_config(
        Config(override_list=ov), native.DataPlane("libjpeg"), "train")
    ref = _batches(JaxLoader(jds, BATCH, num_workers=0, seed=SEED), 1)[0]
    got = _batches(DataLoader(ds, BATCH, background=False, seed=SEED), 1)[0]
    assert got["image"].dtype == np.float32
    np.testing.assert_array_equal(got["image"], ref["image"])


def _jpeg(h=96, w=128, seed=0):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1])
    assert ok
    return enc.tobytes()


def _decoded(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]


def _pixels(data, rect, size, jitter=None):
    """The port's pixel work on the 0..255 scale, float32."""
    plane = native.DataPlane("libjpeg")
    return plane.batch_transform(
        [data], np.asarray([rect]), np.zeros(1), size, native.RAW_MEAN,
        native.RAW_STD, None if jitter is None else jitter[None])[0]


def test_decode_is_cv2s_decode():
    data = _jpeg(seed=1)
    np.testing.assert_array_equal(native.DataPlane("libjpeg").decode(data),
                                  _decoded(data))


def test_downscale_matches_cv2_inter_area():
    data = _jpeg(seed=3)
    ref = cv2.resize(_decoded(data)[8:72, 16:80], (32, 32),
                     interpolation=cv2.INTER_AREA)
    delta = np.abs(_pixels(data, (8, 16, 64, 64), 32) - ref)
    assert delta.max() < 2.0 and delta.mean() < 0.5


def test_upscale_matches_cv2_inter_linear():
    data = _jpeg(seed=4)
    ref = cv2.resize(_decoded(data)[8:24, 16:32], (32, 32),
                     interpolation=cv2.INTER_LINEAR)
    delta = np.abs(_pixels(data, (8, 16, 16, 16), 32) - ref)
    assert delta.max() < 4.0 and delta.mean() < 1.0


def test_jitter_matches_the_numpy_reference():
    from virtex_tpu.data.transforms import _shift_hue
    data = _jpeg(64, 64, seed=21)
    b, c, s, h = 1.3, 0.8, 1.2, 0.05
    out = _pixels(data, (0, 0, -1, -1), 64,
                  native.jitter_params([0, 1, 2, 3], b, c, s, h))
    ref = _decoded(data).astype(np.float32) * b
    mean = ref.mean()
    ref = (ref - mean) * c + mean
    gray = ref @ np.array([0.299, 0.587, 0.114], np.float32)
    ref = _shift_hue((ref - gray[..., None]) * s + gray[..., None], h)
    diff = np.abs(out * 1.0 - ref)
    assert np.median(diff) < 3.0 and np.mean(diff) < 6.0


def test_eval_pipeline_matches_the_cv2_path():
    from virtex_tpu.data.transforms import default_image_transform
    yy, xx = np.mgrid[0:100, 0:140]
    img = np.stack([yy * 2, xx, (yy + xx)], -1).astype(np.uint8)
    data = cv2.imencode(".jpg", img[:, :, ::-1])[1].tobytes()
    ref, _ = default_image_transform(crop_size=64, resize_size=256)(
        _decoded(data), None, np.random.RandomState(0))
    from virtex_tpu_torch.data.native_pipeline import EvalPipeline
    out, _ = EvalPipeline(native.DataPlane("libjpeg"), 64).batch([data],
                                                                 [None])
    assert out.shape == (1,) + ref.shape
    assert np.abs(out[0] - ref).mean() < 0.25  # normalized units


def test_encode_round_trip_of_a_smooth_image():
    y, x = np.mgrid[0:120, 0:160].astype(np.float32)
    img = np.stack([100 + 60 * np.sin(x / 25), 120 + 50 * np.cos(y / 30),
                    90 + 40 * np.sin((x + y) / 40)], -1).astype(np.uint8)
    plane = native.DataPlane("libjpeg")
    data = plane.encode_jpeg(img, 95)
    assert plane.jpeg_dims(data) == (120, 160)
    out = plane.decode(data)
    np.testing.assert_array_equal(out, _decoded(data))
    assert np.abs(out.astype(np.float32) - img).mean() < 1.0


def test_a_bad_jpeg_in_a_batch_raises():
    plane = native.DataPlane("libjpeg")
    with pytest.raises(ValueError, match="1/2"):
        plane.batch_transform([_jpeg(), b"not a jpeg"], np.zeros((2, 4)),
                              np.zeros(2), 16)
    with pytest.raises(ValueError, match="not a decodable JPEG"):
        plane.jpeg_dims(b"not a jpeg")


def test_missing_decoder_raises_and_names_it(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="nvjpeg.h"):
        native.DataPlane("nvjpeg")
    with pytest.raises(ValueError, match="unknown decoder"):
        native.DataPlane("pil")
    # libjpeg wherever it is installed, beside a card too
    assert native.decoder_for("cuda:0") == "libjpeg"
    assert native.decoder_for(torch.device("cpu")) == "libjpeg"
    # without it: nvJPEG for a card that has it, else an error naming both
    monkeypatch.setattr(native.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="libjpeg.so.*nvjpeg.h"):
        native.decoder_for("cuda:0")
    with pytest.raises(RuntimeError, match="missing: libjpeg.so$"):
        native.decoder_for("cpu")
    with pytest.raises(RuntimeError, match="libjpeg.so"):
        native.DataPlane("libjpeg")
    for part in ("include/nvjpeg.h", "lib64/libnvjpeg.so"):
        (tmp_path / part).parent.mkdir(exist_ok=True)
        (tmp_path / part).touch()
    assert native.decoder_for("cuda") == "nvjpeg"
    with pytest.raises(RuntimeError, match="no JPEG decoder for a run on cpu"):
        native.decoder_for("cpu")


@pytest.mark.parametrize("index,name", enumerate(REFERENCE_IMAGES))
def test_libjpeg_gives_the_committed_jpeg_reference(index, name):
    """tests/fixtures/torch_jpeg_reference.npz, against which chip_smoke.py
    holds the card's decoder, is libjpeg's output bit for bit: each image's
    decode, and its slot of both batch_transform outputs."""
    ref = np.load(reference.PATH)
    assert str(ref["names"][index]) == name
    jpegs = [ref[f"jpeg_{i}"].tobytes() for i in range(len(ref["names"]))]
    pixels, out_u8, out_f32 = reference.outputs(
        native.DataPlane("libjpeg"), jpegs, ref["rects"], ref["flips"],
        ref["jitters"])
    np.testing.assert_array_equal(pixels[index], ref[f"pixels_{index}"])
    np.testing.assert_array_equal(_decoded(jpegs[index]), pixels[index])
    np.testing.assert_array_equal(out_u8[index], ref["out_uint8"][index])
    np.testing.assert_array_equal(out_f32[index], ref["out_float32"][index])


@pytest.mark.parametrize("names,kind", [
    (["random_resized_crop", "horizontal_flip", "color_jitter",
      "normalize"], TrainTransforms),
    (["random_resized_crop::{'scale': (0.08, 1.0)}", "horizontal_flip",
      "normalize"], TrainTransforms),
    (["smallest_resize", "center_crop", "normalize"], EvalTransforms),
    (["smallest_resize", "center_crop"], EvalTransforms),
    (["global_resize", "normalize"], ValueError),
    (["horizontal_flip", "random_resized_crop"], ValueError),
    (["random_resized_crop", "normalize", "horizontal_flip"], ValueError),
    (["random_resized_crop::{'size': 3}", "horizontal_flip"], ValueError),
    (["center_crop", "smallest_resize"], ValueError),
])
def test_transform_lists(names, kind):
    if kind is ValueError:
        with pytest.raises(ValueError):
            parse_transforms(names)
    else:
        t = parse_transforms(names)
        assert isinstance(t, kind)
        if "::" in names[0]:
            assert t.scale == (0.08, 1.0) and t.jitter is None


@pytest.mark.parametrize("background", [False, True])
def test_state_dict_resume_gives_the_same_stream(coco, background):
    ds = PretrainingDatasetFactory.from_config(
        Config(override_list=_overrides(coco, "bicaptioning")),
        native.DataPlane("libjpeg"), "train")
    loader = DataLoader(ds, 3, background=background, seed=SEED)
    it = iter(loader)
    head = [next(it) for _ in range(3)]
    state = loader.state_dict()
    assert state == {"items_consumed": 9}
    tail = [next(it) for _ in range(3)]  # across the epoch boundary (8)
    restored = DataLoader(ds, 3, background=background, seed=SEED)
    restored.load_state_dict(state)
    again = _batches(restored, 3)
    for a, b in zip(tail, again):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not all(np.array_equal(a["image"], b["image"])
                   for a, b in zip(head, tail))
    assert item_rng(1, 2, 3).randint(1 << 30) == jax_item_rng(
        1, 2, 3).randint(1 << 30)


_BUILD_AND_LOAD = """
import sys, time
from pathlib import Path
import numpy as np
from virtex_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
plane = native.DataPlane("libjpeg")
img = np.full((16, 16, 3), 128, np.uint8)
assert plane.decode(plane.encode_jpeg(img)).shape == (16, 16, 3)
"""


def test_two_processes_build_the_data_plane_at_once(tmp_path):
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD,
                               str(tmp_path), str(start)], cwd=REPO,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    built = sorted(p.name for p in tmp_path.iterdir())
    assert [n for n in built if n.endswith(".so")] == [
        native.library_path("libjpeg").name]
    assert [n for n in built if not n.endswith(".so")] == [".lock"]
