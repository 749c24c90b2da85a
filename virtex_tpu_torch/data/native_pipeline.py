r"""
The image pipelines over the data plane: augmentation parameters drawn from
each item's ``RandomState`` in numpy, the pixel work in one native call per
batch.

Counterpart of ``virtex_tpu/data/native_pipeline.py``. Per item, the draws
come in the JAX package's order: the crop (torchvision's
RandomResizedCrop recipe), the flip, then the color jitter (whether, the op
order, then the factors), so the same ``RandomState`` gives the same
parameters, and with the libjpeg decoder the same pixels.

- train: random resized crop → horizontal flip (swapping "left" and
  "right" in the caption) → color jitter → normalize;
- eval: the centred ``min(h, w)·crop/256`` square, resized to the crop
  (smallest_resize(256) then center_crop in one step) → normalize.

With ``emit_uint8`` the output is the pixels as uint8 and the backbone
normalizes on the device (``DATA.DEVICE_NORMALIZE``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from virtex_tpu_torch.data.transforms import (
    EVAL_RESIZE,
    EvalTransforms,
    HorizontalFlip,
    TrainTransforms,
    clamped_center_crop,
    parse_transforms,
)
from virtex_tpu_torch.native import (
    RAW_MEAN,
    RAW_STD,
    DataPlane,
    jitter_params,
)


def sample_random_resized_crop(h: int, w: int, rng,
                               scale: Tuple[float, float] = (0.2, 1.0),
                               ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
                               ) -> Tuple[int, int, int, int]:
    """(y, x, ch, cw) by the torchvision RandomResizedCrop recipe: ten
    tries at a random area and log-aspect, then the ratio-clamped centre
    crop."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            return y, x, ch, cw
    ch, cw = clamped_center_crop(h, w, ratio)
    return (h - ch) // 2, (w - cw) // 2, ch, cw


class _Pipeline:
    def __init__(self, plane: DataPlane, crop_size: int, mean, std,
                 emit_uint8: bool):
        self.plane = plane
        self.crop_size = crop_size
        self.emit_uint8 = emit_uint8
        self.mean, self.std = ((RAW_MEAN, RAW_STD) if emit_uint8 else
                               (np.asarray(mean, np.float32),
                                np.asarray(std, np.float32)))

    def _run(self, jpegs, rects, flips, jitters=None) -> np.ndarray:
        return self.plane.batch_transform(
            jpegs, rects, flips, self.crop_size, self.mean, self.std,
            jitters=jitters, uint8=self.emit_uint8)


class CaptionTrainPipeline(_Pipeline):
    """(JPEG bytes, caption, rng) per item → (images, captions)."""

    def __init__(self, plane: DataPlane, crop_size: int = 224,
                 transforms: TrainTransforms = TrainTransforms(),
                 emit_uint8: bool = False):
        super().__init__(plane, crop_size, transforms.mean, transforms.std,
                         emit_uint8)
        self.t = transforms

    def _sample_jitter(self, rng) -> Optional[np.ndarray]:
        j = self.t.jitter
        if j is None or rng.uniform() >= j.p:
            return None
        order = rng.permutation(4)
        return jitter_params(
            order,
            rng.uniform(1 - j.brightness, 1 + j.brightness)
            if j.brightness > 0 else 1.0,
            rng.uniform(1 - j.contrast, 1 + j.contrast)
            if j.contrast > 0 else 1.0,
            rng.uniform(1 - j.saturation, 1 + j.saturation)
            if j.saturation > 0 else 1.0,
            rng.uniform(-j.hue, j.hue) if j.hue > 0 else 0.0)

    def batch(self, jpegs: Sequence[bytes],
              captions: Sequence[Optional[str]], rngs
              ) -> Tuple[np.ndarray, List[Optional[str]]]:
        n = len(jpegs)
        rects = np.empty((n, 4), np.int32)
        flips = np.zeros(n, np.int32)
        jitters = np.zeros((n, 9), np.float32)
        out_captions = list(captions)
        for i, (jpeg, rng) in enumerate(zip(jpegs, rngs)):
            h, w = self.plane.jpeg_dims(jpeg)
            rects[i] = sample_random_resized_crop(h, w, rng, self.t.scale,
                                                  self.t.ratio)
            flips[i] = int(rng.uniform() < self.t.flip_p)
            jit = self._sample_jitter(rng)
            if jit is not None:
                jitters[i] = jit
            if flips[i] and out_captions[i] is not None:
                out_captions[i] = HorizontalFlip.swap_words(out_captions[i])
        return self._run(jpegs, rects, flips, jitters), out_captions


class EvalPipeline(_Pipeline):
    """smallest_resize(256) + center_crop + normalize; draws nothing."""

    def __init__(self, plane: DataPlane, crop_size: int = 224,
                 transforms: EvalTransforms = EvalTransforms(),
                 emit_uint8: bool = False):
        super().__init__(plane, crop_size, transforms.mean, transforms.std,
                         emit_uint8)

    def batch(self, jpegs, captions, rngs=None):
        rects = np.empty((len(jpegs), 4), np.int32)
        for i, jpeg in enumerate(jpegs):
            h, w = self.plane.jpeg_dims(jpeg)
            s = int(round(min(h, w) * self.crop_size / EVAL_RESIZE))
            rects[i] = ((h - s) // 2, (w - s) // 2, s, s)
        return (self._run(jpegs, rects, np.zeros(len(jpegs), np.int32)),
                list(captions))


def make_pipeline(names, crop_size: int, plane: DataPlane,
                  device_normalize: bool):
    """The pipeline of a ``DATA.IMAGE_TRANSFORM_*`` list (see
    :func:`virtex_tpu_torch.data.transforms.parse_transforms`). Pixels stay
    uint8 when the device normalizes or the list does not."""
    t = parse_transforms(names)
    uint8 = device_normalize or not t.normalize
    if isinstance(t, TrainTransforms):
        return CaptionTrainPipeline(plane, crop_size, t, uint8)
    return EvalPipeline(plane, crop_size, t, uint8)
