r"""
The image transforms of a config, as the parameters of the data plane's one
image path.

Counterpart of what ``virtex_tpu/data/native_pipeline.py`` takes from
``virtex_tpu/data/transforms.py``: the ImageNet constants,
:meth:`HorizontalFlip.swap_words` and :func:`clamped_center_crop`. The
JAX package's cv2 transform stack is not ported. A ``DATA.IMAGE_TRANSFORM_*``
list is read by :func:`parse_transforms` into a :class:`TrainTransforms`
or :class:`EvalTransforms`, and a list that the data plane cannot express
raises.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional, Tuple, Union

IMAGENET_COLOR_MEAN = (0.485, 0.456, 0.406)
IMAGENET_COLOR_STD = (0.229, 0.224, 0.225)
# The eval path's resize before its centre crop, as the JAX package's native
# eval pipeline fixes it.
EVAL_RESIZE = 256


class HorizontalFlip:
    @staticmethod
    def swap_words(caption: str) -> str:
        """Swap "left" and "right" as substrings, anywhere ("bright" →
        "bleft"), as the reference's paired flip does."""
        return (caption.replace("left", "[TMP]").replace("right", "left")
                .replace("[TMP]", "right"))


def clamped_center_crop(h: int, w: int, ratio: Tuple[float, float]
                        ) -> Tuple[int, int]:
    """(crop_h, crop_w) of the torchvision RandomResizedCrop fallback: the
    whole image if its aspect is within ``ratio``, else clamped to the
    nearer bound."""
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, min(h, int(round(w / ratio[0])))
    elif in_ratio > ratio[1]:
        ch, cw = h, min(w, int(round(h * ratio[1])))
    else:
        ch, cw = h, w
    return ch, cw


@dataclasses.dataclass(frozen=True)
class Jitter:
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.1
    p: float = 0.8


@dataclasses.dataclass(frozen=True)
class TrainTransforms:
    """random_resized_crop → horizontal_flip → [color_jitter] → normalize."""
    scale: Tuple[float, float] = (0.2, 1.0)
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    flip_p: float = 0.5
    jitter: Optional[Jitter] = Jitter()
    mean: Tuple[float, ...] = IMAGENET_COLOR_MEAN
    std: Tuple[float, ...] = IMAGENET_COLOR_STD
    normalize: bool = True


@dataclasses.dataclass(frozen=True)
class EvalTransforms:
    """smallest_resize(256) → center_crop → normalize, as one crop of the
    centred ``min(h, w)·crop/256`` square."""
    mean: Tuple[float, ...] = IMAGENET_COLOR_MEAN
    std: Tuple[float, ...] = IMAGENET_COLOR_STD
    normalize: bool = True


_KWARGS = {"random_resized_crop": {"scale", "ratio", "p"},
           "horizontal_flip": {"p"},
           "color_jitter": {"brightness", "contrast", "saturation", "hue",
                            "p"},
           "normalize": {"mean", "std", "p"},
           "smallest_resize": set(),
           "center_crop": set()}
_TRAIN_ORDER = ("random_resized_crop", "horizontal_flip", "color_jitter",
                "normalize")
_EVAL_ORDER = ("smallest_resize", "center_crop", "normalize")


def _parse_name(name: str):
    base, _, extra = name.partition("::")
    if base not in _KWARGS:
        raise ValueError(f"image transform {base!r} is not on the data "
                         f"plane's path; it takes {sorted(_KWARGS)}")
    kwargs = ast.literal_eval(extra) if extra else {}
    if not isinstance(kwargs, dict) or set(kwargs) - _KWARGS[base]:
        raise ValueError(f"image transform {name!r}: {base} takes "
                         f"{sorted(_KWARGS[base]) or 'no'} arguments")
    if kwargs.get("p", 1.0) != 1.0 and base in ("random_resized_crop",
                                                 "normalize"):
        raise ValueError(f"image transform {name!r}: p must be 1.0")
    return base, kwargs


def parse_transforms(names: Iterable[str]
                     ) -> Union[TrainTransforms, EvalTransforms]:
    """A ``DATA.IMAGE_TRANSFORM_*`` list → the data plane's parameters.
    Takes the two lists the JAX package's native pipelines run (and the
    optional stages of the train list, with ``"name::{kwargs}"``
    arguments); raises on any other list."""
    parsed = [_parse_name(n) for n in names]
    bases = [b for b, _ in parsed]
    kw = dict(parsed)
    if bases and bases[0] == "random_resized_crop":
        order = [b for b in _TRAIN_ORDER if b in bases]
        if bases != order or "horizontal_flip" not in bases:
            raise ValueError(f"train transforms {list(names)}: the data "
                             f"plane runs {list(_TRAIN_ORDER)} in this order "
                             "(color_jitter and normalize optional)")
        crop, norm = kw["random_resized_crop"], kw.get("normalize", {})
        jitter = ({k: v for k, v in kw["color_jitter"].items()}
                  if "color_jitter" in kw else None)
        return TrainTransforms(
            scale=tuple(crop.get("scale", (0.2, 1.0))),
            ratio=tuple(crop.get("ratio", (0.75, 4.0 / 3.0))),
            flip_p=float(kw["horizontal_flip"].get("p", 0.5)),
            jitter=None if jitter is None else Jitter(**jitter),
            mean=tuple(norm.get("mean", IMAGENET_COLOR_MEAN)),
            std=tuple(norm.get("std", IMAGENET_COLOR_STD)),
            normalize="normalize" in kw)
    if bases in (list(_EVAL_ORDER), list(_EVAL_ORDER[:2])):
        norm = kw.get("normalize", {})
        return EvalTransforms(mean=tuple(norm.get("mean", IMAGENET_COLOR_MEAN)),
                              std=tuple(norm.get("std", IMAGENET_COLOR_STD)),
                              normalize="normalize" in kw)
    raise ValueError(f"image transforms {list(names)}: the data plane runs "
                     f"{list(_TRAIN_ORDER)} or {list(_EVAL_ORDER)}")
