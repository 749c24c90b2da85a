r"""
Visual backbone: an image batch to the layer4 grid.

Counterpart of ``virtex_tpu/modules/visual_backbones.py``
:class:`ResNetVisualBackbone`: NHWC images in (float, or uint8 normalized
here with the ImageNet mean and std in the compute dtype), the NHWC grid
(B, Hg, Wg, C) out, and ``frozen`` (BN on running statistics, no
gradient into the CNN), and :func:`detectron2_backbone_state_dict`, the
Detectron2 export.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from virtex_tpu_torch.modules.resnet import make_resnet

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class ResNetVisualBackbone(nn.Module):
    def __init__(self, name_or_arch: str = "resnet50", frozen: bool = False,
                 dtype: torch.dtype = torch.bfloat16, bn_stat_stride: int = 1,
                 stem_s2d: bool = False, remat: bool = False):
        super().__init__()
        self.frozen, self.dtype = frozen, dtype
        self.cnn = make_resnet(name_or_arch, dtype=dtype,
                               bn_stat_stride=bn_stat_stride,
                               stem_s2d=stem_s2d, remat=remat)
        if frozen:
            self.cnn.requires_grad_(False)
            self.cnn.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.frozen:
            self.cnn.eval()  # a frozen CNN keeps its running statistics
        return self

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        if not torch.is_floating_point(image):
            mean = torch.tensor(_IMAGENET_MEAN, dtype=self.dtype,
                                device=image.device)
            std = torch.tensor(_IMAGENET_STD, dtype=self.dtype,
                               device=image.device)
            image = (image.to(self.dtype) / 255.0 - mean) / std
        return self.cnn(image)


# torchvision's names within a block → Detectron2's
_D2_BLOCK = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
             "bn1": "conv1.norm", "bn2": "conv2.norm", "bn3": "conv3.norm",
             "downsample.0": "shortcut", "downsample.1": "shortcut.norm"}
_BLOCK_KEY = re.compile(r"layer(\d+)\.(\d+)\.(.+)\.(\w+)")


def detectron2_name(name: str) -> str:
    """A ResNet state-dict name (torchvision's) → Detectron2's: the stem
    under ``stem.conv1`` (its BatchNorm ``stem.conv1.norm``), ``layer<k>``
    → ``res<k+1>``, each ``bn<i>`` under ``conv<i>.norm``, the downsample
    as ``shortcut`` (its BatchNorm ``shortcut.norm``)."""
    if name.startswith(("conv1.", "bn1.")):
        return ("stem.conv1." if name.startswith("conv1.")
                else "stem.conv1.norm.") + name.split(".", 1)[1]
    m = _BLOCK_KEY.fullmatch(name)
    if not m or m.group(3) not in _D2_BLOCK:
        raise KeyError(f"not a ResNet entry: {name!r}")
    stage, block, module, entry = m.groups()
    return f"res{int(stage) + 1}.{block}.{_D2_BLOCK[module]}.{entry}"


def detectron2_backbone_state_dict(visual: ResNetVisualBackbone
                                   ) -> Dict[str, Any]:
    r"""The backbone's ResNet in Detectron2's names, as
    ``virtex_tpu.modules.visual_backbones.detectron2_backbone_state_dict``
    exports it: ``{"model": {name: np.ndarray}, "__author__":
    "virtex_tpu", "matching_heuristics": True}``, the arrays fp32 in the
    torch layout (convolutions OIHW), the BatchNorms' weight, bias and
    running statistics (no ``num_batches_tracked``)."""
    out: Dict[str, np.ndarray] = {}
    for name, value in visual.cnn.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        out[detectron2_name(name)] = np.ascontiguousarray(
            value.detach().float().cpu().numpy())
    return {"model": out, "__author__": "virtex_tpu",
            "matching_heuristics": True}
