r"""
Visual backbone: an image batch to the layer4 grid.

Counterpart of ``virtex_tpu/modules/visual_backbones.py``
:class:`ResNetVisualBackbone`: NHWC images in (float, or uint8 normalized
here with the ImageNet mean and std in the compute dtype), the NHWC grid
(B, Hg, Wg, C) out, and ``frozen`` (BN on running statistics, no
gradient into the CNN). The Detectron2 export is not ported yet.
"""
from __future__ import annotations

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
