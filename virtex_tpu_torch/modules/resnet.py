r"""
ResNet trunks that emit the layer4 grid, NHWC at the boundary.

Counterpart of ``virtex_tpu/modules/resnet.py`` (torchvision "v1.5"
layout: stride on the 3×3 conv, ``zero_init_residual`` on the last BN of
each residual branch). Module names are torchvision's, so the reference's
state-dict keys (``layer1.0.bn1.running_var``, ``layer2.0.downsample.0``)
load unchanged.

Input and output are NHWC, as in the JAX package. Inside, the trunk runs
on ``x.permute(0, 3, 1, 2)``: an NCHW view of NHWC memory, i.e. a
``channels_last`` tensor, which ``F.conv2d`` hands to cuDNN as it is.
Parameters and BN statistics are fp32; convs and BN outputs are ``dtype``.
With ``remat`` each residual block runs through
:func:`virtex_tpu_torch.utils.remat.remat` in training: its activations are
recomputed in the backward (``nn.remat`` of the block in the JAX package).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
from virtex_tpu_torch.utils.remat import remat as remat_call


class Conv2d(nn.Conv2d):
    """Bias-free conv with fp32 weights, computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, kernel, stride, padding,
                         groups=groups, bias=False)
        self.dtype = dtype
        # torchvision's kaiming_normal(mode='fan_out', nonlinearity='relu')
        fan_out = out_ch * kernel * kernel
        nn.init.normal_(self.weight, std=math.sqrt(2.0 / fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), w, None, self.stride, self.padding,
                        self.dilation, self.groups)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int, norm,
                 dtype: torch.dtype, base_width: int = 64, groups: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = norm(planes, zero_init=True)
        self.downsample = _downsample(in_planes, planes, stride, norm, dtype,
                                      self.expansion)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int, norm,
                 dtype: torch.dtype, base_width: int = 64, groups: int = 1):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2d(in_planes, width, 1, dtype=dtype)
        self.bn1 = norm(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups,
                            dtype=dtype)
        self.bn2 = norm(width)
        self.conv3 = Conv2d(width, planes * self.expansion, 1, dtype=dtype)
        self.bn3 = norm(planes * self.expansion, zero_init=True)
        self.downsample = _downsample(in_planes, planes, stride, norm, dtype,
                                      self.expansion)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _downsample(in_planes, planes, stride, norm, dtype, expansion):
    if stride == 1 and in_planes == planes * expansion:
        return None
    return nn.Sequential(
        Conv2d(in_planes, planes * expansion, 1, stride, dtype=dtype),
        norm(planes * expansion))


class ResNet(nn.Module):
    r"""ResNet trunk: NHWC image (B, H, W, 3) → NHWC layer4 grid
    (B, H/32, W/32, C_out)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=Bottleneck,
                 num_filters: int = 64, base_width: int = 64,
                 groups: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                 bn_stat_stride: int = 1, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat

        def norm(features, zero_init=False):
            return SubsampledBatchNorm(features, bn_momentum, bn_eps, dtype,
                                       bn_stat_stride, zero_init)

        self.conv1 = Conv2d(3, num_filters, 7, 2, 3, dtype=dtype)
        self.bn1 = norm(num_filters)
        in_planes = num_filters
        for stage, num_blocks in enumerate(stage_sizes):
            planes = num_filters * (2 ** stage)
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(block_cls(in_planes, planes, stride, norm,
                                        dtype, base_width, groups))
                in_planes = planes * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.out_channels = in_planes  # C_out of the grid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC memory, NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = remat_call(block, x) if self.remat else block(x)
        return x.permute(0, 2, 3, 1)


_RESNET_DEFS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block_cls=Bottleneck),
    "wide_resnet50_2": dict(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                            base_width=128),
    "resnext50_32x4d": dict(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                            base_width=4, groups=32),
    "resnext101_32x8d": dict(stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck,
                             base_width=8, groups=32),
}


def make_resnet(name: str, dtype: torch.dtype = torch.bfloat16,
                bn_stat_stride: int = 1, stem_s2d: bool = False,
                remat: bool = False) -> ResNet:
    if name not in _RESNET_DEFS:
        raise ValueError(
            f"Unknown resnet {name!r}; supported: {sorted(_RESNET_DEFS)}")
    if stem_s2d:
        # A TPU layout trick (space-to-depth stem for the MXU); cuDNN
        # takes the stride-2 stem conv as it is.
        raise NotImplementedError("STEM_S2D is a TPU layout; not ported")
    return ResNet(dtype=dtype, bn_stat_stride=bn_stat_stride, remat=remat,
                  **_RESNET_DEFS[name])
