r"""
``torch.hub`` entry points of the PyTorch port: a pretrained VirTex
ResNet-50 as a feature extractor.

Counterpart of the repository's root ``hubconf.py`` (the JAX package's):
the visual backbone of ``width_ablations/bicaptioning_R_50_L1_H1024``,
its weights from the zoo (``$VIRTEX_TPU_ZOO_DIR``, see
:mod:`virtex_tpu_torch.model_zoo`), emitting the layer4 grid, built on the
card unless ``device`` says otherwise:

    >>> extract = torch.hub.load("<repo>/virtex_tpu_torch",
    ...                          "resnet50_extractor", source="local",
    ...                          pretrained=True)
    >>> extract(images).shape      # NHWC or NCHW float images of 224²
    torch.Size([B, 7, 7, 2048])
"""
from __future__ import annotations

import os
import sys

dependencies = ["torch", "numpy"]

_ZOO_CONFIG = "width_ablations/bicaptioning_R_50_L1_H1024.yaml"

# torch.hub puts this directory on the path; the package is its parent's.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def resnet50(pretrained: bool = False, device=None, **kwargs):
    """The flagship's visual backbone (``model.visual``) in eval mode:
    NHWC images (B, H, W, 3) → the (B, H/32, W/32, 2048) grid."""
    from virtex_tpu_torch import model_zoo

    model, _ = model_zoo.get(_ZOO_CONFIG, pretrained=pretrained,
                             device=device)
    return model.visual.eval()


def resnet50_extractor(pretrained: bool = False, device=None, **kwargs):
    """One callable, ``f(images) → (B, 7, 7, 2048)`` features at 224²,
    NHWC: ``images`` is a float array or tensor, NHWC, or NCHW (told
    apart by the channel axis), moved to the backbone's device."""
    import numpy as np
    import torch

    visual = resnet50(pretrained=pretrained, device=device)
    device = next(visual.parameters()).device

    @torch.inference_mode()
    def extractor(images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        images = images.to(device, torch.float32)
        if images.dim() != 4:
            raise ValueError(f"expected (B, H, W, 3) images, got "
                             f"{tuple(images.shape)}")
        if images.shape[1] == 3 and images.shape[-1] != 3:
            # NCHW → NHWC memory, as an NHWC input lies
            images = images.permute(0, 2, 3, 1).contiguous()
        return visual(images)

    return extractor
