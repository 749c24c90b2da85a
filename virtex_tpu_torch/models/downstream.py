r"""
The transfer model: a visual backbone and a linear classifier.

Counterpart of ``virtex_tpu/models/downstream.py``
:class:`LinearClassifierModel`: the layer4 grid averaged over its positions
in fp32 and rounded to the backbone's dtype, as ``jnp.mean`` of a bf16 grid
returns it, then ``fc``, an fp32 ``Linear(C_out, num_classes)`` drawn from
N(0, 0.01²) with a zero bias, and the mean negative log-softmax of the
labels. With a frozen backbone (the linear probe) its BatchNorm layers keep
their running statistics and no gradient reaches it, in train mode too.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone


class LinearClassifierModel(nn.Module):
    def __init__(self, visual: ResNetVisualBackbone, num_classes: int):
        super().__init__()
        self.visual = visual
        self.fc = nn.Linear(visual.cnn.out_channels, num_classes,
                            dtype=torch.float32)
        nn.init.normal_(self.fc.weight, std=0.01)
        nn.init.zeros_(self.fc.bias)

    def _pooled(self, image: torch.Tensor) -> torch.Tensor:
        grid = self.visual(image)
        return grid.float().mean((1, 2)).to(grid.dtype).float()

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """``generator`` is taken and unused (nothing here drops out), so
        that the model trains through the port's one train step."""
        logits = self.fc(self._pooled(batch["image"]))
        logp = torch.log_softmax(logits, dim=-1)
        labels = batch["label"].long()
        loss = -logp.gather(1, labels[:, None]).mean()
        return {"loss": loss, "loss_components": {"classification": loss},
                "logits": logits, "predictions": logits.argmax(-1)}

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """L2-normalised pooled features (norms floored at 1e-10), with
        BatchNorm on running statistics: what the VOC07 SVMs train on."""
        was_training = self.training
        self.eval()
        try:
            pooled = self._pooled(images)
        finally:
            self.train(was_training)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-10)
