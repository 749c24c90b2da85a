r"""
Classification pretext tasks: token classification (a caption's tokens as
an unordered label set) and multi-label classification (COCO instance
categories).

Counterpart of ``virtex_tpu/models/classification.py``: log-softmax over
the vocabulary in fp32, and the loss is the negative mean log-probability
of each instance's *unique* valid labels, averaged over the instances that
have any. In eval mode the output also holds the top-10 predictions.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from virtex_tpu_torch.modules.textual_heads import LinearTextualHead
from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone
from virtex_tpu_torch.ops._mesh import mean_denominator
from virtex_tpu_torch.utils.beam_search import topk


def instance_label_set_loss(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_indices: Sequence[int]) -> torch.Tensor:
    """−mean_i ( mean_{c ∈ unique(labels_i) \\ ignore} logp_i[c] ), over the
    instances with at least one valid label (the global batch's under data
    parallelism).

    ``labels`` (B, L) is padded with entries of ``ignore_indices``. The
    labels are scattered into a (B, V) multi-hot (duplicates collapse),
    never a (B, L, V) one-hot."""
    B, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = torch.ones_like(labels, dtype=torch.bool)
    for ig in ignore_indices:
        valid &= labels != ig
    multihot = torch.zeros((B, V), dtype=torch.float32, device=logits.device)
    multihot.scatter_reduce_(1, labels, valid.float(), reduce="amax")
    count = multihot.sum(dim=-1)
    per_instance = -(logp * multihot).sum(dim=-1) / count.clamp(min=1.0)
    has_any = (count > 0).float()
    return (per_instance * has_any).sum() / mean_denominator(has_any.sum())


class ClassificationModel(nn.Module):
    """Visual backbone + :class:`LinearTextualHead` to vocabulary (or
    category) logits."""

    def __init__(self, visual: ResNetVisualBackbone,
                 textual: LinearTextualHead,
                 ignore_indices: Tuple[int, ...] = ()):
        super().__init__()
        self.visual, self.textual = visual, textual
        self.ignore_indices = tuple(ignore_indices)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """``generator`` is taken and unused (the head has no dropout), so
        that every model trains through one train step."""
        logits = self.textual(self.visual(batch["image"]))
        loss = instance_label_set_loss(logits, batch["labels"],
                                       self.ignore_indices)
        out = {"loss": loss, "loss_components": {"classification": loss}}
        if not self.training:
            # ties to the lowest index, as lax.top_k breaks them
            out["predictions"] = topk(logits, 10)[1]
        return out


class TokenClassificationModel(ClassificationModel):
    """Labels are caption token ids; the factory ignores (UNK, SOS, EOS,
    MASK)."""


class MultiLabelClassificationModel(ClassificationModel):
    """Labels are COCO categories 1..80; the factory ignores 0 (padding)."""
