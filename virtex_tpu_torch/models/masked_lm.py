r"""
Masked language modeling pretext task.

Counterpart of ``virtex_tpu/models/masked_lm.py``: a
:class:`TransformerTextualHead` that does not mask future positions runs
over the (partly ``[MASK]``ed) caption tokens with cross-attention to the
visual grid, and the token cross-entropy runs over every position against
``masked_labels``, which hold ``padding_idx`` wherever no token was
masked. In eval mode the predictions are the argmax where a label is set
and ``padding_idx`` elsewhere.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from virtex_tpu_torch.models.captioning import token_cross_entropy
from virtex_tpu_torch.modules.textual_heads import TransformerTextualHead
from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone


class MaskedLMModel(nn.Module):
    def __init__(self, visual: ResNetVisualBackbone,
                 textual: TransformerTextualHead, padding_idx: int = 0):
        super().__init__()
        if textual.mask_future_positions:
            raise ValueError("masked LM needs a head built with "
                             "mask_future_positions=False")
        self.visual, self.textual = visual, textual
        self.padding_idx = padding_idx

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        visual_grid = self.visual(batch["image"])
        labels = batch["masked_labels"]
        logits = self.textual(visual_grid, batch["caption_tokens"],
                              batch["caption_lengths"], generator)
        loss = token_cross_entropy(logits, labels, self.padding_idx)
        out = {"loss": loss, "loss_components": {"masked_lm": loss}}
        if not self.training:
            out["predictions"] = torch.where(
                labels != self.padding_idx, logits.argmax(dim=-1),
                torch.full_like(labels, self.padding_idx))
        return out
