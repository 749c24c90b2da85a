r"""
Captioning pretext-task models (forward-only and bidirectional = VirTex).

Counterpart of ``virtex_tpu/models/captioning.py``: the loss is the
token cross-entropy of ``logits[:, :-1]`` against ``tokens[:, 1:]``
over non-pad targets, in fp32, with the JAX package's hand-written
gradient; bicaptioning adds the same loss on the reversed tokens through
``backward_textual``. In training, ``generator`` draws the dropout bits. In eval mode the output
also holds the argmax predictions. ``encode_visual`` / ``init_decode`` /
``decode_step`` serve the caption decoder.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from virtex_tpu_torch.modules.textual_heads import TransformerTextualHead
from virtex_tpu_torch.ops._mesh import mean_denominator
from virtex_tpu_torch.modules.transformer import Cache
from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone
from virtex_tpu_torch.utils.tracing import span


class _TokenCE(torch.autograd.Function):
    """The JAX package's ``_token_ce`` custom VJP: the loss is reduced in
    fp32 as logsumexp − target logit, and the gradient
    (softmax − onehot)·g·mask/denom is emitted in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets, ignore_index):
        lse = torch.logsumexp(logits.float(), dim=-1)
        tgt = logits.gather(-1, targets[..., None])[..., 0].float()
        mask = (targets != ignore_index).float()
        denom = mean_denominator(mask.sum())
        ctx.save_for_backward(logits, targets, lse, mask, denom)
        return ((lse - tgt) * mask).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse, mask, denom = ctx.saved_tensors
        scale = (g * mask / denom)[..., None]
        # softmax in a new fp32 tensor (torch.sub allocates), then − onehot
        d = torch.sub(logits, lse[..., None]).exp_()
        d.scatter_add_(-1, targets[..., None], -torch.ones_like(scale))
        return d.mul_(scale).to(logits.dtype), None, None


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        ignore_index: int) -> torch.Tensor:
    """Mean CE over targets ≠ ``ignore_index``, reduced in fp32 as
    logsumexp − target logit (no (B, T, V) log-prob tensor). Under data
    parallelism the mean is over the global batch's targets
    (:func:`~virtex_tpu_torch.ops._mesh.mean_denominator`)."""
    return _TokenCE.apply(logits, targets.long(), int(ignore_index))


class CaptioningModel(nn.Module):
    r"""Visual backbone + autoregressive textual head;
    ``caption_backward=True`` is bicaptioning (the VirTex flagship)."""

    def __init__(self, visual: ResNetVisualBackbone,
                 textual: TransformerTextualHead,
                 caption_backward: bool = False, sos_index: int = 1,
                 eos_index: int = 2, padding_idx: int = 0):
        super().__init__()
        self.visual, self.textual = visual, textual
        self.caption_backward = caption_backward
        self.sos_index, self.eos_index = sos_index, eos_index
        self.padding_idx = padding_idx
        if caption_backward:
            self.backward_textual = textual.backward_head()

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        image = batch["image"]
        with span("visual", image):
            visual_grid = self.visual(image)
        tokens, lengths = batch["caption_tokens"], batch["caption_lengths"]
        with span("textual", image):
            logits = self.textual(visual_grid, tokens, lengths, generator)
        loss = token_cross_entropy(logits[:, :-1], tokens[:, 1:],
                                   self.padding_idx)
        components = {"captioning_forward": loss}
        if self.caption_backward:
            noitpac = batch["noitpac_tokens"]
            with span("backward_textual", image):
                backward_logits = self.backward_textual(
                    visual_grid, noitpac, lengths, generator)
            backward_loss = token_cross_entropy(
                backward_logits[:, :-1], noitpac[:, 1:], self.padding_idx)
            components["captioning_backward"] = backward_loss
            loss = loss + backward_loss
        out = {"loss": loss, "loss_components": components}
        if not self.training:
            out["predictions"] = logits.argmax(dim=-1)
        return out

    # -- inference -----------------------------------------------------------
    def encode_visual(self, image: torch.Tensor) -> torch.Tensor:
        with span("visual", image):
            return self.visual(image)

    def init_decode(self, visual_grid, max_length: Optional[int] = None
                    ) -> List[Cache]:
        return self.textual.init_decode(visual_grid, max_length)

    def decode_step(self, token, position: int, caches: List[Cache]):
        """Forward-direction single decode step (the search callback)."""
        return self.textual.decode_step(token, position, caches)


class ForwardCaptioningModel(CaptioningModel):
    """``MODEL.NAME: captioning``: the forward direction only."""

    def __init__(self, visual, textual, **kwargs):
        super().__init__(visual, textual, caption_backward=False, **kwargs)


class BidirectionalCaptioningModel(CaptioningModel):
    """``MODEL.NAME: virtex`` or ``bicaptioning``."""

    def __init__(self, visual, textual, **kwargs):
        super().__init__(visual, textual, caption_backward=True, **kwargs)
