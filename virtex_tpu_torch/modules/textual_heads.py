r"""
Textual heads: the visual grid (and caption tokens) → vocabulary logits.

Counterpart of ``virtex_tpu/modules/textual_heads.py``.
:class:`LinearTextualHead` (the classification tasks) pools the grid and
applies one fp32 linear layer. :class:`TransformerTextualHead`: visual
projection C→H over the flattened
grid, word + position embedding, transformer decoder with
cross-attention to the visual tokens, and an output projection whose
weight is the word table (``output.weight`` is tied to
``embedding.words.weight``) plus an fp32 ``output.bias``.

Bicaptioning's backward direction is a second head from
:meth:`TransformerTextualHead.backward_head` that shares the projection,
embedding and output with this one and owns its own transformer, the way
the reference builds it, so the state dict holds ``backward_textual.*``
beside ``textual.*``. That transformer is initialised on its own, as
``virtex_tpu``'s ``backward_transformer`` is (the torch original starts
both directions from one copy); weights loaded through the bridge replace
it either way.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn

from virtex_tpu_torch.modules.embedding import WordAndPositionalEmbedding
from virtex_tpu_torch.modules.transformer import (
    Cache,
    Linear,
    TransformerDecoder,
    make_self_attention_mask,
)


class LinearTextualHead(nn.Module):
    """Average-pool the (B, Hg, Wg, C) grid, then an fp32 ``Linear`` to
    the vocabulary (weight N(0, 0.02), bias zero)."""

    def __init__(self, visual_feature_size: int, vocab_size: int):
        super().__init__()
        self.output = nn.Linear(visual_feature_size, vocab_size)
        nn.init.normal_(self.output.weight, std=0.02)
        nn.init.zeros_(self.output.bias)

    def forward(self, visual_grid, caption_tokens=None, caption_lengths=None,
                generator: Optional[torch.Generator] = None):
        """(B, Hg, Wg, C) → (B, vocab) fp32 logits. The mean is taken in
        fp32 and rounded to the grid's dtype, as ``jnp.mean`` of a bf16
        grid returns bf16, before the fp32 layer."""
        pooled = visual_grid.float().mean(dim=(1, 2)).to(visual_grid.dtype)
        return self.output(pooled.float())


class TransformerTextualHead(nn.Module):
    def __init__(self, visual_feature_size: int, vocab_size: int,
                 hidden_size: int, num_layers: int, attention_heads: int,
                 feedforward_size: int, dropout: float = 0.1,
                 norm_type: str = "post", mask_future_positions: bool = True,
                 max_caption_length: int = 30, padding_idx: int = 0,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.mask_future_positions = mask_future_positions
        self.max_caption_length = max_caption_length
        self.dtype = dtype
        self.visual_projection = Linear(visual_feature_size, hidden_size,
                                        dtype)
        self.embedding = WordAndPositionalEmbedding(
            vocab_size, hidden_size, dropout, max_caption_length,
            padding_idx, dtype)
        self._transformer_args = (num_layers, hidden_size, attention_heads,
                                  feedforward_size, dropout, norm_type, dtype,
                                  remat)
        self.transformer = TransformerDecoder(*self._transformer_args)
        self.output = nn.Linear(hidden_size, vocab_size)
        self.output.weight = self.embedding.words.weight
        nn.init.zeros_(self.output.bias)

    def backward_head(self) -> "TransformerTextualHead":
        """A head for reversed captions: shares the visual projection, the
        embedding and the tied output with this head; its transformer is
        its own, freshly initialised (from torch's global generator, after
        this head's)."""
        twin = copy.deepcopy(self)
        twin.transformer = TransformerDecoder(*self._transformer_args)
        twin.visual_projection = self.visual_projection
        twin.embedding = self.embedding
        twin.output = self.output
        return twin

    # -- shared pieces -------------------------------------------------------
    def project_visual(self, visual_grid: torch.Tensor) -> torch.Tensor:
        """(B, Hg, Wg, C) NHWC grid → (B, Hg·Wg, H) visual tokens."""
        B, Hg, Wg, C = visual_grid.shape
        return self.visual_projection(
            visual_grid.reshape(B, Hg * Wg, C).to(self.dtype))

    def output_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied projection in the compute dtype, plus the fp32 bias, cast
        back to the compute dtype."""
        logits = self.embedding.attend(hidden)
        return (logits.float() + self.output.bias).to(logits.dtype)

    # -- full-sequence forward -----------------------------------------------
    def forward(self, visual_grid, caption_tokens, caption_lengths,
                generator: Optional[torch.Generator] = None):
        """(B,Hg,Wg,C), (B,T), (B,) → (B, T, vocab). ``generator`` draws
        the dropout bits in training."""
        visual = self.project_visual(visual_grid)
        x = self.embedding(caption_tokens, generator=generator)
        mask = make_self_attention_mask(caption_tokens, caption_lengths,
                                        causal=self.mask_future_positions)
        return self.output_logits(self.transformer(x, visual, mask,
                                                   generator))

    # -- KV-cached decode ----------------------------------------------------
    def init_decode(self, visual_grid, max_length: Optional[int] = None
                    ) -> List[Cache]:
        """Project the visual grid and build each layer's cache."""
        visual = self.project_visual(visual_grid)
        return self.transformer.init_cache(
            visual, visual.shape[0], max_length or self.max_caption_length)

    def decode_step(self, token: torch.Tensor, position: int,
                    caches: List[Cache]):
        """token (B,), position, caches → logits (B, vocab), caches."""
        x = self.embedding(token[:, None], position_offset=position)
        x, caches = self.transformer.decode(x, caches, position)
        return self.output_logits(x[:, 0, :]), caches
