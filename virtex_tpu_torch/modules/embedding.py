r"""
Word + positional embedding for caption tokens.

Counterpart of ``virtex_tpu/modules/embedding.py``: word and position
tables summed in the compute dtype, LayerNorm (eps 1e-8) in fp32 and cast
back, dropout (bits from the caller's ``generator``), then pad positions
zeroed. :meth:`attend` is the
weight-tied output projection. ``position_offset`` serves KV-cached
decoding, where one token sits at a later position.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from virtex_tpu_torch.modules.transformer import dropout


class WordAndPositionalEmbedding(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int,
                 dropout: float = 0.0, max_caption_length: int = 30,
                 padding_idx: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.padding_idx, self.dropout, self.dtype = padding_idx, dropout, dtype
        self.words = nn.Embedding(vocab_size, hidden_size)
        self.positions = nn.Embedding(max_caption_length, hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-8)
        # BERT-style N(0, 0.02); the padding row starts at zero.
        nn.init.normal_(self.words.weight, std=0.02)
        nn.init.normal_(self.positions.weight, std=0.02)
        with torch.no_grad():
            self.words.weight[padding_idx].zero_()

    def forward(self, tokens: torch.Tensor, position_offset: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Embed ``tokens`` (B, T) → (B, T, H) in the compute dtype."""
        T = tokens.shape[-1]
        pos = torch.arange(T, device=tokens.device) + position_offset
        x = (F.embedding(tokens, self.words.weight).to(self.dtype)
             + F.embedding(pos, self.positions.weight).to(self.dtype))
        ln = self.layer_norm
        x = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                         ln.eps).to(self.dtype)
        x = dropout(x, self.dropout if self.training else 0.0, generator)
        return x * (tokens != self.padding_idx).unsqueeze(-1).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Weight-tied output projection: (…, H) @ tableᵀ → (…, vocab)."""
        return F.linear(x.to(self.dtype), self.words.weight.to(self.dtype))
