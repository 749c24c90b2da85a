r"""
The masked language modeling pretraining dataset.

Counterpart of ``virtex_tpu/data/datasets/masked_lm.py``, with its draws in
the same order after the image's: choose ``ceil((len − 2) · proportion)``
inner positions (never [SOS] or [EOS]); with one position it is always
[MASK]ed, else each draws a flag: [MASK] with probability
``mask_probability``, a random token with ``replace_probability`` (one more
draw), else kept. Labels hold the original token where [MASK] went, padding
elsewhere.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from virtex_tpu_torch.data.datasets._common import (
    CaptionDatasetBase,
    pad_stack,
    tokens_of,
)
from virtex_tpu_torch.data.readers import CocoCaptionsReader


class MaskedLmDataset(CaptionDatasetBase):
    def __init__(self, data_root: str, split: str, tokenizer, pipeline,
                 max_caption_length: int = 30, mask_proportion: float = 0.15,
                 mask_probability: float = 0.85,
                 replace_probability: float = 0.10):
        super().__init__(CocoCaptionsReader(data_root, split), tokenizer,
                         pipeline, max_caption_length)
        self.mask_id = tokenizer.token_to_id("[MASK]")
        self._vocab_size = tokenizer.get_vocab_size()
        self._mask_proportion = mask_proportion
        self._mask_prob = mask_probability
        self._repl_prob = replace_probability

    def _pack(self, image_id, image, caption, rng) -> Dict[str, np.ndarray]:
        tokens = tokens_of(self, caption)
        masked_labels = [self.padding_idx] * len(tokens)
        n_to_mask = math.ceil(max(0, len(tokens) - 2) * self._mask_proportion)
        if n_to_mask > 0:
            positions = rng.choice(np.arange(1, len(tokens) - 1),
                                   size=n_to_mask, replace=False)
            for i in positions:
                if n_to_mask == 1:
                    masked_labels[i] = tokens[i]
                    tokens[i] = self.mask_id
                    continue
                flag = rng.uniform()
                if flag <= self._mask_prob:
                    masked_labels[i] = tokens[i]
                    tokens[i] = self.mask_id
                elif flag <= self._mask_prob + self._repl_prob:
                    tokens[i] = int(rng.randint(self._vocab_size))
        return {
            "image_id": np.asarray(image_id, dtype=np.int32),
            "image": image,
            "caption_tokens": np.asarray(tokens, dtype=np.int32),
            "masked_labels": np.asarray(masked_labels, dtype=np.int32),
            "caption_lengths": np.asarray(len(tokens), dtype=np.int32),
        }

    def collate_fn(self, data: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
        T = self.max_caption_length
        return {
            "image_id": np.stack([d["image_id"] for d in data]),
            "image": np.stack([d["image"] for d in data]),
            "caption_tokens": pad_stack([d["caption_tokens"] for d in data],
                                        T, self.padding_idx),
            "masked_labels": pad_stack([d["masked_labels"] for d in data], T,
                                       self.padding_idx),
            "caption_lengths": np.stack([d["caption_lengths"] for d in data]),
        }
