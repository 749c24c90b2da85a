r"""
The captioning pretraining dataset: images with their caption's tokens,
forward and reversed.

Counterpart of ``virtex_tpu/data/datasets/captioning.py``: NHWC images,
captions as ``[SOS] … [EOS]`` cut to ``max_caption_length`` and padded to
it with ``<unk>`` (0) at collate time, and ``noitpac_tokens``, the valid
part reversed, for bicaptioning's backward direction.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from virtex_tpu_torch.data.datasets._common import (
    CaptionDatasetBase,
    pad_stack,
    tokens_of,
)
from virtex_tpu_torch.data.readers import CocoCaptionsReader


class CaptioningDataset(CaptionDatasetBase):
    r"""
    Args:
        data_root: the COCO directory.
        split: "train" or "val".
        tokenizer: a :class:`~virtex_tpu_torch.data.tokenizers.SentencePieceBPETokenizer`.
        pipeline: the image pipeline
            (:func:`~virtex_tpu_torch.data.native_pipeline.make_pipeline`).
        max_caption_length: tokens past this are cut from the right.
    """

    def __init__(self, data_root: str, split: str, tokenizer, pipeline,
                 max_caption_length: int = 30):
        super().__init__(CocoCaptionsReader(data_root, split), tokenizer,
                         pipeline, max_caption_length)

    def _pack(self, image_id, image, caption, rng) -> Dict[str, np.ndarray]:
        tokens = tokens_of(self, caption)
        return {
            "image_id": np.asarray(image_id, dtype=np.int32),
            "image": image,
            "caption_tokens": np.asarray(tokens, dtype=np.int32),
            "noitpac_tokens": np.asarray(tokens[::-1], dtype=np.int32),
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
            "noitpac_tokens": pad_stack([d["noitpac_tokens"] for d in data],
                                        T, self.padding_idx),
            "caption_lengths": np.stack([d["caption_lengths"] for d in data]),
        }
