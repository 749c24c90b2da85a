r"""What the caption datasets share: one random caption per visit, then the
image pipeline over the whole batch in one native call."""
from __future__ import annotations

from typing import List

import numpy as np


def load_image_caption_batch(reader, indices, rngs, pipeline) -> List[tuple]:
    """→ ``(image_id, image, caption)`` per index. Each item's draws come
    in the JAX package's order: the caption, then the image
    augmentation."""
    raws = [reader.raw(i) for i in indices]
    captions = [raw["captions"][rng.randint(len(raw["captions"]))]
                for raw, rng in zip(raws, rngs)]
    images, captions = pipeline.batch([raw["jpeg"] for raw in raws],
                                      captions, rngs)
    return [(raw["image_id"], image, caption)
            for raw, image, caption in zip(raws, images, captions)]


def pad_stack(seqs: List[np.ndarray], length: int, pad_value: int
              ) -> np.ndarray:
    """Right-pad 1-D int sequences to ``length`` and stack them."""
    out = np.full((len(seqs), length), pad_value, dtype=np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = s[:n]
    return out


def tokens_of(dataset, caption: str) -> List[int]:
    """[SOS] caption [EOS], cut to the dataset's ``max_caption_length``."""
    return [dataset.sos_id, *dataset.tokenizer.encode(caption),
            dataset.eos_id][: dataset.max_caption_length]


class CaptionDatasetBase:
    """The reader, tokenizer and pipeline of a caption dataset. Subclasses
    pack each ``(image_id, image, caption, rng)`` in :meth:`_pack`."""

    def __init__(self, reader, tokenizer, pipeline, max_caption_length: int):
        self._dset = reader
        self.tokenizer = tokenizer
        self.pipeline = pipeline
        self.max_caption_length = max_caption_length
        self.padding_idx = tokenizer.token_to_id("<unk>")
        self.sos_id = tokenizer.token_to_id("[SOS]")
        self.eos_id = tokenizer.token_to_id("[EOS]")

    def __len__(self) -> int:
        return len(self._dset)

    def get_batch(self, indices, rngs) -> List[dict]:
        """The items of ``indices``, item i drawing from ``rngs[i]``."""
        return [self._pack(image_id, image, caption, rng)
                for (image_id, image, caption), rng in zip(
                    load_image_caption_batch(self._dset, indices, rngs,
                                             self.pipeline), rngs)]

    def _pack(self, image_id, image, caption, rng) -> dict:
        raise NotImplementedError
