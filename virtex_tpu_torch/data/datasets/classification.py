r"""
The classification pretraining datasets.

Counterpart of ``virtex_tpu/data/datasets/classification.py``:

- :class:`TokenClassificationDataset`: a caption's tokens as its image's
  label set;
- :class:`MultiLabelClassificationDataset`: the COCO categories of each
  image from ``instances_{split}2017.json``, category ids mapped to 1..80 in
  file order, 0 as padding, images without an instance dropped. Its images
  go through the same data plane as the caption datasets' (the JAX package
  runs its cv2 transforms for this one dataset); the draws are the image
  augmentation's only.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from virtex_tpu_torch.data.datasets._common import (
    CaptionDatasetBase,
    pad_stack,
    tokens_of,
)
from virtex_tpu_torch.data.readers import CocoCaptionsReader


class TokenClassificationDataset(CaptionDatasetBase):
    def __init__(self, data_root: str, split: str, tokenizer, pipeline,
                 max_caption_length: int = 30):
        super().__init__(CocoCaptionsReader(data_root, split), tokenizer,
                         pipeline, max_caption_length)

    def _pack(self, image_id, image, caption, rng) -> Dict[str, np.ndarray]:
        return {
            "image_id": np.asarray(image_id, dtype=np.int32),
            "image": image,
            "labels": np.asarray(tokens_of(self, caption), dtype=np.int32),
        }

    def collate_fn(self, data: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
        return {
            "image_id": np.stack([d["image_id"] for d in data]),
            "image": np.stack([d["image"] for d in data]),
            "labels": pad_stack([d["labels"] for d in data],
                                self.max_caption_length, self.padding_idx),
        }


class MultiLabelClassificationDataset:
    # Static label-set width: a COCO image has at most 80 categories.
    MAX_LABELS = 80

    def __init__(self, data_root: str, split: str, pipeline):
        self.pipeline = pipeline
        self.padding_idx = 0
        with open(os.path.join(data_root, "annotations",
                               f"instances_{split}2017.json")) as f:
            coco = json.load(f)
        slot_of: Dict[int, int] = {}
        for cat in coco["categories"]:
            slot_of[cat["id"]] = len(slot_of) + 1
        slots_by_image: Dict[int, set] = {}
        for ann in coco["annotations"]:
            slots_by_image.setdefault(ann["image_id"], set()).add(
                slot_of[ann["category_id"]])
        # sorted: the index order is part of the determinism contract
        self._samples: List[Tuple[int, str, Tuple[int, ...]]] = []
        for path in sorted(glob.glob(os.path.join(data_root, f"{split}2017",
                                                  "*.jpg"))):
            image_id = int(os.path.splitext(os.path.basename(path))[0])
            slots = slots_by_image.get(image_id)
            if slots:
                self._samples.append((image_id, path, tuple(sorted(slots))))

    def __len__(self) -> int:
        return len(self._samples)

    def get_batch(self, indices, rngs) -> List[Dict[str, np.ndarray]]:
        samples = [self._samples[i] for i in indices]
        jpegs = []
        for _, path, _ in samples:
            with open(path, "rb") as f:
                jpegs.append(f.read())
        images, _ = self.pipeline.batch(jpegs, [None] * len(jpegs), rngs)
        return [{"image_id": np.asarray(image_id, dtype=np.int32),
                 "image": image,
                 "labels": np.asarray(labels, dtype=np.int32)}
                for (image_id, _, labels), image in zip(samples, images)]

    def collate_fn(self, data: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
        return {
            "image_id": np.stack([d["image_id"] for d in data]),
            "image": np.stack([d["image"] for d in data]),
            "labels": pad_stack([d["labels"] for d in data], self.MAX_LABELS,
                                self.padding_idx),
        }
