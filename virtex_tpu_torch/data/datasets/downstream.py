r"""
The transfer datasets: ImageNet, iNaturalist 2018, PASCAL VOC 2007, and a
directory of images to caption.

Counterpart of ``virtex_tpu/data/datasets/downstream.py``. Each dataset
reads an item's raw bytes and hands a batch to the data plane's one image
path (an image pipeline of
:mod:`virtex_tpu_torch.data.native_pipeline`), as the caption datasets do.
A file the data plane cannot decode (a PNG, a CMYK JPEG) raises, naming the
file; nothing is skipped.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence

import numpy as np


def read_images(paths: Sequence[str], rngs, pipeline) -> np.ndarray:
    """The images of ``paths`` through ``pipeline`` in one batch call, item
    i drawing from ``rngs[i]``. Raises ValueError naming the first file the
    data plane cannot decode."""
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
    try:
        images, _ = pipeline.batch(blobs, [None] * len(blobs), rngs)
        return images
    except ValueError as batch_error:
        for path, blob in zip(paths, blobs):
            try:
                pipeline.plane.decode(blob)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from batch_error
        raise


class _LabelledImages:
    """(path, label) instances; batches of ``{"image", "label"}``."""

    instances: List[tuple]

    def __init__(self, pipeline):
        self.pipeline = pipeline

    def __len__(self) -> int:
        return len(self.instances)

    def get_batch(self, indices, rngs) -> List[Dict[str, np.ndarray]]:
        picked = [self.instances[i] for i in indices]
        images = read_images([p for p, _ in picked], rngs, self.pipeline)
        return [{"image": image, "label": np.asarray(label, np.int32)}
                for image, (_, label) in zip(images, picked)]

    @staticmethod
    def collate_fn(data: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
        return {"image": np.stack([d["image"] for d in data]),
                "label": np.stack([d["label"] for d in data])}


class ImageNetDataset(_LabelledImages):
    r"""``{data_root}/{split}/{wnid}/*``: class i is the i-th wnid in
    sorted order, and each class's files come in sorted order.

    Args:
        pipeline: the image pipeline (the split's transforms).
    """

    def __init__(self, data_root: str, split: str, pipeline):
        super().__init__(pipeline)
        split_dir = os.path.join(data_root, split)
        wnids = sorted(d for d in os.listdir(split_dir)
                       if os.path.isdir(os.path.join(split_dir, d)))
        self.wnid_to_idx = {wnid: i for i, wnid in enumerate(wnids)}
        self.instances = [
            (path, self.wnid_to_idx[wnid]) for wnid in wnids
            for path in sorted(glob.glob(os.path.join(split_dir, wnid, "*")))]


class INaturalist2018Dataset(_LabelledImages):
    r"""``{data_root}/annotations/{split}2018.json``: an image per
    annotation, labelled with its ``category_id``."""

    def __init__(self, data_root: str, split: str, pipeline):
        super().__init__(pipeline)
        with open(os.path.join(data_root, "annotations",
                               f"{split}2018.json")) as f:
            annotations = json.load(f)
        paths = {im["id"]: os.path.join(data_root, im["file_name"])
                 for im in annotations["images"]}
        self.instances = [(paths[a["image_id"]], a["category_id"])
                          for a in annotations["annotations"]]


class VOC07ClassificationDataset(_LabelledImages):
    r"""PASCAL VOC 2007 one-vs-all labels from
    ``{data_root}/ImageSets/Main/<class>_{split}.txt``, images from
    ``JPEGImages/<stem>.jpg``. An item's label is one int per class, the
    classes in name order, with the raw listing values mapped as
    1 (present) → +1, −1 (absent) → 0, 0 (difficult) → −1 (ignored); an
    image missing from a class's listing gets −1. Images come in the order
    they first appear while reading the listings in class-name order.
    """

    _REMAP = {1: 1, -1: 0, 0: -1}

    def __init__(self, data_root: str, split: str, pipeline):
        super().__init__(pipeline)
        listings = sorted(glob.glob(os.path.join(
            data_root, "ImageSets", "Main", f"*_{split}.txt")))
        flags: Dict[str, Dict[str, int]] = {}
        for listing in listings:
            table = flags[os.path.basename(listing).split("_")[0]] = {}
            with open(listing) as f:
                for line in f:
                    fields = line.split()
                    if len(fields) == 2:
                        table[fields[0]] = self._REMAP[int(fields[1])]
        self.class_names = list(flags)
        stems = dict.fromkeys(stem for table in flags.values()
                              for stem in table)
        self.instances = [
            (os.path.join(data_root, "JPEGImages", f"{stem}.jpg"),
             np.asarray([flags[c].get(stem, -1) for c in self.class_names],
                        np.int32))
            for stem in stems]


class ImageDirectoryDataset:
    r"""Every file of ``data_root``, in sorted order, for captioning; an
    item's ``image_id`` is its file name without the extension, a string.
    """

    def __init__(self, data_root: str, pipeline):
        self.image_paths = sorted(glob.glob(os.path.join(data_root, "*")))
        self.pipeline = pipeline

    def __len__(self) -> int:
        return len(self.image_paths)

    def get_batch(self, indices, rngs) -> List[dict]:
        paths = [self.image_paths[i] for i in indices]
        images = read_images(paths, rngs, self.pipeline)
        return [{"image_id": os.path.splitext(os.path.basename(p))[0],
                 "image": image} for p, image in zip(paths, images)]

    @staticmethod
    def collate_fn(data: List[dict]) -> dict:
        return {"image_id": [d["image_id"] for d in data],
                "image": np.stack([d["image"] for d in data])}
