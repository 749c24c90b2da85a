r"""
COCO Captions, read raw: the annotations in memory, each image's JPEG bytes
on access.

Counterpart of ``virtex_tpu/data/readers.py`` :class:`CocoCaptionsReader`
without its cv2 decode: the data plane (``virtex_tpu_torch.native``)
decodes.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

from virtex_tpu_torch.data.tokenizers import preprocess_caption


class CocoCaptionsReader:
    r"""``(image_id, JPEG bytes, captions)`` instances of
    ``{data_root}/{split}2017/`` and
    ``{data_root}/annotations/captions_{split}2017.json``, captions
    lowercased and accent-stripped.
    """

    def __init__(self, data_root: str, split: str):
        image_dir = os.path.join(data_root, f"{split}2017")
        with open(os.path.join(data_root, "annotations",
                               f"captions_{split}2017.json")) as f:
            captions = json.load(f)
        captions_per_image: Dict[int, List[str]] = defaultdict(list)
        for ann in captions["annotations"]:
            captions_per_image[ann["image_id"]].append(
                preprocess_caption(ann["caption"]))
        paths = {im["id"]: os.path.join(image_dir, im["file_name"])
                 for im in captions["images"]}
        self.instances: List[Tuple[int, str, List[str]]] = [
            (im_id, paths[im_id], caps)
            for im_id, caps in captions_per_image.items()]

    def __len__(self) -> int:
        return len(self.instances)

    def raw(self, idx: int):
        image_id, image_path, captions = self.instances[idx]
        with open(image_path, "rb") as f:
            data = f.read()
        return {"image_id": image_id, "jpeg": data, "captions": captions}
