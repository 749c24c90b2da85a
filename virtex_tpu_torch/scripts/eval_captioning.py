r"""
Caption COCO val (or a directory of images) with a pretrained VirTex model
in the PyTorch port, and score the captions with CIDEr and SPICE.

Counterpart of ``scripts/eval_captioning.py``: the same flags, beam search
or nucleus sampling by ``MODEL.DECODER.NAME``, nucleus draws seeded from
``(RANDOM_SEED, batch index)``, predictions written as
``[{"image_id", "caption"}]`` in dataset order, and with ``--calc-metrics``
a last line ``{"CIDEr": …, "SPICE": …}`` (SPICE 0.0 without Java and the
SPICE jar). It runs on the card unless ``--device cpu`` is passed. The
short last batch runs at its own size, so the JAX script's padding of it
has no counterpart.

Data parallel (several processes, as ``pretrain_virtex`` runs them): rank
``r`` of ``W`` captions the ``r``-th of ``W`` contiguous blocks of the
images in batches of ``--batch-size // W`` (which must divide), and rank 0
gathers the predictions back into dataset order before it writes them and
scores them. Nucleus draws are seeded per rank too.

    python -m virtex_tpu_torch.scripts.eval_captioning \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --checkpoint-path /tmp/virtex_run/checkpoint_best.pth \
        --calc-metrics --output /tmp/predictions.json
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Sequence

import torch

from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.data.datasets.downstream import ImageDirectoryDataset
from virtex_tpu_torch.data.loader import DataLoader
from virtex_tpu_torch.data.native_pipeline import EvalPipeline
from virtex_tpu_torch.engine.captioner import (
    decode_predictions,
    make_caption_fn,
)
from virtex_tpu_torch.engine.checkpointing import load_model_variables
from virtex_tpu_torch.engine.train_state import step_seed
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    PretrainingDatasetFactory,
    PretrainingModelFactory,
    TokenizerFactory,
)
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.utils.common import common_parser, common_setup
from virtex_tpu_torch.utils.distributed import (
    gather_objects,
    get_rank,
    get_world_size,
)
from virtex_tpu_torch.utils.metrics import CocoCaptionsEvaluator

logger = logging.getLogger("virtex_tpu_torch")


def build_parser():
    parser = common_parser(description="Caption images with a VirTex "
                           "model (PyTorch port).")
    # "--images" is the reference's spelling, "--data-root" its alias.
    parser.add_argument("--images", "--data-root", dest="data_root",
                        default=None,
                        help="Image directory; defaults to COCO val2017.")
    parser.add_argument("--checkpoint-path", default=None)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--output", default=None,
                        help="Path to save predictions JSON.")
    parser.add_argument("--calc-metrics", action="store_true")
    return parser


class Block:
    """Items ``[lo, hi)`` of a dataset, as a dataset."""

    def __init__(self, dataset, lo: int, hi: int):
        self.dataset, self.lo, self.hi = dataset, lo, hi
        self.collate_fn = dataset.collate_fn

    def __len__(self) -> int:
        return self.hi - self.lo

    def get_batch(self, indices: Sequence[int], rngs):
        return self.dataset.get_batch([self.lo + i for i in indices], rngs)


def main(_A) -> Dict[str, Any]:
    """Caption as the flags say. Returns the predictions (on rank 0 all of
    them, elsewhere the rank's block), the seconds of each batch (from its
    copy to the device to its decoded captions, which wait for the
    device), and the metrics with ``--calc-metrics`` (on rank 0)."""
    _C = Config(_A.config, _A.config_override)
    device = common_setup(_C, _A, job_type="eval_captioning")
    spec = ModelSpec.from_config(_C)
    world, rank = get_world_size(), get_rank()
    if _A.batch_size % world:
        raise SystemExit(f"--batch-size {_A.batch_size} must be divisible "
                         f"by the {world} processes (each batch is split "
                         "evenly across them)")

    tokenizer = TokenizerFactory.from_config(_C)
    plane = DataPlane(decoder_for(device), threads=_A.cpu_workers)
    if _A.data_root:
        # The JAX package's default image transform: 256, then crop 224.
        dataset = ImageDirectoryDataset(_A.data_root, EvalPipeline(plane))
    else:
        dataset = PretrainingDatasetFactory.from_config(_C, plane, "val")
    n = len(dataset)
    block = Block(dataset, rank * n // world, (rank + 1) * n // world)
    loader = DataLoader(block, _A.batch_size // world, shuffle=False,
                        infinite=False, drop_last=False)

    model = PretrainingModelFactory.from_spec(spec, device)
    if _A.checkpoint_path:
        load_model_variables(_A.checkpoint_path, model)
    caption_fn = make_caption_fn(model, CaptionDecoderFactory.from_spec(spec),
                                 sos_index=spec.sos_index,
                                 prefix_mode=spec.prefix_mode)
    generator = torch.Generator(device=device)

    predictions: List[Dict[str, Any]] = []
    seconds: List[float] = []
    for batch_idx, batch in enumerate(loader):
        start = time.perf_counter()
        images = torch.as_tensor(batch["image"]).to(device)
        generator.manual_seed(step_seed(_C.RANDOM_SEED, batch_idx, rank))
        tokens = caption_fn(images, generator)
        captions = decode_predictions(tokens, tokenizer, spec.eos_index)
        seconds.append(time.perf_counter() - start)
        ids = batch["image_id"]
        ids = ids.tolist() if hasattr(ids, "tolist") else list(ids)
        predictions += [{"image_id": i, "caption": c}
                        for i, c in zip(ids, captions)]

    gathered = gather_objects(predictions)
    result: Dict[str, Any] = {"predictions": predictions,
                              "seconds": seconds}
    if rank != 0:
        return result
    predictions = [p for part in gathered for p in part]
    result["predictions"] = predictions
    logger.info("Sample predictions:")
    for p in predictions[:10]:
        logger.info(f"  {p['image_id']}: {p['caption']}")
    if _A.output:
        os.makedirs(os.path.dirname(os.path.abspath(_A.output)),
                    exist_ok=True)
        with open(_A.output, "w") as f:
            json.dump(predictions, f)

    if _A.calc_metrics:
        gt_path = os.path.join(_C.DATA.ROOT, "annotations",
                               "captions_val2017.json")
        metrics = CocoCaptionsEvaluator(gt_path).evaluate(predictions)
        logger.info(f"Metrics: {metrics}")
        print(json.dumps(metrics), flush=True)
        result["metrics"] = metrics
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
