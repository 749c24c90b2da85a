r"""
PASCAL VOC 2007 transfer by linear SVMs on frozen features, in the PyTorch
port.

Counterpart of ``scripts/clf_voc07.py``: the backbone of the pretraining
config (``--config``; ``MODEL.VISUAL.NAME``, frozen, in bf16) initialised by
``--weight-init`` as ``clf_linear`` initialises it, then L2-normalised
average-pooled layer4 features of the trainval and test splits
(``LinearClassifierModel.features``, BatchNorm on running statistics) at
the downstream config's batch size (``--down-config``,
``configs/downstream/voc07_clf.yaml``: 224², batch 128); the short last
batch runs at its own size. Then one SVM per class, its cost chosen
from {0.01, 0.1, 1, 10} by 3-fold cross-validated average precision, fitted
on the card in fp64 (:mod:`virtex_tpu_torch.utils.svm`; no sklearn), and
scored by test average precision. It logs each class's AP and the mean,
and prints ``{"metric": "voc07_mAP", "value": …}`` last. Runs on the card
unless ``--device cpu`` is passed.

    python -m virtex_tpu_torch.scripts.clf_voc07 \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --down-config configs/downstream/voc07_clf.yaml \
        --weight-init virtex \
        --checkpoint-path /tmp/virtex_run/checkpoint_best.pth
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from virtex_tpu_torch.config import Config
from virtex_tpu_torch.data.loader import DataLoader
from virtex_tpu_torch.engine.checkpointing import apply_backbone_weight_init
from virtex_tpu_torch.factories import (
    DownstreamDatasetFactory,
    VisualBackboneFactory,
)
from virtex_tpu_torch.models.downstream import LinearClassifierModel
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.parallel import shard_batch
from virtex_tpu_torch.utils.common import common_parser, common_setup
from virtex_tpu_torch.utils.distributed import get_world_size
from virtex_tpu_torch.utils.svm import train_test_svms

logger = logging.getLogger("virtex_tpu_torch")

NUM_CLASSES = 20


def build_parser():
    parser = common_parser(description="VOC07 SVM evaluation (PyTorch "
                           "port).")
    parser.add_argument("--down-config", metavar="FILE", default=None,
                        help="Downstream config yaml (default: --config).")
    parser.add_argument("--down-config-override", nargs="*", default=[],
                        help="Key-value pairs patching the downstream "
                             "config.")
    parser.add_argument(
        "--weight-init", default="virtex",
        choices=["random", "imagenet", "torchvision", "virtex"],
        help="random: fresh; torchvision: a torchvision .pth from "
             "--checkpoint-path; virtex: a pretraining checkpoint; "
             "imagenet (a download) is refused.")
    parser.add_argument("--checkpoint-path", default=None)
    return parser


def extract_features(model, dataset, batch_size: int, device
                     ) -> Tuple[torch.Tensor, np.ndarray]:
    """Features (n, C_out) of the whole split on ``device``, and its
    labels (n, classes), in dataset order."""
    loader = DataLoader(dataset, batch_size, shuffle=False, infinite=False,
                        drop_last=False, pin_memory=device.type == "cuda")
    feats, labels = [], []
    for batch in loader:
        feats.append(model.features(shard_batch(batch, device)["image"]))
        labels.append(batch["label"])
    return torch.cat(feats), np.concatenate(labels)


def main(_A) -> Dict[str, Any]:
    """Extract, fit and score as the flags say. Returns the features and
    labels of both splits (on the CPU), each class's result
    (:class:`~virtex_tpu_torch.utils.svm.ClassResult`), the solver's
    gradient norms and steps over all fits, the mAP (%), and the seconds
    of each stage."""
    _C = Config(_A.config, _A.config_override)
    _DOWNC = (Config(_A.down_config, _A.down_config_override)
              if _A.down_config else _C)
    device = common_setup(_DOWNC, _A, job_type="clf_voc07")
    if get_world_size() > 1:
        raise NotImplementedError("clf_voc07 runs in one process (its "
                                  "features and SVMs fit on one card)")

    plane = DataPlane(decoder_for(device), threads=_A.cpu_workers)
    train_ds = DownstreamDatasetFactory.from_config(_DOWNC, plane,
                                                    "trainval")
    test_ds = DownstreamDatasetFactory.from_config(_DOWNC, plane, "test")
    visual = VisualBackboneFactory.create(_C.MODEL.VISUAL.NAME, frozen=True)
    model = LinearClassifierModel(visual, NUM_CLASSES).to(device)
    apply_backbone_weight_init(model.visual, _A.weight_init,
                               _A.checkpoint_path)

    batch_size = _DOWNC.OPTIM.BATCH_SIZE
    seconds, feats = {}, {}
    for split, dataset in (("trainval", train_ds), ("test", test_ds)):
        logger.info(f"Extracting features ({split})…")
        t0 = time.perf_counter()
        feats[split] = extract_features(model, dataset, batch_size, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[split] = time.perf_counter() - t0

    (x_train, y_train), (x_test, y_test) = feats["trainval"], feats["test"]
    t0 = time.perf_counter()
    results, solver = train_test_svms(x_train, y_train, x_test, y_test,
                                      train_ds.class_names)
    seconds["svm"] = time.perf_counter() - t0

    mAP = 100.0 * float(np.mean([r.ap for r in results]))
    for r in sorted(results, key=lambda r: r.name):
        logger.info(f"AP {r.name}: {100 * r.ap:.2f} (cost {r.cost})")
    logger.info(f"VOC07 mAP: {mAP:.2f}")
    print(f'{{"metric": "voc07_mAP", "value": {mAP:.3f}}}', flush=True)
    return {"features": {split: (x.cpu(), y) for split, (x, y)
                         in feats.items()},
            "results": results, "solver": solver, "mAP": mAP,
            "seconds": seconds}


if __name__ == "__main__":
    main(build_parser().parse_args())
