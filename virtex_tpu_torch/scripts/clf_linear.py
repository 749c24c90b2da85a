r"""
Linear probe or fine-tune of a pretrained visual backbone on ImageNet or
iNaturalist 2018, in the PyTorch port.

Counterpart of ``scripts/clf_linear.py``: the downstream config
(``--down-config``, patched by ``--down-config-override``) sets the data,
the schedule and whether the backbone is frozen (the linear probe) or
trained (fine-tuning); the pretraining config (``--config``), if given,
names the backbone's architecture. ``--weight-init`` takes the backbone
from a pretraining checkpoint (``virtex``), a torchvision ``.pth``
(``torchvision``) or leaves it random. One learning rate for every
parameter; the loader's first batch is the first training batch; every
``--checkpoint-every`` iterations the whole val split is scored (top-1)
and a checkpoint saved, keeping the five newest and the best. The last
line is ``{"metric": "<dataset>_top1", "value": …}``. Runs on the card
unless ``--device cpu`` is passed.

Data parallel as ``pretrain_virtex`` is: each of the processes trains on
``OPTIM.BATCH_SIZE // world`` images of its loader shard, the fine-tune's
BatchNorm synced over the global batch, and scores its shard of the val
split (the last ``len % world`` images are not scored); the top-1 is the
mean over the ranks.

    python -m virtex_tpu_torch.scripts.clf_linear \
        --down-config configs/downstream/imagenet_clf.yaml \
        --weight-init virtex --checkpoint-path /tmp/virtex_run/checkpoint_best.pth \
        --serialization-dir /tmp/imagenet_probe
"""
from __future__ import annotations

import logging
from typing import Any, Dict

import torch

from virtex_tpu_torch.config import Config
from virtex_tpu_torch.data.loader import DataLoader
from virtex_tpu_torch.engine.checkpointing import (
    CheckpointManager,
    apply_backbone_weight_init,
)
from virtex_tpu_torch.engine.train_state import TrainState
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import (
    DownstreamDatasetFactory,
    LRSchedulerFactory,
    VisualBackboneFactory,
)
from virtex_tpu_torch.models.downstream import LinearClassifierModel
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.optim.optimizer import Optimizer
from virtex_tpu_torch.parallel import (
    Mesh,
    create_mesh,
    replicate_,
    shard_batch,
)
from virtex_tpu_torch.utils.common import common_parser, common_setup
from virtex_tpu_torch.utils.distributed import average_across_processes
from virtex_tpu_torch.utils.metrics import TopkAccuracy
from virtex_tpu_torch.utils.timer import Timer

logger = logging.getLogger("virtex_tpu_torch")

NUM_CLASSES = {"imagenet": 1000, "inaturalist": 8142}


def build_parser():
    parser = common_parser(description="Linear probe / fine-tune on "
                           "ImageNet or iNaturalist (PyTorch port).")
    parser.add_argument("--down-config", metavar="FILE", required=True,
                        help="Downstream config yaml.")
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


def build_optimizer(model, _DOWNC) -> Optimizer:
    """The chain of the downstream ``OPTIM.*`` with one learning rate
    (``CNN_LR`` = ``LR``: the reference trains the CNN outside its
    "visual." scope) and the backbone stepped by zero when it is
    frozen."""
    O = _DOWNC.OPTIM
    return Optimizer(
        model.named_parameters(), optimizer_name=O.OPTIMIZER_NAME,
        schedule=LRSchedulerFactory.from_config(_DOWNC), lr=O.LR,
        cnn_lr=O.LR, weight_decay=O.WEIGHT_DECAY, no_decay_pattern=O.NO_DECAY,
        momentum=O.SGD_MOMENTUM, clip_norm=O.CLIP_GRAD_NORM,
        use_lookahead=O.LOOKAHEAD.USE, lookahead_k=O.LOOKAHEAD.STEPS,
        lookahead_alpha=O.LOOKAHEAD.ALPHA,
        frozen_pattern="visual" if _DOWNC.MODEL.VISUAL.FROZEN else None)


def evaluate(model, dataset, batch_size: int, device, mesh: Mesh) -> float:
    """Top-1 (%) over the split, BatchNorm on running statistics: each
    rank scores its shard, and the top-1 is the mean over the ranks."""
    top1 = TopkAccuracy(top_k=1)
    loader = DataLoader(dataset, batch_size, shuffle=False, infinite=False,
                        num_shards=mesh.data, shard_index=mesh.rank,
                        drop_last=False)
    with torch.inference_mode():
        model.eval()
        for batch in loader:
            logits = model(shard_batch(batch, device))["logits"]
            top1(logits.float().cpu().numpy(), batch["label"])
    return average_across_processes(top1.get_metric(reset=True))


def main(_A) -> Dict[str, Any]:
    """Train and score as the flags say. Returns each logged loss, each
    iteration's seconds, the top-1 at each checkpoint and the final
    top-1."""
    _DOWNC = Config(_A.down_config, _A.down_config_override)
    _C = Config(_A.config, _A.config_override) if _A.config else None
    device = common_setup(_DOWNC, _A, job_type="clf_linear")
    dataset_name = ("imagenet" if "imagenet" in _DOWNC.DATA.ROOT
                    else "inaturalist")
    num_classes = NUM_CLASSES[dataset_name]
    batch_size = _DOWNC.OPTIM.BATCH_SIZE
    mesh = create_mesh()
    if batch_size % mesh.data:
        raise ValueError(f"OPTIM.BATCH_SIZE {batch_size} not divisible by "
                         f"the {mesh.data} processes")
    per_host = batch_size // mesh.data

    plane = DataPlane(decoder_for(device), threads=_A.cpu_workers)
    train_ds = DownstreamDatasetFactory.from_config(_DOWNC, plane, "train")
    val_ds = DownstreamDatasetFactory.from_config(_DOWNC, plane, "val")
    train_loader = DataLoader(train_ds, per_host, shuffle=True,
                              infinite=True, num_shards=mesh.data,
                              shard_index=mesh.rank,
                              pin_memory=device.type == "cuda")

    # The backbone of the pretraining config (else the downstream one's),
    # in the backbone's own dtype (bf16) whatever DTYPE says, as the JAX
    # script builds it.
    backbone_cfg = _C if _C is not None else _DOWNC
    visual = VisualBackboneFactory.create(
        backbone_cfg.MODEL.VISUAL.NAME,
        frozen=bool(_DOWNC.MODEL.VISUAL.FROZEN))
    model = LinearClassifierModel(visual, num_classes).to(device)
    apply_backbone_weight_init(model.visual, _A.weight_init,
                               _A.checkpoint_path)
    replicate_(model, mesh)

    optimizer = build_optimizer(model, _DOWNC)
    state = TrainState(model, optimizer)
    train_step = make_train_step(model, optimizer, mesh=mesh)
    ckpt = CheckpointManager(_A.serialization_dir, keep_recent=5)
    num_iterations = _DOWNC.OPTIM.NUM_ITERATIONS
    timer = Timer(total_iterations=num_iterations)
    result: Dict[str, Any] = {"losses": {}, "seconds": {}, "top1": {}}

    train_iter = iter(train_loader)
    for iteration in range(1, num_iterations + 1):
        timer.tic()
        metrics = train_step(shard_batch(next(train_iter), device))
        state.iteration = iteration
        if iteration % _A.log_every == 0:
            loss = float(metrics["loss"])  # a sync
            result["losses"][iteration] = loss
        result["seconds"][iteration] = timer.toc()
        if iteration % _A.log_every == 0:
            logger.info(f"{timer.stats} | loss {loss:.4f} | "
                        f"{timer.throughput(batch_size):.1f} img/s")
        if iteration % _A.checkpoint_every == 0:
            acc = evaluate(model, val_ds, per_host, device, mesh)
            logger.info(f"Val top-1 @ {iteration}: {acc:.2f}")
            result["top1"][iteration] = acc
            ckpt.step(state, metric=acc, loader_state={
                "items_consumed": iteration * per_host})

    acc = evaluate(model, val_ds, per_host, device, mesh)
    logger.info(f"Final {dataset_name} top-1: {acc:.2f}")
    if mesh.rank == 0:
        print(f'{{"metric": "{dataset_name}_top1", "value": {acc:.3f}}}',
              flush=True)
    result.update(metric=f"{dataset_name}_top1", value=acc)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
