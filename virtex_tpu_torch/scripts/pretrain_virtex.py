r"""
Pretrain a VirTex model on COCO Captions with the PyTorch port.

Counterpart of ``scripts/pretrain_virtex.py``: the same flags and the same
loop. Each iteration trains on ``OPTIM.BATCH_SIZE`` images in
``OPTIM.GRAD_ACCUM_STEPS`` micro-batches; every ``--log-every`` iterations
it logs the loss, every ``--checkpoint-every`` it runs the validation sweep
and saves a checkpoint (the rolling best by validation loss), and it ends
with a final save. ``--resume-from`` restores the model, the optimizer,
the data stream and the iteration, and the run goes on as an unbroken run
would (dropout seeded per iteration, ``engine/train_state.py``).

It trains on the card unless ``--device cpu`` is passed, and does not fall
back to the CPU when there is no card. Images are decoded by libjpeg where
it is installed, else on the card by nvJPEG (``virtex_tpu_torch/native``).

Data parallel: one process per card under torchrun (or the
``--coordinator-address`` flags), NCCL between cards, gloo with
``--device cpu``. Each rank trains on ``OPTIM.BATCH_SIZE // world``
images of its loader shard, BatchNorm synced over the global batch; rank
0 logs to stdout and writes the checkpoints, whose ``items_consumed`` is
per host, and every rank resumes from them.

Tensor parallel: ``PARALLEL.MODEL`` m > 1 splits the textual head's heads
and feed-forward columns over m adjacent ranks (``parallel/mesh.py``);
the world is ``PARALLEL.DATA`` × m. The ranks of one model group read the
same rows (the loaders shard by the data rank) and draw one dropout
stream; rank 0's full model is broadcast and then sliced, and the
checkpoints hold the full model, so a run resumes at another m.

    torchrun --nproc-per-node 2 -m virtex_tpu_torch.scripts.pretrain_virtex \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --serialization-dir /tmp/virtex_run \
        --config-override PARALLEL.MODEL 2

    torchrun --nproc-per-node 4 -m virtex_tpu_torch.scripts.pretrain_virtex \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --serialization-dir /tmp/virtex_run

    python -m virtex_tpu_torch.scripts.pretrain_virtex \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --serialization-dir /tmp/virtex_run \
        --config-override DATA.ROOT datasets/coco OPTIM.GRAD_ACCUM_STEPS 2
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.data.loader import DataLoader
from virtex_tpu_torch.engine.checkpointing import CheckpointManager
from virtex_tpu_torch.engine.evaluation import make_eval_step
from virtex_tpu_torch.engine.train_state import TrainState, step_seed
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import (
    LRSchedulerFactory,
    OptimizerFactory,
    PretrainingDatasetFactory,
    PretrainingModelFactory,
    TokenizerFactory,
)
from virtex_tpu_torch.native import DataPlane, decoder_for
from virtex_tpu_torch.ops._mesh import kernel_group
from virtex_tpu_torch.parallel import (
    check_divisible,
    create_mesh,
    replicate_,
    shard_batch,
    shard_module_,
)
from virtex_tpu_torch.utils.common import common_parser, common_setup
from virtex_tpu_torch.utils.distributed import (
    broadcast_object,
    device_mem_usage_mb,
    is_master_process,
)
from virtex_tpu_torch.utils.timer import Timer
from virtex_tpu_torch.utils.tracing import per_unit_line, span

logger = logging.getLogger("virtex_tpu_torch")


def log_val_predictions(model, batch, _C, mesh=None, k: int = 3) -> None:
    """Log the argmax captions of the first ``k`` validation images beside
    their ground truth (the reference's log_predictions), on rank 0. The
    ranks of rank 0's model group run the sharded forward with it."""
    if "caption_tokens" not in batch or (mesh is not None
                                         and mesh.data_rank != 0):
        return
    model_group = None if mesh is None else mesh.model_group
    with torch.inference_mode(), kernel_group(None, model_group):
        preds = model.eval()(batch).get("predictions")
    if preds is None or not is_master_process():
        return
    tok = TokenizerFactory.from_config(_C)
    for p, g in zip(preds[:k].tolist(), batch["caption_tokens"][:k].tolist()):
        logger.info(f'  pred: "{tok.decode(p)}"  |  gt: "{tok.decode(g)}"')


def validate(model, eval_step, loader_factory, device, _C,
             mesh=None) -> Dict[str, float]:
    """Each eval metric over one pass of the validation split: the batches'
    values weighed by their images. With batches of one size this is the
    reference's mean over batches; a short last batch, which the reference
    drops, counts for its images only. Under data parallelism each rank
    scores its shard, whose batches have the sizes of every other rank's,
    and ``eval_step`` gives each batch's means over the ranks."""
    sums: Dict[str, float] = {}
    n = 0
    for i, host_batch in enumerate(loader_factory()):
        batch = shard_batch(host_batch, device)
        size = int(batch["image"].shape[0])
        for key, v in eval_step(batch).items():
            sums[key] = sums.get(key, 0.0) + float(v) * size
        n += size
        if i == 0:
            log_val_predictions(model, batch, _C, mesh)
    return {k: v / n for k, v in sums.items()}


def stop_profiler(profiler: torch.profiler.profile) -> None:
    """Stop the profiler and log the program's spans over its iterations:
    each span's ms per iteration on the host and on the device."""
    profiler.stop()
    line = per_unit_line()
    if line:
        logger.info(line)


def main(_A) -> Dict[str, Any]:
    """Train as the flags say. Returns what the run measured: each
    iteration's loss where it was logged, the validation losses, the
    seconds of each iteration, and the final iteration."""
    _C = Config(_A.config, _A.config_override)
    device = common_setup(_C, _A, job_type="pretrain")
    if _C.PARALLEL.MODEL > 1:
        check_divisible(ModelSpec.from_config(_C).textual, _C.PARALLEL.MODEL)
    mesh = create_mesh(_C.PARALLEL.DATA, _C.PARALLEL.MODEL)
    batch_size, accum = _C.OPTIM.BATCH_SIZE, _C.OPTIM.GRAD_ACCUM_STEPS
    if batch_size % mesh.data != 0:
        raise ValueError(f"OPTIM.BATCH_SIZE {batch_size} not divisible by "
                         f"the {mesh.data} data shards")
    per_host_batch = batch_size // mesh.data
    if per_host_batch % accum != 0:
        raise ValueError(f"per-process batch {per_host_batch} not divisible "
                         f"by OPTIM.GRAD_ACCUM_STEPS {accum}")

    # ----------------------------------------------------------------- data
    plane = DataPlane(decoder_for(device), threads=_A.cpu_workers)
    train_dataset = PretrainingDatasetFactory.from_config(_C, plane, "train")
    val_dataset = PretrainingDatasetFactory.from_config(_C, plane, "val")
    pin = device.type == "cuda"
    train_loader = DataLoader(
        train_dataset, per_host_batch, shuffle=True, seed=_C.RANDOM_SEED,
        prefetch=_C.DATA.PREFETCH, infinite=True, num_shards=mesh.data,
        shard_index=mesh.data_rank, pin_memory=pin)
    # A short last batch is kept, so the whole split is validated (the
    # reference drops it); validate() weighs each batch by its images.
    # Sharded, the split's last len % world images are not scored.
    val_loader_factory = lambda: DataLoader(  # noqa: E731
        val_dataset, per_host_batch, shuffle=False, infinite=False,
        num_shards=mesh.data, shard_index=mesh.data_rank, drop_last=False,
        pin_memory=pin)

    # ---------------------------------------------------------------- model
    torch.manual_seed(_C.RANDOM_SEED)
    model = shard_module_(replicate_(
        PretrainingModelFactory.from_config(_C, device), mesh), mesh)
    optimizer = OptimizerFactory.from_config(_C, model.named_parameters(),
                                             mesh=mesh)
    state = TrainState(model, optimizer, mesh=mesh)
    generator = torch.Generator(device=device)
    train_step = make_train_step(model, optimizer, accum, generator=generator,
                                 mesh=mesh)
    eval_step = make_eval_step(model, mesh)

    ckpt_mgr = CheckpointManager(_A.serialization_dir, keep_recent=100)
    resume_path = _A.resume_from
    if resume_path == "latest":  # rank 0's view of the directory
        resume_path = broadcast_object(ckpt_mgr.latest())
        if resume_path is None:
            logger.info("--resume-from latest: no checkpoint yet, starting "
                        "fresh")
    if resume_path:
        ckpt_mgr.load(resume_path, state, loader=train_loader)
        logger.info(f"Resumed from {resume_path} at {state.iteration}")
    start_iteration = state.iteration
    lr_schedule = LRSchedulerFactory.from_config(_C)
    timer = Timer(start_from=start_iteration + 1,
                  total_iterations=_C.OPTIM.NUM_ITERATIONS)
    result: Dict[str, Any] = {"losses": {}, "val": {}, "seconds": {},
                              "start_iteration": start_iteration}

    # ------------------------------------------------------------- hot loop
    train_iter = iter(train_loader)
    profiler: Optional[torch.profiler.profile] = None
    for iteration in range(start_iteration + 1,
                           _C.OPTIM.NUM_ITERATIONS + 1):
        if _A.profile_dir and iteration == start_iteration + 10:
            profiler = torch.profiler.profile(
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    _A.profile_dir))
            profiler.start()
        if profiler is not None and iteration == start_iteration + 20:
            stop_profiler(profiler)
            profiler = None
        timer.tic()
        with span("data_wait", device):
            host_batch = next(train_iter)
        batch = shard_batch(host_batch, device, accum)
        generator.manual_seed(step_seed(_C.RANDOM_SEED, iteration,
                                        mesh.data_rank))
        metrics = train_step(batch)
        state.iteration = iteration
        if iteration % _A.log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}  # a sync
            result["losses"][iteration] = metrics["loss"]
        result["seconds"][iteration] = timer.toc()

        if iteration % _A.log_every == 0:
            mult = lr_schedule(iteration)
            logger.info(
                f"{timer.stats} | loss {metrics['loss']:.4f} | "
                f"{timer.throughput(batch_size):.1f} img/s | lr cnn "
                f"{_C.OPTIM.CNN_LR * mult:.5f} textual "
                f"{_C.OPTIM.LR * mult:.6f}"
                + (f" | mem {device_mem_usage_mb():.0f}MB"
                   if device.type == "cuda" else ""))

        if iteration % _A.checkpoint_every == 0:
            val = validate(model, eval_step, val_loader_factory, device, _C,
                           mesh)
            logger.info(f"Val @ {iteration}: {val}")
            result["val"][iteration] = val
            # rolling best = lowest validation loss (the manager keeps the
            # highest metric); batches trained = iteration
            ckpt_mgr.step(state, metric=-val["loss"],
                          loader_state={"items_consumed":
                                        iteration * per_host_batch})

    if profiler is not None:
        stop_profiler(profiler)
    if _C.OPTIM.NUM_ITERATIONS % _A.checkpoint_every != 0:
        ckpt_mgr.step(state, loader_state={
            "items_consumed": _C.OPTIM.NUM_ITERATIONS * per_host_batch})
    result["iteration"] = state.iteration
    return result


if __name__ == "__main__":
    parser = common_parser(description="Pretrain a VirTex model on COCO "
                           "Captions (PyTorch port).")
    main(parser.parse_args())
