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

    python -m virtex_tpu_torch.scripts.pretrain_virtex \
        --config configs/_base_bicaptioning_R_50_L1_H1024.yaml \
        --serialization-dir /tmp/virtex_run \
        --config-override DATA.ROOT datasets/coco OPTIM.GRAD_ACCUM_STEPS 2
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from virtex_tpu_torch.config import Config
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
from virtex_tpu_torch.utils.common import common_parser, common_setup
from virtex_tpu_torch.utils.timer import Timer

logger = logging.getLogger("virtex_tpu_torch")


def to_device(batch: Dict[str, Any], device: torch.device, accum: int
              ) -> Dict[str, torch.Tensor]:
    """A loader batch on ``device`` (pinned batches copy ``non_blocking``),
    with ``accum`` > 1 in the micro-step layout (accum, B/accum, ...)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device, non_blocking=True)
        out[k] = t if accum == 1 else t.reshape(
            (accum, t.shape[0] // accum) + tuple(t.shape[1:]))
    return out


def log_val_predictions(model, batch, _C, k: int = 3) -> None:
    """Log the argmax captions of the first ``k`` validation images beside
    their ground truth (the reference's log_predictions)."""
    if "caption_tokens" not in batch:
        return
    with torch.inference_mode():
        preds = model.eval()(batch).get("predictions")
    if preds is None:
        return
    tok = TokenizerFactory.from_config(_C)
    for p, g in zip(preds[:k].tolist(), batch["caption_tokens"][:k].tolist()):
        logger.info(f'  pred: "{tok.decode(p)}"  |  gt: "{tok.decode(g)}"')


def validate(model, eval_step, loader_factory, device, _C) -> Dict[str, float]:
    """Each eval metric over one pass of the validation split: the batches'
    values weighed by their images. With batches of one size this is the
    reference's mean over batches; a short last batch, which the reference
    drops, counts for its images only."""
    sums: Dict[str, float] = {}
    n = 0
    for i, host_batch in enumerate(loader_factory()):
        batch = to_device(host_batch, device, 1)
        size = int(batch["image"].shape[0])
        for key, v in eval_step(batch).items():
            sums[key] = sums.get(key, 0.0) + float(v) * size
        n += size
        if i == 0:
            log_val_predictions(model, batch, _C)
    return {k: v / n for k, v in sums.items()}


def main(_A) -> Dict[str, Any]:
    """Train as the flags say. Returns what the run measured: each
    iteration's loss where it was logged, the validation losses, the
    seconds of each iteration, and the final iteration."""
    _C = Config(_A.config, _A.config_override)
    device = common_setup(_C, _A, job_type="pretrain")
    batch_size, accum = _C.OPTIM.BATCH_SIZE, _C.OPTIM.GRAD_ACCUM_STEPS
    if batch_size % accum != 0:
        raise ValueError(f"OPTIM.BATCH_SIZE {batch_size} not divisible by "
                         f"OPTIM.GRAD_ACCUM_STEPS {accum}")

    # ----------------------------------------------------------------- data
    plane = DataPlane(decoder_for(device), threads=_A.cpu_workers)
    train_dataset = PretrainingDatasetFactory.from_config(_C, plane, "train")
    val_dataset = PretrainingDatasetFactory.from_config(_C, plane, "val")
    pin = device.type == "cuda"
    train_loader = DataLoader(
        train_dataset, batch_size, shuffle=True, seed=_C.RANDOM_SEED,
        prefetch=_C.DATA.PREFETCH, infinite=True, pin_memory=pin)
    # A short last batch is kept, so the whole split is validated (the
    # reference drops it); validate() weighs each batch by its images.
    val_loader_factory = lambda: DataLoader(  # noqa: E731
        val_dataset, batch_size, shuffle=False, infinite=False,
        drop_last=False, pin_memory=pin)

    # ---------------------------------------------------------------- model
    torch.manual_seed(_C.RANDOM_SEED)
    model = PretrainingModelFactory.from_config(_C, device)
    optimizer = OptimizerFactory.from_config(_C, model.named_parameters())
    state = TrainState(model, optimizer)
    generator = torch.Generator(device=device)
    train_step = make_train_step(model, optimizer, accum, generator=generator)
    eval_step = make_eval_step(model)

    ckpt_mgr = CheckpointManager(_A.serialization_dir, keep_recent=100)
    resume_path = _A.resume_from
    if resume_path == "latest":
        resume_path = ckpt_mgr.latest()
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
            profiler.stop()
            profiler = None
        timer.tic()
        batch = to_device(next(train_iter), device, accum)
        generator.manual_seed(step_seed(_C.RANDOM_SEED, iteration))
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
                + (f" | mem {torch.cuda.max_memory_allocated(device) / 2**20:.0f}"
                   "MB" if device.type == "cuda" else ""))

        if iteration % _A.checkpoint_every == 0:
            val = validate(model, eval_step, val_loader_factory, device, _C)
            logger.info(f"Val @ {iteration}: {val}")
            result["val"][iteration] = val
            # rolling best = lowest validation loss (the manager keeps the
            # highest metric); batches trained = iteration
            ckpt_mgr.step(state, metric=-val["loss"],
                          loader_state={"items_consumed":
                                        iteration * batch_size})

    if profiler is not None:
        profiler.stop()
    if _C.OPTIM.NUM_ITERATIONS % _A.checkpoint_every != 0:
        ckpt_mgr.step(state, loader_state={
            "items_consumed": _C.OPTIM.NUM_ITERATIONS * batch_size})
    result["iteration"] = state.iteration
    return result


if __name__ == "__main__":
    parser = common_parser(description="Pretrain a VirTex model on COCO "
                           "Captions (PyTorch port).")
    main(parser.parse_args())
