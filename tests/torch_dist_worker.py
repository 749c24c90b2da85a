"""One rank of a data- or tensor-parallel job of the PyTorch port, on the
CPU over gloo, for tests/test_torch_distributed.py and
tests/test_torch_tensor_parallel.py.

    python -m tests.torch_dist_worker <job> <spec.pt>

The process group comes from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). ``spec.pt`` holds the
job's inputs; the rank writes what it measured to ``<out>/rank<r>.pt``.
Jobs: ``checks`` (the op and train-step parity checks, one spawn for all
of them), ``tp`` (the tensor-parallel checks on a ``(data, model)`` grid
of ``spec["grid"]``) and ``cli`` (one of the port's scripts, with its
checkpoint writes and its training batches' image ids recorded). Imports
torch and the port only.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from virtex_tpu_torch.utils import distributed


def local_rows(batch, mesh, micro: bool = False):
    """This rank's shard of a global batch: rows ``[r·b, (r+1)·b)`` of the
    batch dim, dim 0, or with ``micro`` dim 1 of ``(accum, B, ...)``
    leaves, for the data rank r."""
    dim = 1 if micro else 0

    def take(v):
        n = v.shape[dim]
        if n % mesh.data:
            raise ValueError(f"a batch of {n} does not shard over "
                             f"{mesh.data} ranks")
        b = n // mesh.data
        r = mesh.data_rank
        index = (slice(None),) * dim + (slice(r * b, (r + 1) * b),)
        return v[index]

    return {k: take(v) for k, v in batch.items()}


def _bn_check(spec, mesh):
    """bn_train's forward and backward on this rank's rows of the global
    NHWC batch; dγ and dβ are the local sums."""
    from virtex_tpu_torch.ops._mesh import kernel_group
    from virtex_tpu_torch.ops.batchnorm import bn_train

    rows = local_rows({"x": spec["x"], "w": spec["w"]}, mesh)
    x = torch.from_numpy(rows["x"]).permute(0, 3, 1, 2).requires_grad_()
    w = torch.from_numpy(rows["w"]).permute(0, 3, 1, 2)
    C = x.shape[1]
    scale = torch.from_numpy(spec["scale"]).requires_grad_()
    bias = torch.from_numpy(spec["bias"]).requires_grad_()
    with kernel_group(mesh.group):
        y, mean, var = bn_train(x, scale, bias, spec["eps"], torch.float32)
        (y * w).sum().backward()
    assert x.grad.shape[1] == C
    return {"dx": x.grad.permute(0, 2, 3, 1), "dscale": scale.grad,
            "dbias": bias.grad, "mean": mean, "var": var,
            "y": y.detach().permute(0, 2, 3, 1)}


def _sampler_check(spec, mesh):
    """SubsampledBatchNorm at stat_stride 4 in training on this rank's
    rows: output, gradients (dγ, dβ local) and running statistics."""
    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    from virtex_tpu_torch.ops._mesh import kernel_group

    rows = local_rows({"x": spec["x"], "w": spec["w"]}, mesh)
    x = torch.from_numpy(rows["x"]).permute(0, 3, 1, 2).requires_grad_()
    w = torch.from_numpy(rows["w"]).permute(0, 3, 1, 2)
    bn = SubsampledBatchNorm(x.shape[1], stat_stride=4)
    bn.load_state_dict({k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v for k, v in spec["state"].items()})
    bn.train()
    with kernel_group(mesh.group):
        y = bn(x)
        (y * w).sum().backward()
    return {"y": y.detach().permute(0, 2, 3, 1),
            "dx": x.grad.permute(0, 2, 3, 1), "dscale": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def _step_check(spec, mesh):
    """The train step on this rank's shard of each global micro-batch,
    from rank 0's weights (rank 1 starts from others, which the broadcast
    overwrites)."""
    from virtex_tpu_torch.config import Config, ModelSpec, OptimSpec
    from virtex_tpu_torch.engine.trainer import make_train_step
    from virtex_tpu_torch.factories import PretrainingModelFactory
    from virtex_tpu_torch.optim.optimizer import build_optimizer
    from virtex_tpu_torch.parallel import replicate_

    cfg = Config(override_list=spec["overrides"])
    model = PretrainingModelFactory.from_spec(ModelSpec.from_config(cfg),
                                              device="cpu")
    model.load_state_dict(spec["state_dict"], strict=True)
    if mesh.rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    replicate_(model, mesh)
    opt = build_optimizer(model.named_parameters(),
                          OptimSpec.from_config(cfg))
    step = make_train_step(model, opt, accum_steps=spec["accum"], mesh=mesh)
    metrics = []
    for batch in spec["batches"]:
        local = local_rows(batch, mesh, micro=True)
        metrics.append({k: float(v) for k, v in step(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in local.items()}).items()})
    return {"metrics": metrics, "state": model.state_dict()}


def _remat_check(spec, mesh):
    """One step of the plain model and one of its remat twin on the same
    shard: the parameters and buffers after each."""
    from virtex_tpu_torch.config import Config, ModelSpec, OptimSpec
    from virtex_tpu_torch.engine.trainer import make_train_step
    from virtex_tpu_torch.factories import PretrainingModelFactory
    from virtex_tpu_torch.optim.optimizer import build_optimizer

    states = {}
    for remat in (False, True):
        cfg = Config(override_list=spec["overrides"] + [
            "MODEL.VISUAL.REMAT", remat, "MODEL.TEXTUAL.REMAT", remat])
        model = PretrainingModelFactory.from_spec(
            ModelSpec.from_config(cfg), device="cpu")
        model.load_state_dict(spec["state_dict"], strict=True)
        opt = build_optimizer(model.named_parameters(),
                              OptimSpec.from_config(cfg))
        step = make_train_step(model, opt, accum_steps=spec["accum"],
                               mesh=mesh)
        local = local_rows(spec["batches"][0], mesh, micro=True)
        distributed.reset_all_reduce_counts()
        step({k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in local.items()})
        states[remat] = {"state": model.state_dict(),
                         "counts": dict(distributed.all_reduce_counts)}
    return {"plain": states[False], "remat": states[True]}


def _dropout_check(spec, mesh):
    """Each rank's dropout stream at one iteration: the first attention
    seed its generator draws, and that seed's keep mask."""
    from virtex_tpu_torch.engine.train_state import step_seed
    from virtex_tpu_torch.ops.attention import philox_keep_reference

    gen = torch.Generator().manual_seed(step_seed(spec["seed"],
                                                  spec["iteration"],
                                                  mesh.rank))
    seed = torch.randint(2**31 - 1, (), generator=gen)
    return {"seed": int(seed),
            "keep": philox_keep_reference(seed, 2, 4, 8, 8, 0.1)}


def _counted(check, spec, mesh):
    """``check``'s output, with the all-reduces it made by what they
    reduce."""
    distributed.reset_all_reduce_counts()
    out = check(spec, mesh)
    out["all_reduce_counts"] = dict(distributed.all_reduce_counts)
    return out


def checks(spec, mesh):
    return {"bn": _counted(_bn_check, spec["bn"], mesh),
            "sampler": [_counted(_sampler_check, s, mesh)
                        for s in spec["sampler"]],
            "step": _counted(_step_check, spec["step"], mesh),
            "remat": _remat_check(spec["step"], mesh),
            "dropout": _counted(_dropout_check, spec["dropout"], mesh)}


def _tp_model(spec, mesh, overrides=()):
    """The model of ``spec`` from its full state dict (ranks but 0 from
    other weights, which the broadcast replaces), sliced to this rank's
    shard, its optimizer and its train step."""
    from virtex_tpu_torch.config import Config, ModelSpec, OptimSpec
    from virtex_tpu_torch.engine.trainer import make_train_step
    from virtex_tpu_torch.factories import PretrainingModelFactory
    from virtex_tpu_torch.optim.optimizer import build_optimizer
    from virtex_tpu_torch.parallel import replicate_, shard_module_

    cfg = Config(override_list=spec["overrides"] + list(overrides))
    model = PretrainingModelFactory.from_spec(ModelSpec.from_config(cfg),
                                              device="cpu")
    model.load_state_dict(spec["state_dict"], strict=True)
    if mesh.rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    shard_module_(replicate_(model, mesh), mesh)
    opt = build_optimizer(model.named_parameters(),
                          OptimSpec.from_config(cfg), mesh=mesh)
    gen = torch.Generator().manual_seed(spec.get("seed", 0) + mesh.data_rank)
    step = make_train_step(model, opt, accum_steps=spec["accum"],
                           generator=gen, mesh=mesh)
    return model, opt, step


def _tp_local(batch, mesh):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in local_rows(batch, mesh, micro=True).items()}


def _tp_step_check(spec, mesh):
    """The train steps of ``spec`` on this rank's data shard and head
    shard: the metrics, the first step's gradients and all-reduces (the
    gradients gathered to full names), and the full state after the
    last."""
    from virtex_tpu_torch.engine.train_state import TrainState
    from virtex_tpu_torch.parallel.mesh import gather_tensor

    model, opt, step = _tp_model(spec, mesh)
    metrics, grads, counts = [], None, None
    for i, batch in enumerate(spec["batches"]):
        distributed.reset_all_reduce_counts()
        metrics.append({k: float(v) for k, v in step(
            _tp_local(batch, mesh)).items()})
        if i == 0:
            counts = dict(distributed.all_reduce_counts)
            grads = {n: gather_tensor(n, p.grad, mesh)
                     for n, p in model.named_parameters()}
    state = TrainState(model, opt, mesh=mesh).state_dict()
    return {"metrics": metrics, "grads": grads, "counts": counts,
            "state": state["model"], "optimizer": state["optimizer"]}


def _tp_dropout_check(spec, mesh):
    """Steps at dropout 0.1: this rank's own (sharded) state after each."""
    model, _, step = _tp_model(spec, mesh, ["MODEL.TEXTUAL.DROPOUT", 0.1])
    states, metrics = [], []
    for batch in spec["batches"]:
        metrics.append({k: float(v) for k, v in step(
            _tp_local(batch, mesh)).items()})
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return {"states": states, "metrics": metrics}


def _tp_resume_check(spec, mesh):
    """With ``spec["save_dir"]``: a checkpoint written there after the
    first step, at this grid. With ``spec["resume_from"]`` (a checkpoint
    written at another ``model``): the second step resumed from it, its
    metrics and full state."""
    from virtex_tpu_torch.engine.checkpointing import CheckpointManager
    from virtex_tpu_torch.engine.train_state import TrainState

    out = {}
    if "save_dir" in spec:
        model, opt, step = _tp_model(spec, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step(_tp_local(spec["batches"][0], mesh))
        state.iteration = 1
        CheckpointManager(spec["save_dir"]).step(state)
    if "resume_from" in spec:
        model, opt, step = _tp_model(spec, mesh)
        state = TrainState(model, opt, mesh=mesh)
        CheckpointManager(os.path.dirname(spec["resume_from"])).load(
            spec["resume_from"], state)
        out["metrics"] = {k: float(v) for k, v in step(
            _tp_local(spec["batches"][1], mesh)).items()}
        out["state"] = state.state_dict()["model"]
    return out


def tp_checks(spec, mesh):
    out = {"step": _tp_step_check(spec["step"], mesh),
           "dropout": _tp_dropout_check(spec["step"], mesh)}
    if "resume" in spec:
        out["resume"] = _tp_resume_check(dict(spec["step"],
                                              **spec["resume"]), mesh)
    return out


def cli(spec):
    """``<module>.main(args)`` with the checkpoint writes and the image ids
    of each training batch recorded."""
    import importlib

    from virtex_tpu_torch.engine import checkpointing
    from virtex_tpu_torch.parallel import mesh as mesh_module

    script = importlib.import_module(
        f"virtex_tpu_torch.scripts.{spec['script']}")
    writes, ids = [], []
    save = checkpointing._atomic_save

    def recorded_save(obj, path):
        writes.append(path)
        save(obj, path)

    checkpointing._atomic_save = recorded_save
    shard = mesh_module.shard_batch

    def recorded_shard(batch, device, accum=1):
        if accum > 1 and "image_id" in batch:  # a training batch
            ids.append(np.asarray(batch["image_id"]).tolist())
        return shard(batch, device, accum)

    script.shard_batch = recorded_shard
    parser = (script.build_parser() if hasattr(script, "build_parser")
              else script.common_parser())
    result = script.main(parser.parse_args(spec["args"]))
    return {"result": result, "writes": writes, "ids": ids,
            "all_reduce_counts": dict(distributed.all_reduce_counts)}


def main() -> None:
    job, spec_path = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    if job == "cli":
        out = cli(spec)  # the script joins the group, from the environment
    else:
        from virtex_tpu_torch.parallel import create_mesh
        distributed.initialize(backend="gloo")
        if job == "tp":
            out = tp_checks(spec, create_mesh(*spec["grid"]))
        else:
            out = checks(spec, create_mesh())
    rank = distributed.get_rank()
    torch.save(out, f"{spec['out']}/rank{rank}.pt")
    distributed.shutdown()


if __name__ == "__main__":
    main()
