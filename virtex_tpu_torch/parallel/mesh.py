r"""
Data parallelism over the process group: the model replicated, the batch
sharded over the ranks.

Counterpart of ``virtex_tpu/parallel/mesh.py``. The JAX package lays its
devices out in a ``(data, model)`` mesh; the port runs one process per
card, so its ``data`` axis is the process group's world and each process
holds one shard of the global batch. The ``model`` axis (tensor
parallelism of the textual head) is not ported: :func:`create_mesh`
refuses it by name.

The global batch is the union of the ranks' local batches in rank order,
as ``P("data")`` shards it. With gradient accumulation a rank lays its
local batch out as ``(accum, B_local / accum, ...)``, so global micro-step
``j`` is the union of every rank's micro-step ``j``: the JAX package's
``P(None, "data")`` layout of ``(accum, B / accum, ...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from virtex_tpu_torch.utils import distributed

TENSOR_PARALLEL_ITEM = ("ROADMAP.md §1, the queued item \"tensor "
                        "parallelism of the textual head\"")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks on the ``data`` axis, this process's place on it, and the
    group the collectives run in (None: one process, no collective). There
    is no ``model`` axis: :func:`create_mesh` refuses one."""
    data: int
    rank: int
    group: Optional[dist.ProcessGroup]


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of this run: ``data`` (``PARALLEL.DATA``) is -1 or the
    world size; ``model`` (``PARALLEL.MODEL``) must be 1. Under an
    initialised process group the mesh carries it, at world size 1 too."""
    if model != 1:
        raise ValueError(f"PARALLEL.MODEL = {model}: tensor parallelism of "
                         f"the textual head is not ported (see "
                         f"{TENSOR_PARALLEL_ITEM}); set PARALLEL.MODEL 1")
    world = distributed.get_world_size()
    if data not in (-1, world):
        raise ValueError(f"PARALLEL.DATA = {data}: the data axis is the "
                         f"process group's world of {world} ranks (one "
                         f"process per card); set -1 or {world}")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(data=world, rank=distributed.get_rank(), group=group)


def shard_batch(batch: Dict[str, Any], device: torch.device, accum: int = 1
                ) -> Dict[str, torch.Tensor]:
    """A rank's local batch (numpy or torch leaves ``(B_local, ...)``) on
    ``device`` (pinned tensors copy ``non_blocking``). With ``accum`` > 1
    the leaves take the accumulation layout ``(accum, B_local / accum,
    ...)`` (the JAX package's ``micro=True``), whose micro-step ``j`` is
    this rank's part of global micro-step ``j``."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device, non_blocking=True)
        if accum > 1:
            if t.shape[0] % accum:
                raise ValueError(f"a local batch of {t.shape[0]} does not "
                                 f"split into {accum} micro-steps")
            t = t.reshape((accum, t.shape[0] // accum) + tuple(t.shape[1:]))
        out[k] = t
    return out


def replicate_(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 in place,
    so that every rank starts from rank 0's state."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module
