r"""
Data and tensor parallelism over the process group: a ``(data, model)``
grid of processes, the batch sharded over ``data``, the textual head's
attention heads and feed-forward columns over ``model``.

Counterpart of ``virtex_tpu/parallel/mesh.py``. The JAX package lays its
devices out in a ``(data, model)`` mesh; the port runs one process per
card, and the world is the grid ``data × model`` with the ``model`` ranks
of one data shard adjacent (world rank ``d · model + m``), as
``create_mesh`` orders its devices. Each process holds one shard of the
global batch, the one its data rank names, and with ``model`` > 1 one
shard of the textual head.

The global batch is the union of the data ranks' local batches in rank
order, as ``P("data")`` shards it. With gradient accumulation a rank lays
its local batch out as ``(accum, B_local / accum, ...)``, so global
micro-step ``j`` is the union of every data rank's micro-step ``j``: the
JAX package's ``P(None, "data")`` layout of ``(accum, B / accum, ...)``.

Tensor parallelism follows the JAX package's ``_TP_RULES`` (the Megatron
layout) in the port's parameter names (:data:`TP_RULES`): the packed
``in_proj_weight``/``in_proj_bias`` of both attentions and ``linear1`` are
split by output rows, each of q, k and v by heads; ``out_proj.weight``
and ``linear2.weight`` by input columns; everything else, the biases of
``out_proj`` and ``linear2`` included, is replicated.
:func:`shard_module_` slices a full model in place to this rank's shard;
:func:`gather_state_dict` and :func:`shard_state_dict` move state dicts
between the full names and a rank's shard. A head count or feed-forward
size that ``model`` does not divide is refused by name
(:func:`check_divisible`); the JAX package would fall back to an
attention without dropout there, and the port has no fallback.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from virtex_tpu_torch.utils import distributed

# The port's counterpart of ``_TP_RULES``: a parameter name → how it is
# split. "qkv": the packed (3H, ...) rows, each of q, k and v by heads;
# "rows": torch dim 0 (the output features, a column split in flax's
# (in, out) layout); "cols": torch dim 1 (the input features, flax's row
# split). First match wins; no match is replicated.
_LAYER = r"^(textual|backward_textual)\.transformer\.layers\.\d+\."
TP_RULES = [
    (_LAYER + r"(self_attn|multihead_attn)\.in_proj_(weight|bias)$", "qkv"),
    (_LAYER + r"(self_attn|multihead_attn)\.out_proj\.weight$", "cols"),
    (_LAYER + r"linear1\.(weight|bias)$", "rows"),
    (_LAYER + r"linear2\.weight$", "cols"),
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid of ranks, this process's place in it, and the groups the
    collectives run in (None: one process, no collective).

    ``data`` × ``model`` ranks; ``rank`` is the world rank, ``group`` the
    world; ``data_group`` holds the ranks with this rank's shard of the
    model (the world when ``model`` is 1), ``model_group`` the ranks with
    this rank's data shard (None when ``model`` is 1)."""
    data: int
    rank: int
    group: Optional[dist.ProcessGroup]
    model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.model == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def data_rank(self) -> int:
        """This rank's place on the ``data`` axis: its batch shard."""
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        """This rank's place on the ``model`` axis: its head shard."""
        return self.rank % self.model


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of this run: ``data`` (``PARALLEL.DATA``) is -1 or the
    world size over ``model`` (``PARALLEL.MODEL``), which must divide the
    world. Under an initialised process group the mesh carries it, at
    world size 1 too; with ``model`` > 1 it builds the data and model
    groups (every rank calls this, in the same order)."""
    world = distributed.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"PARALLEL.MODEL = {model}: the model axis must "
                         f"divide the process group's world of {world} "
                         f"ranks (one process per card)")
    if data not in (-1, world // model):
        raise ValueError(f"PARALLEL.DATA = {data}: the data axis is the "
                         f"world of {world} ranks over PARALLEL.MODEL "
                         f"{model}; set -1 or {world // model}")
    group = dist.group.WORLD if dist.is_initialized() else None
    rank = distributed.get_rank()
    if model == 1:
        return Mesh(data=world, rank=rank, group=group)
    data_group, model_group = distributed.grid_groups(world // model, model)
    return Mesh(data=world // model, rank=rank, group=group, model=model,
                data_group=data_group, model_group=model_group)


def check_divisible(textual: Dict[str, int], model: int) -> None:
    """Refuse a textual head (``ModelSpec.textual``) whose attention heads
    or feed-forward size ``model`` does not divide."""
    for key, what in (("attention_heads", "attention heads"),
                      ("feedforward_size", "feed-forward size")):
        if textual[key] % model:
            raise ValueError(f"PARALLEL.MODEL = {model}: the textual head's "
                             f"{what} {textual[key]} is not divisible by "
                             f"{model}; tensor parallelism splits it over "
                             f"the model axis")


def tp_split(name: str) -> Optional[str]:
    """How :data:`TP_RULES` split the parameter ``name``, or None."""
    for pattern, how in TP_RULES:
        if re.match(pattern, name):
            return how
    return None


def _pieces(name: str, t: torch.Tensor, parts: int):
    """``t`` cut into ``parts`` shards as :data:`TP_RULES` split it."""
    how = tp_split(name)
    if how == "qkv":
        qkv = t.reshape((3, t.shape[0] // 3) + tuple(t.shape[1:]))
        return [c.reshape((-1,) + tuple(t.shape[1:]))
                for c in qkv.chunk(parts, dim=1)]
    return list(t.chunk(parts, dim=0 if how == "rows" else 1))


def shard_tensor(name: str, full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the full tensor of parameter ``name`` (the
    tensor itself when ``name`` is replicated)."""
    if mesh.model == 1 or tp_split(name) is None:
        return full
    return _pieces(name, full, mesh.model)[mesh.model_rank].contiguous()


def gather_tensor(name: str, local: torch.Tensor, mesh: Mesh,
                  what: str = "tp_gather") -> torch.Tensor:
    """The full tensor of parameter ``name`` from the model group's shards
    (``local`` itself when ``name`` is replicated). Every rank of the
    model group calls it."""
    how = tp_split(name)
    if mesh.model == 1 or how is None:
        return local
    shards = distributed.all_gather(local.detach(), what, mesh.model_group)
    if how != "qkv":
        return torch.cat(shards, dim=0 if how == "rows" else 1)
    rest = tuple(local.shape[1:])
    qkv = [s.reshape((3, s.shape[0] // 3) + rest) for s in shards]
    return torch.cat(qkv, dim=1).reshape((-1,) + rest)


def gather_state_dict(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A state dict of full tensors from this rank's (the same keys), by
    gathering the split ones over the model group, in key order. Every
    rank of the model group calls it."""
    return {k: gather_tensor(k, v, mesh) if torch.is_tensor(v) else v
            for k, v in state.items()}


def shard_state_dict(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's shard of a state dict of full tensors."""
    return {k: shard_tensor(k, v, mesh) if torch.is_tensor(v) else v
            for k, v in state.items()}


def shard_module_(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Slice ``model``'s split parameters in place to this rank's shard
    (the parameter objects stay, so ties and references hold) and tell its
    attention and decoder layers how many shards they hold. A no-op when
    ``model`` is 1."""
    if mesh.model == 1:
        return model
    from virtex_tpu_torch.modules.latent_moe import LatentMoEDecoder
    from virtex_tpu_torch.modules.transformer import (
        DecoderLayer,
        MultiHeadAttention,
    )
    if any(isinstance(m, LatentMoEDecoder) for m in model.modules()):
        raise ValueError("shard_module_: the moe_mla head has no tensor "
                         "parallel form; run it at PARALLEL.MODEL 1")
    layers = [m for m in model.modules()
              if isinstance(m, (MultiHeadAttention, DecoderLayer))]
    for m in layers:
        if m.shards != 1:
            raise ValueError("shard_module_: the model is sharded already")
        if isinstance(m, DecoderLayer):
            check_divisible({"attention_heads": m.num_heads,
                             "feedforward_size": m.feedforward_size},
                            mesh.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if tp_split(name) is not None:
                p.data = shard_tensor(name, p.data, mesh)
    for m in layers:
        m.shards = mesh.model
    return model


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
    """Broadcast ``module``'s parameters and buffers from rank 0 over the
    world in place, so that every rank starts from rank 0's state (before
    :func:`shard_module_`)."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module
