r"""
The process groups the ops reduce over, published by the engine.

Counterpart of ``virtex_tpu/ops/_mesh.py``. Under data parallelism the ops
whose math runs over the batch must reduce over the global batch: the
BatchNorm statistics and K4's channel sums, and the denominators of the
masked-mean losses. Under tensor parallelism the textual head's sharded
blocks sum their partial outputs over the model group. The ops cannot see
the groups on their own, so the train and eval steps publish them around
their forward and backward (:func:`kernel_group`: the data group, and the
model group) and the ops read them (:func:`active_group`,
:func:`active_model_group`). With no group published, or outside a step,
every op is the single-process one.

The model group's two autograd functions are the Megatron pair:
:func:`copy_to_model_group` (identity forward, all-reduce backward) on the
input of a block whose weights are split by output, and
:func:`reduce_from_model_group` (all-reduce forward, identity backward) on
the partial output of a block whose weights are split by input. Both sum
in fp32.

Autograd runs a CUDA backward in a thread of its own, where this context
is not set: an op reads the group in its forward and keeps it for its
backward.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

from virtex_tpu_torch.utils.distributed import all_reduce_sum

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "virtex_tpu_torch_kernel_group", default=None)
_MODEL: contextvars.ContextVar = contextvars.ContextVar(
    "virtex_tpu_torch_model_group", default=None)


@contextlib.contextmanager
def kernel_group(group: Optional[dist.ProcessGroup],
                 model_group: Optional[dist.ProcessGroup] = None):
    """Publish the data ``group`` and the ``model_group`` to the ops
    within the block (None: off)."""
    token, model_token = _ACTIVE.set(group), _MODEL.set(model_group)
    try:
        yield
    finally:
        _MODEL.reset(model_token)
        _ACTIVE.reset(token)


def active_group() -> Optional[dist.ProcessGroup]:
    """The data group published by the enclosing step, if any: the ranks
    whose batch shards make the global batch."""
    return _ACTIVE.get()


def active_model_group() -> Optional[dist.ProcessGroup]:
    """The model group published by the enclosing step, if any: the ranks
    that hold the shards of the textual head."""
    return _MODEL.get()


def world_of(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def mean_denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a masked mean over the batch, ``max(count, 1)``.
    Under data parallelism it is the global count over the world size, so
    that each rank's loss is its share of the global mean: the mean over
    ranks of ``Σ_local / denominator`` is ``Σ_global / max(count_global,
    1)``, which is what the JAX package's mean over the sharded batch
    is."""
    group = active_group()
    if group is None:
        return torch.clamp(count, min=1.0)
    total = all_reduce_sum(count.detach().clone(), "loss_count", group)
    return torch.clamp(total, min=1.0) / world_of(group)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the cotangent over it:
    each rank's cotangent is the gradient of its own loss, and the summed
    one that of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        return all_reduce_sum(x.clone(), what, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.what,
                              ctx.group), None, None


def all_reduce_sum_with_grad(x: torch.Tensor, group: dist.ProcessGroup,
                             what: str) -> torch.Tensor:
    """:func:`all_reduce_sum` of a copy of ``x``, differentiable."""
    return _AllReduceSum.apply(x, group, what)


def _fp32_sum(x: torch.Tensor, group, what: str) -> torch.Tensor:
    """An fp32 copy of ``x`` summed over ``group``."""
    copy = x.to(torch.float32, copy=True,
                memory_format=torch.contiguous_format)
    return all_reduce_sum(copy, what, group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group, so the replicated input's gradient takes every shard's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp32_sum(g, ctx.group, "tp_copy").to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the shards' partial outputs over the model group, fp32;
    the backward hands each shard the cotangent as it is."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _fp32_sum(x, group, "tp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model_group(x: torch.Tensor, group: dist.ProcessGroup
                        ) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` in the backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group: dist.ProcessGroup
                            ) -> torch.Tensor:
    """The fp32 sum of ``x`` over ``group``; its gradient passes
    through."""
    return _ReduceFromModel.apply(x, group)
