r"""
The process group the ops reduce over, published by the engine.

Counterpart of ``virtex_tpu/ops/_mesh.py``. Under data parallelism the ops
whose math runs over the batch must reduce over the global batch: the
BatchNorm statistics and K4's channel sums, and the denominators of the
masked-mean losses. The ops cannot see the group on their own, so the
train step publishes it around its forward and backward
(:func:`kernel_group`) and the ops read it (:func:`active_group`). With no
group published, or outside a train step, every op is the single-process
one.

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


@contextlib.contextmanager
def kernel_group(group: Optional[dist.ProcessGroup]):
    """Publish ``group`` to the ops within the block (None: off)."""
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_group() -> Optional[dist.ProcessGroup]:
    """The group published by the enclosing train step, if any."""
    return _ACTIVE.get()


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
