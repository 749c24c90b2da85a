r"""
BatchNorm with the JAX package's dtype staging and running-stat update.

Counterpart of ``virtex_tpu/modules/normalization.py``
:class:`SubsampledBatchNorm`:

- statistics in fp32, variance as E[x²] − E[x]² clamped at 0;
- the running variance tracks the UNBIASED variance (Bessel ×n/(n−1), n
  the statistics' elements per channel), as torch's ``BatchNorm2d`` does,
  and normalization uses the biased one;
- ``momentum`` keeps the flax convention: 0.9 here is torch's 0.1;
- the output is computed in ``dtype``: ``(x − mean) · (γ·rsqrt(var+ε))``
  with the fp32 factor cast to ``dtype``, then ``+ β``;
- in training at ``stat_stride`` 1 (exact BatchNorm) the forward and
  backward are :func:`virtex_tpu_torch.ops.batchnorm.bn_train`, whose
  forward takes its statistics from ``stats_fn`` (the statistics kernel on
  CUDA, which updates the running statistics in the same launch) and y
  from ``apply_fn`` (the apply kernel), and whose backward takes its
  channel sums from ``sums_fn`` and dx from ``dx_fn`` (kernel K4's two
  stages on CUDA); a comparison against the plain versions swaps the four
  by name;
- in eval mode the output is ``apply_fn``
  (:func:`~virtex_tpu_torch.ops.batchnorm.bn_apply`) of the running
  statistics: the apply kernel on CUDA when no gradient is taken through it
  (``no_grad``, a frozen CNN), the torch ops otherwise;
- at ``stat_stride`` > 1 the statistics come from the "batch" sample: the
  first ``B // div`` images, ``div = max(1, min(stat_stride, B // 8))``, so
  a batch under 16 stays exact. The whole batch is normalised with them,
  and plain autograd differentiates it, so the statistics' gradient flows
  through the sample alone. As in the JAX package, whose kernel gate
  needs ``stat_stride`` 1, this path launches no K4. The JAX package's
  other sampler, "rows", is reached by no config key and is not ported;
- under data parallelism (a group published by the train step,
  ``ops/_mesh.py``) the statistics are the global batch's, as the JAX
  package's over its sharded batch: the exact path through
  :func:`bn_train`, and the sampler from the global prefix, ``div`` taken
  from the global ``B`` and rank ``r`` contributing ``clamp(P − r·B_local,
  0, B_local)`` of the ``P`` prefix images (a rank with none still joins
  the all-reduce, whose backward sums the cotangent over the ranks). The
  running variance's Bessel factor takes the global count.

Channels sit on dim 1 (NCHW, usually a ``channels_last`` view of NHWC
memory). Parameter and buffer names are torch's (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``).
"""
from __future__ import annotations

import torch
from torch import nn

from virtex_tpu_torch.ops._mesh import (
    active_group,
    all_reduce_sum_with_grad,
    rank_of,
    world_of,
)
from virtex_tpu_torch.ops.batchnorm import (
    Running,
    bn_apply,
    bn_backward_dx,
    bn_backward_sums,
    bn_forward_stats,
    bn_train,
    update_running_reference,
)
from virtex_tpu_torch.utils.tracing import span


class SubsampledBatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 stat_stride: int = 1, zero_init: bool = False):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.stat_stride = stat_stride
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.stats_fn, self.apply_fn = bn_forward_stats, bn_apply
        self.sums_fn, self.dx_fn = bn_backward_sums, bn_backward_dx

    def _running(self, n: int) -> Running:
        """The running statistics, updated from ``n`` elements a channel."""
        return Running(self.running_mean, self.running_var,
                       self.num_batches_tracked, self.momentum, n)

    def _sampled(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode forward on the "batch" sample's statistics."""
        group = active_group()
        world, rank = world_of(group), rank_of(group)
        B, C = x.shape[0], x.shape[1]
        div = max(1, min(self.stat_stride, B * world // 8))
        prefix = B * world // div
        take = min(max(prefix - rank * B, 0), B)
        sample = x[:take].float()
        dims = [d for d in range(x.dim()) if d != 1]
        if take:
            stats = torch.stack([sample.mean(dims),
                                 sample.square().mean(dims)])
        else:  # zeros, on the graph: the backward's all-reduce runs here too
            stats = torch.stack([sample.sum(dims), sample.sum(dims)])
        if group is not None:
            # Each rank's means weigh its share of the prefix (all of it
            # at world 1, whose bits stay the single-process ones).
            if world > 1:
                stats = stats * (take / prefix)
            stats = all_reduce_sum_with_grad(stats, group, "bn_stats")
        mean, mean2 = stats
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        update_running_reference(self._running(prefix * (x[0].numel() // C)),
                                 mean.detach(), var.detach())
        return self.apply_fn(x, mean, 1.0 / torch.sqrt(var + self.eps),
                             self.weight, self.bias, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("bn_fwd", x):
            C = x.shape[1]
            if self.training and self.stat_stride > 1:
                return self._sampled(x)
            if self.training:
                n = x.numel() // C * world_of(active_group())
                return bn_train(x, self.weight, self.bias, self.eps,
                                self.dtype, self.sums_fn, self.dx_fn,
                                self._running(n), self.stats_fn,
                                self.apply_fn)[0]
            rstd = 1.0 / torch.sqrt(self.running_var + self.eps)
            return self.apply_fn(x, self.running_mean, rstd, self.weight,
                                 self.bias, self.dtype)
