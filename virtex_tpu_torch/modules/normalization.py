r"""
BatchNorm with the JAX package's dtype staging and running-stat update.

Counterpart of ``virtex_tpu/modules/normalization.py``
:class:`SubsampledBatchNorm` at ``stat_stride = 1`` (exact BatchNorm):

- statistics in fp32, variance as E[x²] − E[x]² clamped at 0;
- the running variance tracks the UNBIASED variance (Bessel ×n/(n−1)),
  as torch's ``BatchNorm2d`` does, and normalization uses the biased one;
- ``momentum`` keeps the flax convention: 0.9 here is torch's 0.1;
- the output is computed in ``dtype``: ``(x − mean) · (γ·rsqrt(var+ε))``
  with the fp32 factor cast to ``dtype``, then ``+ β``;
- in training the forward and backward are
  :func:`virtex_tpu_torch.ops.batchnorm.bn_train`, whose backward takes its
  channel sums from ``sums_fn`` and dx from ``dx_fn`` (kernel K4's two
  stages on CUDA; a comparison against the plain versions swaps them by
  name).

Channels sit on dim 1 (NCHW, usually a ``channels_last`` view of NHWC
memory). Parameter and buffer names are torch's (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``).
"""
from __future__ import annotations

import torch
from torch import nn

from virtex_tpu_torch.ops.batchnorm import (
    bn_apply,
    bn_backward_dx,
    bn_backward_sums,
    bn_train,
)


class SubsampledBatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 stat_stride: int = 1, zero_init: bool = False):
        super().__init__()
        if stat_stride != 1:
            # The subsampled ("batch") statistics come with training.
            raise NotImplementedError(
                f"stat_stride={stat_stride}: only exact BatchNorm "
                "(stat_stride=1) is ported")
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.sums_fn = bn_backward_sums
        self.dx_fn = bn_backward_dx

    def _update_running(self, mean, var, n: int) -> None:
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[1]
        if self.training:
            y, mean, var = bn_train(x, self.weight, self.bias, self.eps,
                                    self.dtype, self.sums_fn, self.dx_fn)
            self._update_running(mean, var, x.numel() // C)
            return y
        rstd = 1.0 / torch.sqrt(self.running_var + self.eps)
        return bn_apply(x, self.running_mean, rstd, self.weight, self.bias,
                        self.dtype)
