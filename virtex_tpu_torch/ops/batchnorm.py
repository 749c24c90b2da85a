r"""
Train-mode BatchNorm with a hand-written backward: kernel K4 and its plain
version.

Counterpart of ``virtex_tpu/ops/batchnorm.py``. :func:`bn_train` is a
:class:`torch.autograd.Function` whose forward is the math of
``SubsampledBatchNorm`` at ``stat_stride = 1`` (statistics in fp32, the
output computed in ``dtype``) and whose backward is the analytic BN
gradient ``dx = γ·rstd·(dy − dβ/M − x̂·dγ/M)``, with the channel sums
(dβ, dγ) = (Σ dy, Σ dy·x̂) from :func:`bn_backward_sums`. The mean and
variance it returns feed the running statistics, which are updated under
``no_grad``, so their cotangents are zero.

On a CPU tensor :func:`bn_backward_sums` computes the plain version
(:func:`bn_backward_sums_reference`). On a CUDA tensor it launches K4
(``csrc/bn_backward_sums.cu``) or raises; there is no fallback and no shape
it refuses for its size (the JAX package falls back to jnp where its TPU
tiling plan fails). :data:`launch_count` counts K4 launches.

Layout: channels on dim 1, as torch's ``BatchNorm2d`` has them; the
ResNet's activations are ``channels_last`` (NHWC memory), which K4 reads as
row-major (M, C). A tensor in another memory format is copied to that
layout first, explicitly, never read in the wrong one.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

# Blocks of 256 threads resident on the H100's 132 SMs at once (8 each):
# K4 takes about two waves of row chunks.
_TARGET_BLOCKS = 2 * 132 * 8
_COLS_PER_BLOCK = 32
_MIN_ROWS_PER_CHUNK = 64

launch_count = 0  # K4 launches since import or the last reset

SumsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _stat_shape(x: torch.Tensor) -> Tuple[int, ...]:
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


def bn_backward_sums_reference(dy: torch.Tensor, x: torch.Tensor,
                               mean: torch.Tensor, rstd: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version of K4 (the JAX backward's jnp reduction): (2, C) fp32
    ``[Σ dy ; Σ dy·(x − μ)·rstd]`` over every dim but 1."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = _stat_shape(x)
    dyf = dy.float()
    xhat = (x.float() - mean.reshape(shape)) * rstd.reshape(shape)
    return torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) → row-major (M, C): a view of channels_last memory, a
    copy of any other layout."""
    return t.movedim(1, -1).reshape(-1, t.shape[1]).contiguous()


def _launch(dy, x, mean, rstd) -> torch.Tensor:
    global launch_count
    from virtex_tpu_torch.ops import _build

    for name, t in (("dy", dy), ("x", x)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"K4 takes float32 or bfloat16 {name}, got "
                            f"{t.dtype}")
    dy2, x2 = _rows(dy), _rows(x)
    M, C = x2.shape
    if M == 0 or C == 0:
        raise ValueError(f"K4 needs a non-empty input, got {tuple(x.shape)}")
    if C >= 2**31:
        raise ValueError(f"K4: C = {C} channels is too many")
    mean = mean.to(torch.float32).contiguous()
    rstd = rstd.to(torch.float32).contiguous()
    col_tiles = math.ceil(C / _COLS_PER_BLOCK)
    chunks = max(1, min(math.ceil(M / _MIN_ROWS_PER_CHUNK),
                        _TARGET_BLOCKS // col_tiles, 65535))
    partial = torch.empty((chunks, 2, C), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.virtex_bn_backward_sums(
            dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            partial.data_ptr(), out.data_ptr(), M, C, chunks,
            int(dy2.dtype == torch.bfloat16), int(x2.dtype == torch.bfloat16),
            stream)
    _build.check(err, "K4 bn_backward_sums launch")
    launch_count += 1
    return out


def bn_backward_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor) -> torch.Tensor:
    """(dβ, dγ) = (Σ dy, Σ dy·x̂) per channel, over every dim but 1, as a
    (2, C) fp32 tensor. K4 on CUDA; the plain version on the CPU."""
    if dy.shape != x.shape or x.dim() < 2:
        raise ValueError(f"bn_backward_sums: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} must be one (N, C, ...) shape")
    C = x.shape[1]
    if mean.shape != (C,) or rstd.shape != (C,):
        raise ValueError(f"bn_backward_sums: mean and rstd must be ({C},)")
    if len({dy.device, x.device, mean.device, rstd.device}) != 1:
        raise ValueError("bn_backward_sums: operands on different devices")
    if x.device.type == "cpu":
        return bn_backward_sums_reference(dy, x, mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"bn_backward_sums: no kernel for {x.device}")
    return _launch(dy, x, mean, rstd)


def bn_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
             weight: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``(x − μ)·(γ·rstd) + β`` in ``dtype``, the fp32 factors cast to it
    (the JAX package's dtype staging)."""
    shape = _stat_shape(x)
    mul = rstd * weight
    y = (x.to(dtype) - mean.reshape(shape).to(dtype)) \
        * mul.reshape(shape).to(dtype)
    return y + bias.reshape(shape).to(dtype)


def bn_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype):
    """The exact train-mode forward: fp32 statistics (variance E[x²] −
    E[x]² clamped at 0), then :func:`bn_apply`. Returns y, mean, var,
    rstd."""
    dims = [d for d in range(x.dim()) if d != 1]
    xf = x.float()
    mean = xf.mean(dims)
    var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    return bn_apply(x, mean, rstd, weight, bias, dtype), mean, var, rstd


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype, sums_fn):
        y, mean, var, rstd = bn_forward(x, weight, bias, eps, dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.sums_fn = sums_fn
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        shape = _stat_shape(x)
        m = x.numel() // x.shape[1]
        sums = ctx.sums_fn(dy, x, mean, rstd)
        dbeta, dgamma = sums[0], sums[1]
        # dx = γ·rstd·((dy − x̂·dγ/M) − dβ/M), in fp32; each torch.sub
        # makes a new fp32 tensor, so the in-place steps touch no input.
        xhat_dg = torch.sub(x, mean.reshape(shape)).mul_(
            (rstd * dgamma / m).reshape(shape))
        dx = torch.sub(dy, xhat_dg).sub_((dbeta / m).reshape(shape)).mul_(
            (weight * rstd).reshape(shape))
        return (dx.to(x.dtype), dgamma.to(weight.dtype),
                dbeta.to(weight.dtype), None, None, None)


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, dtype: torch.dtype,
             sums_fn: SumsFn = bn_backward_sums):
    """Train-mode BatchNorm over every dim but 1 → ``(y, mean, var)``.
    ``mean`` and ``var`` (fp32, not differentiable) are for the running
    statistics; ``sums_fn`` computes the backward's channel sums."""
    return _BNTrain.apply(x, weight, bias, eps, dtype, sums_fn)
