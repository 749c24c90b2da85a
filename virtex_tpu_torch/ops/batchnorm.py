r"""
BatchNorm with hand-written kernels: the forward's statistics and apply,
the train-mode backward (kernel K4, two stages), and their plain versions.

Counterpart of ``virtex_tpu/ops/batchnorm.py``. :func:`bn_train` is a
:class:`torch.autograd.Function` whose forward is the math of
``SubsampledBatchNorm`` at ``stat_stride = 1`` (statistics in fp32, the
output computed in ``dtype``; two launches, below) and whose backward is
the analytic BN gradient ``dx = γ·rstd·(dy − dβ/M − x̂·dγ/M)`` in two
launches: the channel sums (dβ, dγ) = (Σ dy, Σ dy·x̂) from
:func:`bn_backward_sums` (stage 1), then dx from :func:`bn_backward_dx`
(stage 2), which on the TPU is the jnp stage that XLA fuses into one pass.
The mean and variance it returns feed the running statistics, which are
updated under ``no_grad``, so their cotangents are zero.

Under data parallelism (a group published by the train step,
``ops/_mesh.py``) the statistics and the sums are those of the global
batch, as the JAX package's ``psum`` over ``data`` makes them: the forward
all-reduces the fp32 (2, C) ``[E_local[x] ; E_local[x²]]``, each rank's
weighed by its share of the global count, before it forms the mean and
``E[x²] − E[x]²``; the backward all-reduces stage 1's (2, C) sums, into a
copy, between the two launches, on the current stream, and stage 2 divides
by the global count (``m_total``). dγ and dβ are returned as the local
sums: the train step's gradient all-reduce sums them over the ranks (torch
``SyncBatchNorm``'s rule). Every rank holds a shard of one shape.

On a CPU tensor each stage computes its plain version
(:func:`bn_backward_sums_reference`, :func:`bn_backward_dx_reference`). On
a CUDA tensor it launches its kernel (``csrc/bn_backward_sums.cu``) or
raises; there is no fallback and no shape it refuses for its size (the JAX
package falls back to jnp where its TPU tiling plan fails). Each stage has
a vector variant (16-byte loads) and a scalar one, chosen by
:func:`k4_vector_width`; :func:`k4_plan` sizes the grid. ``ops/_launch.py``
counts the launches under ``("k4_sums" | "k4_dx", "vector" | "scalar")``,
and under ``("k4_dy", "copy")`` the stage-1 launches whose dy had to be
copied to rows first.

The forward is two kernels of its own (``csrc/bn_forward.cu``), with no
TPU kernel behind them: the JAX package leaves the forward to XLA's fusion.
:func:`bn_forward_stats` reads x once for the fp32 means of x and x² (and,
outside data parallelism, finalises var and rstd and updates the running
statistics, :class:`Running`, in the same launch);
:func:`bn_apply` writes y in one pass whenever no gradient is taken through
it (inside :class:`_BNTrain`'s forward, and an eval-mode BatchNorm under
``no_grad`` or frozen), bit-equal to its torch ops. Both take K4's variant
rule and grid; on a CPU tensor both run their plain versions
(:func:`bn_forward_stats_reference`, :func:`bn_apply_reference`). Their
count keys: ``("bn_stats" | "bn_apply", "vector" | "scalar")``.

Layout: channels on dim 1, as torch's ``BatchNorm2d`` has them; the
ResNet's activations are ``channels_last`` (NHWC memory), which the kernels
read as row-major (M, C). A tensor in another memory format is copied to
that layout first, explicitly, never read in the wrong one. dx and y come
back as NCHW views of NHWC memory.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from virtex_tpu_torch.ops._launch import count, launch
from virtex_tpu_torch.ops._mesh import active_group, world_of
from virtex_tpu_torch.utils.distributed import all_reduce_sum

# The vector variants' block: 256 threads over a tile of _TILE_COLS vectors
# of channels (128 bytes of a row of the wider operand) by 256 // _TILE_COLS
# row lanes, fewer columns where C is narrower (csrc kTileCols). The grid
# is one wave of two such blocks on each of the H100's 132 SMs, with at
# least _MIN_ROWS_PER_LANE rows for each row lane.
_THREADS, _TILE_COLS = 256, 8
_VECTOR_BLOCKS = 2 * 132
_MIN_ROWS_PER_LANE = 4
# The scalar variant of stage 1: blocks of 32 channels by 8 warps, resident
# 8 to an SM, about two waves of row chunks.
_SCALAR_BLOCKS = 2 * 132 * 8
_COLS_PER_BLOCK = 32
_MIN_ROWS_PER_CHUNK = 64
_MAX_CHUNKS = 65535  # the grid's y extent

# The launches' count keys, by whether the vector variant ran.
_SUMS = (("k4_sums", "scalar"), ("k4_sums", "vector"))
_DX = (("k4_dx", "scalar"), ("k4_dx", "vector"))
_STATS = (("bn_stats", "scalar"), ("bn_stats", "vector"))
_APPLY = (("bn_apply", "scalar"), ("bn_apply", "vector"))

SumsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]
DxFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor], torch.Tensor]


def _stat_shape(x: torch.Tensor) -> Tuple[int, ...]:
    return (1, x.shape[1]) + (1,) * (x.dim() - 2)


def bn_backward_sums_reference(dy: torch.Tensor, x: torch.Tensor,
                               mean: torch.Tensor, rstd: torch.Tensor
                               ) -> torch.Tensor:
    """Plain version of K4's stage 1 (the JAX backward's jnp reduction):
    (2, C) fp32 ``[Σ dy ; Σ dy·(x − μ)·rstd]`` over every dim but 1."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = _stat_shape(x)
    dyf = dy.float()
    xhat = (x.float() - mean.reshape(shape)) * rstd.reshape(shape)
    return torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])


def bn_backward_dx_reference(dy: torch.Tensor, x: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight: torch.Tensor, sums: torch.Tensor,
                             m_total: Optional[int] = None) -> torch.Tensor:
    """Plain version of K4's stage 2: ``dx = γ·rstd·((dy − x̂·dγ/M) −
    dβ/M)`` in fp32 from the (2, C) ``sums`` = (dβ, dγ), in x's dtype. M is
    ``m_total``, the count the sums run over (the global one under data
    parallelism), or x's own count when None. Each torch.sub makes a new
    fp32 tensor, so the in-place steps touch no input."""
    shape = _stat_shape(x)
    m = _count(x, m_total)
    dbeta, dgamma = sums[0], sums[1]
    xhat_dg = torch.sub(x, mean.reshape(shape)).mul_(
        (rstd * dgamma / m).reshape(shape))
    dx = torch.sub(dy, xhat_dg).sub_((dbeta / m).reshape(shape)).mul_(
        (weight * rstd).reshape(shape))
    return dx.to(x.dtype)


def _count(x: torch.Tensor, m_total: Optional[int]) -> int:
    m = x.numel() // x.shape[1]
    if m_total is None:
        return m
    if m_total < m:
        raise ValueError(f"m_total {m_total} is below the local count {m}")
    return int(m_total)


def k4_vector_width(dtype: torch.dtype, C: int, aligned: bool) -> int:
    """Channels per 16-byte load of K4's vector variants, or 1 for the
    scalar ones. ``dtype`` is the wider of dy's and x's (fp32 if either
    is): 8 for bf16, 4 for fp32. The vector variants need C a multiple of
    that and every operand's base pointer 16-byte ``aligned`` (its row
    stride, C elements, then is too)."""
    width = 16 // dtype.itemsize
    return width if aligned and C % width == 0 else 1


class K4Plan(NamedTuple):
    vec: int             # channels per load; 1 for the scalar variants
    tile_cols: int       # columns (of vec channels) per block
    row_lanes: int       # rows a block reads at once
    col_tiles: int       # the grid's x extent
    chunks: int          # the grid's y extent: row chunks, none empty
    rows_per_chunk: int


@functools.lru_cache(maxsize=4096)
def k4_plan(M: int, C: int, vec: int) -> K4Plan:
    """K4's grid over row-major (M, C) operands, for both stages: column
    tiles by row chunks. The vector variants take one wave of
    _VECTOR_BLOCKS blocks where the rows allow, small C more rows per
    block rather than more column tiles."""
    if vec == 1:
        tile_cols, row_lanes = _COLS_PER_BLOCK, _THREADS // _COLS_PER_BLOCK
        col_tiles = math.ceil(C / tile_cols)
        want = min(math.ceil(M / _MIN_ROWS_PER_CHUNK),
                   _SCALAR_BLOCKS // col_tiles)
    else:
        cols = C // vec
        tile_cols = min(cols, _TILE_COLS)
        row_lanes = _THREADS // tile_cols
        col_tiles = math.ceil(cols / tile_cols)
        want = min(math.ceil(M / (row_lanes * _MIN_ROWS_PER_LANE)),
                   _VECTOR_BLOCKS // col_tiles)
    rows = math.ceil(M / max(1, min(want, _MAX_CHUNKS)))
    return K4Plan(vec, tile_cols, row_lanes, col_tiles, math.ceil(M / rows),
                  rows)


def _is_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` (N, C, *S) already lies as row-major (M, C) memory:
    channels minor, then the spatial dims, then N, with no gaps (size-1
    dims aside). Read from the strides, with no tensor op (for 4-d and 2-d
    tensors torch's own contiguity flags say it): the wrappers run several
    times a BatchNorm, so their host work per call counts."""
    if t.dim() == 4:
        return t.is_contiguous(memory_format=torch.channels_last)
    if t.dim() == 2:
        return t.is_contiguous()
    expected = 1
    for d in (1, *range(t.dim() - 1, 1, -1), 0):
        if t.shape[d] != 1 and t.stride(d) != expected:
            return False
        expected *= t.shape[d]
    return True


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) → row-major (M, C): a view of channels_last memory, a
    copy of any other layout."""
    return t.movedim(1, -1).reshape(-1, t.shape[1]).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous fp32 for a kernel to read; itself, with no op,
    where it already is."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.detach().to(torch.float32).contiguous()


# The reductions' ticket counters, one per column tile, zeroed once per
# device; the kernels leave them zeroed.
_tickets: Dict[torch.device, torch.Tensor] = {}
# The reductions' fp32 partial sums, (chunks, 2, C), one buffer per device
# that each launch overwrites before it reads it back.
_partials: Dict[torch.device, torch.Tensor] = {}


def _buffer(store: Dict[torch.device, torch.Tensor], device: torch.device,
            n: int, make) -> torch.Tensor:
    buf = store.get(device)
    if buf is None or buf.numel() < n:
        buf = make(max(n, 64), device=device)
        store[device] = buf
    return buf


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    return _buffer(_tickets, device, n,
                   lambda k, device: torch.zeros(k, dtype=torch.int32,
                                                 device=device))


def _partial_buffer(device: torch.device, n: int) -> torch.Tensor:
    """Room for ``n`` fp32 partial sums. Like the tickets, it is shared by
    every launch on the device, so they must run in order (one stream)."""
    return _buffer(_partials, device, n,
                   lambda k, device: torch.empty(k, dtype=torch.float32,
                                                 device=device))


def _empty_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised tensor of x's (N, C, *S) shape whose memory is
    row-major (M, C) (an NCHW view of NHWC memory), in one op."""
    strides, step = [0] * x.dim(), x.shape[1]
    strides[1] = 1
    for d in range(x.dim() - 1, 1, -1):
        strides[d] = step
        step *= x.shape[d]
    strides[0] = step
    return torch.empty_strided(x.shape, strides, dtype=dtype,
                               device=x.device)


def _as_rows(name: str, *tensors: torch.Tensor):
    """Each (N, C, *S) operand as row-major (M, C) memory for a kernel to
    read: itself where it already lies so (a channels_last activation),
    else a copy (``_rows``); and M, C."""
    for t in tensors:
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} takes float32 or bfloat16 operands, "
                            f"got {t.dtype}")
    x = tensors[-1]
    if x.numel() == 0:
        raise ValueError(f"{name} needs a non-empty input, got "
                         f"{tuple(x.shape)}")
    C = x.shape[1]
    if C >= 2**31:
        raise ValueError(f"{name}: C = {C} channels is too many")
    return ([t if _is_rows(t) else _rows(t) for t in tensors],
            x.numel() // C, C)


def _operands(dy: torch.Tensor, x: torch.Tensor):
    """dy and x as row-major memory, and the plan of both stages."""
    (dy2, x2), M, C = _as_rows("K4", dy, x)
    wide = torch.float32 if torch.float32 in (dy2.dtype, x2.dtype) \
        else torch.bfloat16
    aligned = dy2.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0
    return dy2, x2, k4_plan(M, C, k4_vector_width(wide, C, aligned))


def _launch(dy, x, mean, rstd) -> torch.Tensor:
    dy_copied = not _is_rows(dy)
    dy2, x2, plan = _operands(dy, x)
    C = x.shape[1]
    M = x.numel() // C
    mean, rstd = _f32(mean), _f32(rstd)
    partial = _partial_buffer(x.device, plan.chunks * 2 * C)
    tickets = _ticket_buffer(x.device, plan.col_tiles) if plan.vec > 1 \
        else None
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    launch(_SUMS[plan.vec > 1], "virtex_bn_backward_sums", x,
           dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           partial.data_ptr(),
           None if tickets is None else tickets.data_ptr(), out.data_ptr(),
           M, C, plan.chunks, plan.vec, int(dy2.dtype == torch.bfloat16),
           int(x2.dtype == torch.bfloat16))
    if dy_copied:
        count(("k4_dy", "copy"))
    return out


def _launch_dx(dy, x, mean, rstd, weight, sums, m_total) -> torch.Tensor:
    dy2, x2, plan = _operands(dy, x)
    C = x.shape[1]
    M = x.numel() // C
    mean, rstd, weight, sums = (_f32(t) for t in (mean, rstd, weight, sums))
    dx = _empty_rows(x, x.dtype)
    launch(_DX[plan.vec > 1], "virtex_bn_backward_dx", x,
           dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           weight.data_ptr(), sums.data_ptr(), dx.data_ptr(), M, C,
           _count(x, m_total), plan.chunks, plan.vec,
           int(dy2.dtype == torch.bfloat16), int(x2.dtype == torch.bfloat16))
    return dx


def _check_operands(name: str, dy: torch.Tensor, x: torch.Tensor,
                    *per_channel: torch.Tensor) -> None:
    if dy.shape != x.shape or x.dim() < 2:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} must be one (N, C, ...) shape")
    C = x.shape[1]
    if any(t.shape != (C,) for t in per_channel):
        raise ValueError(f"{name}: mean, rstd (and weight) must be ({C},)")
    if len({t.device for t in (dy, x) + per_channel}) != 1:
        raise ValueError(f"{name}: operands on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")


def bn_backward_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor) -> torch.Tensor:
    """(dβ, dγ) = (Σ dy, Σ dy·x̂) per channel, over every dim but 1, as a
    (2, C) fp32 tensor. K4's stage 1 on CUDA; the plain version on the
    CPU."""
    _check_operands("bn_backward_sums", dy, x, mean, rstd)
    if x.device.type == "cpu":
        return bn_backward_sums_reference(dy, x, mean, rstd)
    return _launch(dy, x, mean, rstd)


def bn_backward_dx(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor,
                   sums: torch.Tensor, m_total: Optional[int] = None
                   ) -> torch.Tensor:
    """dx of train-mode BatchNorm from the (2, C) ``sums`` of
    :func:`bn_backward_sums`, in x's dtype; ``m_total`` as in
    :func:`bn_backward_dx_reference`. K4's stage 2 on CUDA; the plain
    version on the CPU."""
    _check_operands("bn_backward_dx", dy, x, mean, rstd, weight)
    if sums.shape != (2, x.shape[1]) or sums.device != x.device:
        raise ValueError(f"bn_backward_dx: sums must be (2, {x.shape[1]}) "
                         f"on {x.device}")
    if x.device.type == "cpu":
        return bn_backward_dx_reference(dy, x, mean, rstd, weight, sums,
                                        m_total)
    return _launch_dx(dy, x, mean, rstd, weight, sums, m_total)


def _finalise(mean: torch.Tensor, mean2: torch.Tensor, eps: float):
    """var = max(E[x²] − E[x]², 0) and rstd = 1 / sqrt(var + eps) from the
    fp32 means; the forward kernel's finalisation makes the same roundings."""
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return var, 1.0 / torch.sqrt(var + eps)


class Running(NamedTuple):
    """A BatchNorm's running statistics, which a train-mode forward updates
    in place (flax's momentum convention; ``n`` the statistics' elements per
    channel, the global count under data parallelism):
    ``mean ← m·mean + (1 − m)·μ``, ``var ← m·var + (1 − m)·σ²·n/(n − 1)``
    with σ² the biased variance, and ``count += 1``."""
    mean: torch.Tensor   # (C,) fp32
    var: torch.Tensor    # (C,) fp32
    count: torch.Tensor  # int64 scalar (num_batches_tracked)
    momentum: float
    n: int


def update_running_reference(running: Running, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
    """The running statistics' update in torch ops, each rounding to fp32;
    the statistics kernel's update makes the same roundings."""
    m, n = running.momentum, running.n
    with torch.no_grad():
        running.mean.copy_(m * running.mean + (1.0 - m) * mean)
        running.var.copy_(m * running.var
                          + (1.0 - m) * var * (n / max(n - 1, 1)))
        running.count.add_(1)


def bn_forward_stats_reference(x: torch.Tensor, eps: Optional[float] = None,
                               running: Optional[Running] = None
                               ) -> torch.Tensor:
    """Plain version of the forward's statistics: (2, C) fp32
    ``[E[x] ; E[x²]]`` over every dim but 1, and given ``eps`` two more
    rows, var and rstd (:func:`_finalise`), (4, C) in all; given ``eps``
    and ``running`` too, the running statistics updated from mean and
    var (:func:`update_running_reference`)."""
    dims = [d for d in range(x.dim()) if d != 1]
    xf = x.float()
    means = torch.stack([xf.mean(dims), xf.square().mean(dims)])
    if eps is None:
        return means
    out = torch.cat([means, torch.stack(_finalise(means[0], means[1], eps))])
    if running is not None:
        update_running_reference(running, out[0], out[2])
    return out


def bn_apply_reference(x: torch.Tensor, mean: torch.Tensor,
                       rstd: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(x − μ)·(γ·rstd) + β`` in ``dtype``, the fp32 factors cast to it
    (the JAX package's dtype staging): three torch ops, each rounding to
    ``dtype``."""
    shape = _stat_shape(x)
    mul = rstd * weight
    y = (x.to(dtype) - mean.reshape(shape).to(dtype)) \
        * mul.reshape(shape).to(dtype)
    return y + bias.reshape(shape).to(dtype)


def _running_in_kernel(running: Optional[Running], x: torch.Tensor) -> bool:
    """Whether the statistics kernel can update ``running`` itself: fp32
    vectors and an int64 count, contiguous, on x's device."""
    if running is None:
        return False
    mean, var, count = running.mean, running.var, running.count
    return (mean.dtype == var.dtype == torch.float32
            and count.dtype == torch.int64 and mean.is_contiguous()
            and var.is_contiguous() and mean.device == x.device
            and var.device == x.device and count.device == x.device)


def _launch_stats(x: torch.Tensor, eps: Optional[float],
                  running: Optional[Running]) -> torch.Tensor:
    (x2,), M, C = _as_rows("bn_forward_stats", x)
    plan = k4_plan(M, C, k4_vector_width(x2.dtype, C,
                                         x2.data_ptr() % 16 == 0))
    partial = _partial_buffer(x.device, plan.chunks * 2 * C)
    tickets = _ticket_buffer(x.device, plan.col_tiles) if plan.vec > 1 \
        else None
    out = torch.empty((2 if eps is None else 4, C), dtype=torch.float32,
                      device=x.device)
    # The running statistics' update rides on the finalisation, with
    # torch's scalars: the momentum and the Bessel factor rounded to fp32.
    fused = eps is not None and _running_in_kernel(running, x)
    m = running.momentum if fused else 0.0
    n = running.n if fused else 2
    launch(_STATS[plan.vec > 1], "virtex_bn_forward_stats", x,
           x2.data_ptr(), partial.data_ptr(),
           None if tickets is None else tickets.data_ptr(), out.data_ptr(),
           running.mean.data_ptr() if fused else None,
           running.var.data_ptr() if fused else None,
           running.count.data_ptr() if fused else None,
           M, C, plan.chunks, plan.vec, 0.0 if eps is None else eps,
           int(eps is not None), m, 1.0 - m, n / max(n - 1, 1),
           int(x2.dtype == torch.bfloat16))
    if eps is not None and running is not None and not fused:
        update_running_reference(running, out[0], out[2])
    return out


def _launch_apply(x, mean, rstd, weight, bias, dtype) -> torch.Tensor:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_apply computes in float32 or bfloat16, got "
                        f"{dtype}")
    (x2,), M, C = _as_rows("bn_apply", x)
    mean, rstd, weight, bias = (_f32(t) for t in (mean, rstd, weight, bias))
    wide = torch.float32 if torch.float32 in (x2.dtype, dtype) \
        else torch.bfloat16
    plan = k4_plan(M, C, k4_vector_width(wide, C, x2.data_ptr() % 16 == 0))
    y = _empty_rows(x, dtype)
    launch(_APPLY[plan.vec > 1], "virtex_bn_forward_apply", x,
           x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
           bias.data_ptr(), y.data_ptr(), M, C, plan.chunks, plan.vec,
           int(x2.dtype == torch.bfloat16), int(dtype == torch.bfloat16))
    return y


def _check_forward(name: str, x: torch.Tensor, *per_channel: torch.Tensor
                   ) -> None:
    if x.dim() < 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (N, C, ...)")
    C = x.shape[1]
    if any(t.shape != (C,) for t in per_channel):
        raise ValueError(f"{name}: mean, rstd, weight and bias must be "
                         f"({C},)")
    if len({t.device for t in (x,) + per_channel}) != 1:
        raise ValueError(f"{name}: operands on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")


def bn_forward_stats(x: torch.Tensor, eps: Optional[float] = None,
                     running: Optional[Running] = None) -> torch.Tensor:
    """fp32 statistics of x per channel over every dim but 1: the (2, C)
    means ``[E[x] ; E[x²]]``, and given ``eps`` var and rstd as two more
    rows; given ``eps`` and ``running`` too, the running statistics updated
    from them. The forward's statistics kernel on CUDA (which updates
    ``running`` in the same launch); the plain version on the CPU."""
    _check_forward("bn_forward_stats", x)
    if x.device.type == "cpu":
        return bn_forward_stats_reference(x, eps, running)
    return _launch_stats(x, eps, running)


def bn_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
             weight: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``(x − μ)·(γ·rstd) + β`` in ``dtype``, as :func:`bn_apply_reference`
    computes it. On CUDA, where no gradient is taken through it, one launch
    of the apply kernel, bit-equal to the torch ops; else those ops, which
    autograd differentiates (the "batch" sampler's path)."""
    _check_forward("bn_apply", x, mean, rstd, weight, bias)
    grad = torch.is_grad_enabled() and (
        x.requires_grad or mean.requires_grad or rstd.requires_grad
        or weight.requires_grad or bias.requires_grad)
    if x.device.type == "cpu" or grad:
        return bn_apply_reference(x, mean, rstd, weight, bias, dtype)
    return _launch_apply(x, mean, rstd, weight, bias, dtype)


StatsFn = Callable[..., torch.Tensor]
ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor, torch.dtype], torch.Tensor]


def bn_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype, group=None,
               running: Optional[Running] = None,
               stats_fn: StatsFn = bn_forward_stats,
               apply_fn: ApplyFn = bn_apply):
    """The exact train-mode forward: fp32 statistics (variance E[x²] −
    E[x]² clamped at 0) from ``stats_fn``, over the global batch of
    ``group`` when one is given, the running statistics updated, then
    ``apply_fn``. Returns y, mean, var, rstd."""
    if group is None:
        mean, _, var, rstd = stats_fn(x, eps, running).unbind()
    else:
        # Equal shards: each rank's means weigh 1/world (none at world 1,
        # whose bits stay the single-process ones).
        stats = stats_fn(x)
        world = world_of(group)
        if world > 1:
            stats.mul_(1.0 / world)
        mean, mean2 = all_reduce_sum(stats, "bn_stats", group)
        var, rstd = _finalise(mean, mean2, eps)
        if running is not None:
            update_running_reference(running, mean, var)
    return apply_fn(x, mean, rstd, weight, bias, dtype), mean, var, rstd


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype, running, fns):
        group = active_group()
        stats_fn, apply_fn, ctx.sums_fn, ctx.dx_fn = fns
        y, mean, var, rstd = bn_forward(x, weight, bias, eps, dtype, group,
                                        running, stats_fn, apply_fn)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        sums = ctx.sums_fn(dy, x, mean, rstd)
        if ctx.group is None:
            dx = ctx.dx_fn(dy, x, mean, rstd, weight, sums)
        else:
            # The JAX package's psum between the two stages, on the
            # current stream, so that stage 1's ticket buffer is never
            # shared with another stream's launch.
            total = all_reduce_sum(sums.clone(), "bn_sums", ctx.group)
            m = x.numel() // x.shape[1]
            dx = ctx.dx_fn(dy, x, mean, rstd, weight, total,
                           m_total=m * world_of(ctx.group))
        dbeta, dgamma = sums.unbind()
        if weight.dtype != torch.float32:
            dbeta, dgamma = dbeta.to(weight.dtype), dgamma.to(weight.dtype)
        return dx, dgamma, dbeta, None, None, None, None


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, dtype: torch.dtype,
             sums_fn: SumsFn = bn_backward_sums,
             dx_fn: DxFn = bn_backward_dx,
             running: Optional[Running] = None,
             stats_fn: StatsFn = bn_forward_stats,
             apply_fn: ApplyFn = bn_apply):
    """Train-mode BatchNorm over every dim but 1 → ``(y, mean, var)``, with
    ``running`` (if given) updated in place. ``mean`` and ``var`` (fp32, not
    differentiable) are the batch's statistics. The forward takes them
    from ``stats_fn`` and y from ``apply_fn``; the backward takes its
    channel sums from ``sums_fn`` and dx from ``dx_fn`` (given ``m_total``
    under data parallelism). A comparison swaps in the plain versions."""
    return _BNTrain.apply(x, weight, bias, eps, dtype, running,
                          (stats_fn, apply_fn, sums_fn, dx_fn))
