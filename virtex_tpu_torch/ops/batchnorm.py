r"""
Train-mode BatchNorm with a hand-written backward: kernel K4 (two stages)
and its plain versions.

Counterpart of ``virtex_tpu/ops/batchnorm.py``. :func:`bn_train` is a
:class:`torch.autograd.Function` whose forward is the math of
``SubsampledBatchNorm`` at ``stat_stride = 1`` (statistics in fp32, the
output computed in ``dtype``) and whose backward is the analytic BN
gradient ``dx = γ·rstd·(dy − dβ/M − x̂·dγ/M)`` in two launches: the channel
sums (dβ, dγ) = (Σ dy, Σ dy·x̂) from :func:`bn_backward_sums` (stage 1),
then dx from :func:`bn_backward_dx` (stage 2), which on the TPU is the jnp
stage that XLA fuses into one pass. The mean and variance it returns feed
the running statistics, which are updated under ``no_grad``, so their
cotangents are zero.

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
:func:`k4_vector_width`; :func:`k4_plan` sizes the grid. Counters:
:data:`launch_count` and :data:`vector_launch_count` (stage 1),
:data:`dx_launch_count` and :data:`dx_vector_launch_count` (stage 2), and
:data:`dy_copy_count`, the stage-1 launches whose dy had to be copied to
rows first.

Layout: channels on dim 1, as torch's ``BatchNorm2d`` has them; the
ResNet's activations are ``channels_last`` (NHWC memory), which K4 reads as
row-major (M, C). A tensor in another memory format is copied to that
layout first, explicitly, never read in the wrong one. dx comes back as an
NCHW view of NHWC memory.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

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

launch_count = 0            # stage-1 launches since import or the last reset
vector_launch_count = 0     # of those, the vector variant's
dx_launch_count = 0         # stage-2 (dx) launches
dx_vector_launch_count = 0  # of those, the vector variant's
dy_copy_count = 0           # stage-1 launches whose dy was copied to rows

SumsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]
DxFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor], torch.Tensor]


def reset_launch_count() -> None:
    global launch_count, vector_launch_count, dx_launch_count
    global dx_vector_launch_count, dy_copy_count
    launch_count = vector_launch_count = dy_copy_count = 0
    dx_launch_count = dx_vector_launch_count = 0


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
    """Whether ``t`` (N, C, *S) is already row-major (M, C) memory."""
    return t.movedim(1, -1).is_contiguous()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) → row-major (M, C): a view of channels_last memory, a
    copy of any other layout."""
    return t.movedim(1, -1).reshape(-1, t.shape[1]).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


# Stage 1's ticket counters, one per column tile, zeroed once per device;
# the kernel leaves them zeroed.
_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def _operands(dy: torch.Tensor, x: torch.Tensor):
    """dy and x as row-major (M, C), and the plan of both stages."""
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
    wide = torch.float32 if torch.float32 in (dy2.dtype, x2.dtype) \
        else torch.bfloat16
    aligned = dy2.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0
    return dy2, x2, k4_plan(M, C, k4_vector_width(wide, C, aligned))


def _launch(dy, x, mean, rstd) -> torch.Tensor:
    global launch_count, vector_launch_count, dy_copy_count
    from virtex_tpu_torch.ops import _build

    dy_copied = not _is_rows(dy)
    dy2, x2, plan = _operands(dy, x)
    M, C = x2.shape
    mean, rstd = _f32(mean), _f32(rstd)
    partial = torch.empty((plan.chunks, 2, C), dtype=torch.float32,
                          device=x.device)
    tickets = _ticket_buffer(x.device, plan.col_tiles) if plan.vec > 1 \
        else None
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.virtex_bn_backward_sums(
            dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), out.data_ptr(),
            M, C, plan.chunks, plan.vec, int(dy2.dtype == torch.bfloat16),
            int(x2.dtype == torch.bfloat16), stream)
    _build.check(err, "K4 bn_backward_sums launch")
    launch_count += 1
    vector_launch_count += int(plan.vec > 1)
    dy_copy_count += int(dy_copied)
    return out


def _launch_dx(dy, x, mean, rstd, weight, sums, m_total) -> torch.Tensor:
    global dx_launch_count, dx_vector_launch_count
    from virtex_tpu_torch.ops import _build

    dy2, x2, plan = _operands(dy, x)
    M, C = x2.shape
    mean, rstd, weight, sums = (_f32(t) for t in (mean, rstd, weight, sums))
    dx = torch.empty((M, C), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.virtex_bn_backward_dx(
            dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), sums.data_ptr(), dx.data_ptr(), M, C,
            _count(x, m_total), plan.chunks, plan.vec,
            int(dy2.dtype == torch.bfloat16),
            int(x2.dtype == torch.bfloat16), stream)
    _build.check(err, "K4 bn_backward_dx launch")
    dx_launch_count += 1
    dx_vector_launch_count += int(plan.vec > 1)
    return dx.view(x.shape[0], *x.shape[2:], C).movedim(-1, 1)


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
               eps: float, dtype: torch.dtype, group=None):
    """The exact train-mode forward: fp32 statistics (variance E[x²] −
    E[x]² clamped at 0), over the global batch of ``group`` when one is
    given, then :func:`bn_apply`. Returns y, mean, var, rstd."""
    dims = [d for d in range(x.dim()) if d != 1]
    xf = x.float()
    mean, mean2 = xf.mean(dims), xf.square().mean(dims)
    if group is not None:
        # Equal shards: each rank's means weigh 1/world (none at world 1,
        # whose bits stay the single-process ones).
        stats = torch.stack([mean, mean2])
        world = world_of(group)
        if world > 1:
            stats.mul_(1.0 / world)
        mean, mean2 = all_reduce_sum(stats, "bn_stats", group)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    return bn_apply(x, mean, rstd, weight, bias, dtype), mean, var, rstd


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype, sums_fn, dx_fn):
        group = active_group()
        y, mean, var, rstd = bn_forward(x, weight, bias, eps, dtype, group)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.sums_fn, ctx.dx_fn, ctx.group = sums_fn, dx_fn, group
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
        return (dx, sums[1].to(weight.dtype), sums[0].to(weight.dtype),
                None, None, None, None)


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, dtype: torch.dtype,
             sums_fn: SumsFn = bn_backward_sums,
             dx_fn: DxFn = bn_backward_dx):
    """Train-mode BatchNorm over every dim but 1 → ``(y, mean, var)``.
    ``mean`` and ``var`` (fp32, not differentiable) are for the running
    statistics; the backward takes its channel sums from ``sums_fn`` and
    dx from ``dx_fn`` (given ``m_total`` under data parallelism)."""
    return _BNTrain.apply(x, weight, bias, eps, dtype, sums_fn, dx_fn)
