"""The port's train-mode BatchNorm op (virtex_tpu_torch.ops.batchnorm:
``bn_train`` with kernel K4's two stages and their plain versions) against
the JAX package's ``virtex_tpu.ops.batchnorm``, on the same numpy inputs.

On the CPU: ``bn_train``'s output, statistics and dx, dγ, dβ against the
JAX ``bn_train`` with its Pallas reduction in interpret mode, at the JAX
op's four test shapes (M = 98 included, where the JAX side falls back to
jnp), in float32 and bfloat16; ``bn_backward_sums_reference`` against the
JAX ``bn_backward_sums(interpret=True)``, and ``bn_backward_dx_reference``
against the dx of ``jax.vjp`` of the JAX ``bn_train``. Every comparison is
the per-element error |a − b| / (|ref| + atol) with its bound stated. The
variant rule (``k4_vector_width``) and the grid planner (``k4_plan``) are
pure functions, checked at ResNet-50's 12 BatchNorm shapes and the edges.

Cases marked ``cuda`` hold both stages against their plain versions on the
card, in both variants and all four dtype pairs (an NCHW-contiguous dy, an
odd M, unaligned views, and equal bits from two launches); they skip
elsewhere (a CUDA kernel has no CPU mode).
"""
import math

import numpy as np
import pytest
import torch

from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import batchnorm as BN

EPS = 1e-5
SHAPES = [(4, 8, 8, 256), (4, 8, 8, 64), (2, 7, 7, 2048), (16, 4, 4, 128)]
DTYPES = ["float32", "bfloat16"]
# Every distinct (H, C) of ResNet-50's BatchNorm layers at 224²; the train
# step runs them at batch 128.
R50_SHAPES = [(112, 64), (56, 64), (56, 256), (56, 128), (28, 128),
              (28, 512), (28, 256), (14, 256), (14, 1024), (14, 512),
              (7, 512), (7, 2048)]


def rel_err(a, ref, atol):
    a, ref = (x.detach().double().cpu().numpy() if torch.is_tensor(x)
              else np.asarray(x, np.float64) for x in (a, ref))
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + atol)))


def _inputs(shape, seed):
    """NHWC x ~ 2·N(0, 1) + 0.5, scale in [0.5, 1.5), bias, and the weight w
    of the loss Σ y·w (tests/test_batchnorm_op.py)."""
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.rand(C) + 0.5).astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, w


def _nchw(a, dtype=torch.float32):
    """NHWC numpy → the port's layout: an NCHW view of NHWC memory."""
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)


def _jax_bn(x, scale, bias, w, dtype):
    import jax
    import jax.numpy as jnp
    from virtex_tpu.ops.batchnorm import bn_train as jax_bn_train
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x, jdt)

    def loss(x, s, b):
        y, _, _ = jax_bn_train(x, s, b, EPS, jdt, True)
        return jnp.sum(y.astype(jnp.float32) * w)

    y, mean, var = jax_bn_train(xj, scale, bias, EPS, jdt, True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(scale),
                                              jnp.asarray(bias))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return f32(y), f32(mean), f32(var), [f32(g) for g in grads]


def _port_bn(x, scale, bias, w, dtype):
    tdt = getattr(torch, dtype)
    xt = _nchw(x, tdt).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    y, mean, var = BN.bn_train(xt, st, bt, EPS, tdt)
    assert y.dtype == tdt and not mean.requires_grad
    (y.float() * _nchw(w)).sum().backward()
    assert xt.grad.dtype == tdt
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1)  # noqa: E731
    return (nhwc(y), mean, var, [nhwc(xt.grad), st.grad, bt.grad])


# fp32: the two sides reduce over M in other orders; measured <= 1e-6 of
# each quantity's scale. bf16: x and y are rounded to 8 bits on both sides,
# so one rounding apart is 2^-8 relative; dx comes out in bf16.
TOL = {"float32": 1e-4, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_train_matches_jax_op(shape, dtype, interpret_mode):
    x, scale, bias, w = _inputs(shape, 0)
    ref = _jax_bn(x, scale, bias, w, dtype)
    ours = _port_bn(x, scale, bias, w, dtype)
    tol = TOL[dtype]
    # y, mean and var are O(1); dx is γ·rstd·O(1) ~ 0.5; dγ and dβ are sums
    # over M of O(1) terms, scale sqrt(M).
    M = math.prod(shape[:-1])
    names = ("y", "mean", "var")
    for name, a, r in zip(names, ours[:3], ref[:3]):
        assert rel_err(a, r, 1.0) <= tol, name
    for name, a, r, atol in zip(("dx", "dscale", "dbias"), ours[3], ref[3],
                                (1.0, math.sqrt(M), math.sqrt(M))):
        assert rel_err(a, r, atol) <= tol, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] * s[1] * s[2]
                                   != 98])
def test_sums_reference_matches_jax_kernel(shape, dtype):
    import jax.numpy as jnp
    from virtex_tpu.ops.batchnorm import bn_backward_sums as jax_sums
    x, _, _, dy = _inputs(shape, 1)
    rng = np.random.RandomState(2)
    C = shape[-1]
    mean = (0.5 + 0.1 * rng.randn(C)).astype(np.float32)
    rstd = rng.uniform(0.3, 0.7, C).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = jax_sums(jnp.asarray(dy, jdt), jnp.asarray(x, jdt), mean, rstd,
                   interpret=True)
    assert ref is not None  # the JAX kernel tiles this shape
    tdt = getattr(torch, dtype)
    ours = BN.bn_backward_sums_reference(_nchw(dy, tdt), _nchw(x, tdt),
                                         torch.from_numpy(mean),
                                         torch.from_numpy(rstd))
    assert ours.shape == (2, C) and ours.dtype == torch.float32
    M = math.prod(shape[:-1])
    # fp32 sums of M terms of scale 1 in other orders (measured ~1e-7 of
    # sqrt(M)); bf16 inputs are read exactly on both sides.
    assert rel_err(ours, np.stack([np.asarray(r) for r in ref]),
                   math.sqrt(M)) <= 1e-5


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x, _, _, dy = _inputs((2, 3, 3, 8), 3)
    mean, rstd = torch.zeros(8), torch.ones(8)
    before = L.snapshot()
    out = BN.bn_backward_sums(_nchw(dy), _nchw(x), mean, rstd)
    assert L.snapshot() == before
    assert torch.equal(out, BN.bn_backward_sums_reference(
        _nchw(dy), _nchw(x), mean, rstd))
    with pytest.raises(ValueError, match="one"):
        BN.bn_backward_sums(_nchw(dy)[:1], _nchw(x), mean, rstd)


def _jax_dx(x, scale, bias, dy, dtype):
    """dx of the JAX ``bn_train`` through ``jax.vjp``, with zero cotangents
    for the returned mean and var (as the port's running-stat update)."""
    import jax
    import jax.numpy as jnp
    from virtex_tpu.ops.batchnorm import bn_train as jax_bn_train
    jdt = getattr(jnp, dtype)
    (_, mean, var), vjp = jax.vjp(
        lambda a: jax_bn_train(a, jnp.asarray(scale), jnp.asarray(bias), EPS,
                               jdt, True), jnp.asarray(x, jdt))
    (dx,) = vjp((jnp.asarray(dy, jdt), jnp.zeros_like(mean),
                 jnp.zeros_like(var)))
    return np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_dx_reference_matches_jax_vjp(shape, dtype, interpret_mode):
    """K4 stage 2's plain version, fed the port's statistics and plain
    sums, against the JAX op's dx; per element |a − b| / (|ref| + 1) (dx is
    γ·rstd·O(1)): fp32 1e-4 (sums and statistics in other orders), bf16
    2^-7 (both round dx once to bf16; one rounding apart is 2^-8)."""
    x, scale, bias, dy = _inputs(shape, 8)
    ref = _jax_dx(x, scale, bias, dy, dtype)
    tdt = getattr(torch, dtype)
    xt, dyt = _nchw(x, tdt), _nchw(dy, tdt)
    st = torch.from_numpy(scale)
    _, mean, _, rstd = BN.bn_forward(xt, st, torch.from_numpy(bias), EPS, tdt)
    sums = BN.bn_backward_sums_reference(dyt, xt, mean, rstd)
    dx = BN.bn_backward_dx_reference(dyt, xt, mean, rstd, st, sums)
    assert dx.dtype == tdt and dx.shape == xt.shape
    assert rel_err(dx.float().permute(0, 2, 3, 1), ref, 1.0) <= TOL[dtype]


def _check_plan(plan, M, C):
    """What both stages' kernels assume of a plan (csrc/bn_backward_sums.cu):
    the block's threads cover its tile, the tiles cover C, the chunks cover
    M with none empty, and the kernels' own ceil(M / chunks) is
    rows_per_chunk."""
    assert plan.tile_cols * plan.row_lanes <= BN._THREADS
    assert plan.tile_cols * (plan.row_lanes + 1) > BN._THREADS
    width = plan.tile_cols * plan.vec
    assert (plan.col_tiles - 1) * width < C <= plan.col_tiles * width
    assert 1 <= plan.chunks <= 65535
    assert (plan.chunks - 1) * plan.rows_per_chunk < M
    assert M <= plan.chunks * plan.rows_per_chunk
    assert math.ceil(M / plan.chunks) == plan.rows_per_chunk


@pytest.mark.parametrize("hw,C", R50_SHAPES)
def test_vector_width_and_plan_at_resnet50_shapes(hw, C):
    """The train step's bf16 operands take the 8-wide vector variant (fp32
    the 4-wide one) in one wave of blocks, with no column tile wider than
    8 vectors; small C takes more rows per block, not more tiles."""
    M = 128 * hw * hw
    for dtype, vec in ((torch.bfloat16, 8), (torch.float32, 4)):
        assert BN.k4_vector_width(dtype, C, True) == vec
        assert BN.k4_vector_width(dtype, C, False) == 1
        plan = BN.k4_plan(M, C, vec)
        _check_plan(plan, M, C)
        assert plan.vec == vec and plan.tile_cols == BN._TILE_COLS
        assert plan.col_tiles == C // (vec * BN._TILE_COLS)
        assert plan.col_tiles * plan.chunks <= BN._VECTOR_BLOCKS
        assert plan.chunks <= math.ceil(
            M / (plan.row_lanes * BN._MIN_ROWS_PER_LANE))
    _check_plan(BN.k4_plan(M, C, 1), M, C)
    if C == 64:  # a warp reads four whole bf16 rows per load
        assert BN.k4_plan(M, C, 8).row_lanes == 32


def test_vector_width_and_plan_at_the_edges():
    # C 60: not a multiple of 8 bf16 channels, a multiple of 4 fp32 ones
    assert BN.k4_vector_width(torch.bfloat16, 60, True) == 1
    assert BN.k4_vector_width(torch.float32, 60, True) == 4
    for M in (147, 1, 100_003):
        for C, vec in ((60, 1), (60, 4), (8, 8), (24, 8), (8, 1), (3, 1)):
            _check_plan(BN.k4_plan(M, C, vec), M, C)
    # C 8: one vector column per block, 256 row lanes
    plan = BN.k4_plan(147, 8, 8)
    assert (plan.tile_cols, plan.row_lanes, plan.col_tiles) == (1, 256, 1)
    # C 24: three vector columns, 85 row lanes (one thread idle)
    assert BN.k4_plan(10_000, 24, 8).row_lanes == 85
    # a ragged last column tile: 320 channels are 40 vectors, 5 tiles of 8
    assert BN.k4_plan(10_000, 320, 8).col_tiles == 5
    assert BN.k4_plan(10_000, 328, 8).col_tiles == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operands_take_the_scalar_variant_for_an_unaligned_view(dtype):
    """dy and x as NCHW views of NHWC memory one element into a buffer:
    their base pointers are not 16-byte aligned, so K4 would read them
    with the scalar variants; an aligned pair takes the vector ones."""
    x, _, _, dy = _inputs((3, 7, 7, 64), 9)
    aligned = [_nchw(a, dtype) for a in (dy, x)]
    unaligned = [_offset_view(a, dtype) for a in (dy, x)]
    assert all(BN._is_rows(t) for t in unaligned)
    assert BN._operands(*aligned)[2].vec == 16 // dtype.itemsize
    dy2, x2, plan = BN._operands(*unaligned)
    assert plan.vec == 1 and dy2.data_ptr() % 16 != 0
    mixed = BN._operands(aligned[0].to(torch.bfloat16), aligned[1].float())
    assert mixed[2].vec == 4


def test_cpu_tensor_takes_plain_dx_and_counts_no_launch():
    x, scale, _, dy = _inputs((2, 3, 3, 8), 3)
    mean, rstd = torch.full((8,), 0.5), torch.full((8,), 0.7)
    w = torch.from_numpy(scale)
    sums = BN.bn_backward_sums_reference(_nchw(dy), _nchw(x), mean, rstd)
    before = L.snapshot()
    out = BN.bn_backward_dx(_nchw(dy), _nchw(x), mean, rstd, w, sums)
    assert L.snapshot() == before
    assert torch.equal(out, BN.bn_backward_dx_reference(
        _nchw(dy), _nchw(x), mean, rstd, w, sums))
    with pytest.raises(ValueError, match="sums"):
        BN.bn_backward_dx(_nchw(dy), _nchw(x), mean, rstd, w, sums[:1])
    with pytest.raises(ValueError, match="weight"):
        BN.bn_backward_dx(_nchw(dy), _nchw(x), mean, rstd, w[:4], sums)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_stats_reference_matches_jax_op(shape, dtype,
                                                interpret_mode):
    """The forward's plain statistics against the JAX ``bn_train``'s mean
    and var, per element |a − b| / (|ref| + 1) (O(1) quantities): fp32
    means of the same inputs in other orders, measured ~1e-7, bound 1e-5
    in both dtypes (bf16 x is read exactly on both sides). E[x²] is held to
    var + mean² and rstd to 1 / sqrt(var + ε) of the JAX side."""
    import jax.numpy as jnp
    from virtex_tpu.ops.batchnorm import bn_train as jax_bn_train
    x, scale, bias, _ = _inputs(shape, 14)
    jdt = getattr(jnp, dtype)
    _, jmean, jvar = jax_bn_train(jnp.asarray(x, jdt), jnp.asarray(scale),
                                  jnp.asarray(bias), EPS, jdt, True)
    jmean, jvar = (np.asarray(a, np.float64) for a in (jmean, jvar))
    stats = BN.bn_forward_stats_reference(_nchw(x, getattr(torch, dtype)),
                                          EPS)
    assert stats.shape == (4, shape[-1]) and stats.dtype == torch.float32
    for name, a, r in zip(("mean", "mean2", "var", "rstd"), stats,
                          (jmean, jvar + jmean ** 2, jvar,
                           1.0 / np.sqrt(jvar + EPS))):
        assert rel_err(a, r, 1.0) <= 1e-5, name
    means = BN.bn_forward_stats_reference(_nchw(x, getattr(torch, dtype)))
    assert torch.equal(means, stats[:2])


def test_cpu_tensor_takes_plain_forward_and_counts_no_launch():
    """On the CPU the statistics, the apply and a SubsampledBatchNorm in
    both modes run the plain versions and count no forward launch."""
    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    x, scale, bias, _ = _inputs((2, 3, 3, 8), 15)
    xt = _nchw(x, torch.bfloat16)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    before = L.snapshot()
    stats = BN.bn_forward_stats(xt, EPS)
    assert torch.equal(stats, BN.bn_forward_stats_reference(xt, EPS))
    assert torch.equal(BN.bn_forward_stats(xt), stats[:2])
    mean, _, _, rstd = stats
    y = BN.bn_apply(xt, mean, rstd, w, b, torch.bfloat16)
    assert torch.equal(y, BN.bn_apply_reference(xt, mean, rstd, w, b,
                                                torch.bfloat16))
    bn = SubsampledBatchNorm(8, dtype=torch.bfloat16)
    bn(xt)
    with torch.no_grad():
        bn.eval()(xt)
    assert L.snapshot() == before
    with pytest.raises(ValueError, match="bias"):
        BN.bn_apply(xt, mean, rstd, w, b[:4], torch.bfloat16)


def test_bn_apply_with_grad_needed_differentiates():
    """The "batch" sampler (``stat_stride`` > 1) differentiates through
    ``bn_apply`` with plain autograd: with gradients on and an operand
    that needs one, bn_apply is the torch ops, on the graph; x's, γ's and
    β's gradients equal those of ``bn_apply_reference`` bit for bit, and
    the sampler's layer backpropagates into x and both parameters."""
    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    x, scale, bias, w = _inputs((16, 3, 3, 8), 16)
    grads = []
    for fn in (BN.bn_apply, BN.bn_apply_reference):
        xt = _nchw(x).requires_grad_()
        st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
        mean, rstd = xt.mean((0, 2, 3)), xt.var((0, 2, 3)).add(EPS).rsqrt()
        y = fn(xt, mean, rstd, st, bt, torch.float32)
        assert y.grad_fn is not None
        (y * _nchw(w)).sum().backward()
        grads.append([xt.grad, st.grad, bt.grad])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    bn = SubsampledBatchNorm(8, stat_stride=4).train()
    xt = _nchw(x).requires_grad_()
    (bn(xt) * _nchw(w)).sum().backward()
    assert all(g is not None and torch.isfinite(g).all()
               for g in (xt.grad, bn.weight.grad, bn.bias.grad))


def _layouts():
    """(N, C, *S) tensors in several memory layouts: channels_last and
    NCHW, size-1 spatial dims, (N, C) and (N, C, L), a channel slice."""
    base = torch.arange(2 * 6 * 3 * 4, dtype=torch.float32)
    nhwc = base.view(2, 3, 4, 6).permute(0, 3, 1, 2)
    return {"channels_last": nhwc, "nchw": nhwc.contiguous(),
            "hw1": torch.zeros(2, 1, 1, 6).permute(0, 3, 1, 2),
            "nc": torch.zeros(5, 6),
            "ncl": torch.zeros(2, 7, 6).transpose(1, 2),
            "ncl_contiguous": torch.zeros(2, 6, 7),
            "channel_slice": nhwc[:, :3]}


@pytest.mark.parametrize("layout", list(_layouts()))
def test_kernels_read_rows_in_place_and_copy_other_layouts(layout):
    """The kernels' operands (``_as_rows``): a tensor whose memory is
    row-major (M, C) (``_is_rows``, a stride test with no tensor op: the
    layouts ``movedim(1, -1)`` leaves contiguous) is read in place, any
    other is copied to rows; either way the memory is x's (M, C) rows."""
    t = _layouts()[layout]
    rows = t.movedim(1, -1).is_contiguous()
    assert BN._is_rows(t) == rows
    (x2,), M, C = BN._as_rows("test", t)
    assert (x2 is t) == rows
    assert (M, C) == (t.numel() // t.shape[1], t.shape[1])
    expect = t.movedim(1, -1).reshape(M, C)
    got = torch.as_strided(x2, (M, C), (C, 1)) if rows else x2
    assert torch.equal(got, expect)
    y = BN._empty_rows(t, torch.bfloat16)
    assert y.shape == t.shape and y.dtype == torch.bfloat16
    assert BN._is_rows(y)


def test_running_statistics_swap_and_update_by_name():
    """A SubsampledBatchNorm in training calls ``stats_fn`` with its
    running statistics and ``apply_fn`` once each (a plain copy swaps them
    by name); in eval mode ``apply_fn`` alone. The plain statistics update
    the running statistics as the torch formula does, bit for bit:
    ``m·old + (1 − m)·μ`` and ``m·old + (1 − m)·σ²·n/(n − 1)``, the count
    by one."""
    import copy

    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    bn = SubsampledBatchNorm(8, dtype=torch.bfloat16).train()
    assert bn.stats_fn is BN.bn_forward_stats
    assert bn.apply_fn is BN.bn_apply
    twin = copy.deepcopy(bn)
    calls = []

    def stats_fn(x, eps=None, running=None):
        calls.append(("stats", running.n))
        return BN.bn_forward_stats_reference(x, eps, running)

    def apply_fn(*args):
        calls.append(("apply",))
        return BN.bn_apply_reference(*args)

    twin.stats_fn, twin.apply_fn = stats_fn, apply_fn
    x, _, _, _ = _inputs((2, 5, 5, 8), 25)
    xt = _nchw(x, torch.bfloat16)
    with torch.no_grad():
        for module in (bn, twin):
            module.running_mean.uniform_(-1.0, 1.0, generator=torch.Generator(
                ).manual_seed(1))
            module.running_var.uniform_(0.5, 2.0, generator=torch.Generator(
                ).manual_seed(2))
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    assert torch.equal(bn(xt), twin(xt))
    assert calls == [("stats", 50), ("apply",)]
    stats = BN.bn_forward_stats_reference(xt, EPS)
    m = bn.momentum
    want_mean = m * old_mean + (1.0 - m) * stats[0]
    want_var = m * old_var + (1.0 - m) * stats[2] * (50 / 49)
    for module in (bn, twin):
        assert torch.equal(module.running_mean, want_mean)
        assert torch.equal(module.running_var, want_var)
        assert int(module.num_batches_tracked) == 1
    with torch.no_grad():
        assert torch.equal(bn.eval()(xt), twin.eval()(xt))
    assert calls[2:] == [("apply",)]


def test_build_table_names_both_forward_entry_points():
    """ctypes passes every argument as the table says: the forward's two
    entry points are there, with one argtype per C parameter
    (``csrc/bn_forward.cu``) and an int return (the CUDA error)."""
    import ctypes

    from virtex_tpu_torch.ops import _build
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    assert _build.SIGNATURES["virtex_bn_forward_stats"] == (
        I, [P, P, P, P, P, P, P, LL, I, I, I, F, I, F, F, F, I, P])
    assert _build.SIGNATURES["virtex_bn_forward_apply"] == (
        I, [P, P, P, P, P, P, LL, I, I, I, I, I, P])
    source = (_build.CSRC / "bn_forward.cu").read_text()
    for name in ("virtex_bn_forward_stats", "virtex_bn_forward_apply"):
        assert f"int {name}(" in source


def test_subsampled_batchnorm_swaps_both_backward_stages_by_name():
    """chip_smoke.py's plain copy sets ``sums_fn`` and ``dx_fn`` on every
    SubsampledBatchNorm: the backward then calls each once, in order, and
    (on the CPU, where the defaults are the plain versions) gives the same
    bits."""
    import copy

    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    bn = SubsampledBatchNorm(8, dtype=torch.bfloat16).train()
    assert bn.sums_fn is BN.bn_backward_sums
    assert bn.dx_fn is BN.bn_backward_dx
    twin = copy.deepcopy(bn)
    calls = []

    def sums_fn(*args):
        calls.append("sums")
        return BN.bn_backward_sums_reference(*args)

    def dx_fn(*args):
        calls.append("dx")
        return BN.bn_backward_dx_reference(*args)

    twin.sums_fn, twin.dx_fn = sums_fn, dx_fn
    x, _, _, w = _inputs((2, 5, 5, 8), 10)
    grads = []
    for module in (bn, twin):
        xt = _nchw(x, torch.bfloat16).requires_grad_()
        (module(xt).float() * _nchw(w)).sum().backward()
        grads.append([xt.grad, module.weight.grad, module.bias.grad])
    assert calls == ["sums", "dx"]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _offset_view(a, dtype, device="cpu"):
    """NHWC numpy → an NCHW view of NHWC memory that starts one element
    into its buffer, so its base pointer is not 16-byte aligned."""
    flat = torch.empty(a.size + 1, dtype=dtype, device=device)
    flat[1:] = torch.from_numpy(a).reshape(-1).to(device, dtype)
    return flat[1:].view(a.shape).permute(0, 3, 1, 2)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (CPU), as
    tests/test_batchnorm_op.py does."""
    import functools
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- kernel K4 on the card ---------------------------------------------------
# Run there with: python -m pytest tests/test_torch_batchnorm.py -m cuda
# --noconftest. Stage 1 and its plain version both read the inputs exactly
# and sum in fp32 in other orders: per element |a − b| / (|ref| + sqrt(M))
# with sqrt(M) the scale of a sum of M terms of scale 1. Stage 2 and its
# plain version compute dx in fp32 from the same sums and round once to x's
# dtype: per element |a − b| / (|ref| + 1), 1e-5 in fp32 (other
# association of the same terms), 2^-7 in bf16 (one rounding apart is
# 2^-8).
CARD_TOL = 1e-5
DX_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
DTYPE_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 is a CUDA kernel with no CPU "
                    "mode")
    return torch.device("cuda")


def _card_sums(shape, dtype, device, seed, dy_layout="channels_last",
               x_dtype=None, aligned=True):
    """dy (``dtype``) and x (``x_dtype``, default ``dtype``) as NCHW views
    of NHWC memory (dy NCHW-contiguous if asked; both one element into
    their buffers unless ``aligned``), and fp32 mean and rstd."""
    x, _, _, dy = _inputs(shape, seed)
    rng = np.random.RandomState(seed + 1)
    C = shape[-1]
    mean = torch.from_numpy((0.5 + 0.1 * rng.randn(C)).astype(
        np.float32)).to(device)
    rstd = torch.from_numpy(rng.uniform(0.3, 0.7, C).astype(
        np.float32)).to(device)
    x_dtype = x_dtype or dtype
    if aligned:
        xt = _nchw(x, x_dtype).to(device)
        dyt = _nchw(dy, dtype).to(device)
    else:
        xt = _offset_view(x, x_dtype, device)
        dyt = _offset_view(dy, dtype, device)
    if dy_layout == "nchw":
        dyt = dyt.contiguous()
        assert not dyt.is_contiguous(memory_format=torch.channels_last)
    return dyt, xt, mean, rstd


def _weight(C, device, seed):
    rng = np.random.RandomState(seed + 2)
    return torch.from_numpy((rng.rand(C) + 0.5).astype(np.float32)).to(device)


def _launched(before, kernel):
    """(launches of ``kernel`` since the snapshot ``before``, of them in the
    vector variant)."""
    ran = L.snapshot() - before
    return (ran[(kernel, "vector")] + ran[(kernel, "scalar")],
            ran[(kernel, "vector")])


def _k4(dy, x, mean, rstd, vector=None):
    """Stage 1, checked to launch once (in the vector variant if asked)."""
    before = L.snapshot()
    out = BN.bn_backward_sums(dy, x, mean, rstd)
    torch.cuda.synchronize()
    n, vec = _launched(before, "k4_sums")
    assert n == 1 and (vector is None or vec == int(vector))
    return out


def _k4_dx(dy, x, mean, rstd, weight, sums, vector=None):
    """Stage 2, checked likewise."""
    before = L.snapshot()
    out = BN.bn_backward_dx(dy, x, mean, rstd, weight, sums)
    torch.cuda.synchronize()
    n, vec = _launched(before, "k4_dx")
    assert n == 1 and (vector is None or vec == int(vector))
    assert out.shape == x.shape and out.dtype == x.dtype
    return out


def _check_both_stages(dy, x, mean, rstd, weight, vector):
    """Both stages against their plain versions, each launched twice for
    equal bits; stage 2 is fed the plain sums, as its plain version is."""
    M = x.numel() // x.shape[1]
    sums = _k4(dy, x, mean, rstd, vector)
    assert torch.equal(sums, _k4(dy, x, mean, rstd, vector))
    ref = BN.bn_backward_sums_reference(dy, x, mean, rstd)
    assert sums.shape == ref.shape == (2, x.shape[1])
    assert rel_err(sums, ref, math.sqrt(M)) <= CARD_TOL
    dx = _k4_dx(dy, x, mean, rstd, weight, ref, vector)
    assert torch.equal(dx, _k4_dx(dy, x, mean, rstd, weight, ref, vector))
    dx_ref = BN.bn_backward_dx_reference(dy, x, mean, rstd, weight, ref)
    assert rel_err(dx, dx_ref, 1.0) <= DX_TOL[x.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + [(3, 7, 7, 64)])  # odd M = 147
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    dy, x, mean, rstd = _card_sums(shape, dtype, cuda, 4)
    out = _k4(dy, x, mean, rstd, vector=True)
    ref = BN.bn_backward_sums_reference(dy, x, mean, rstd)
    M = math.prod(shape[:-1])
    assert out.shape == ref.shape == (2, shape[-1])
    assert rel_err(out, ref, math.sqrt(M)) <= CARD_TOL
    _check_both_stages(dy, x, mean, rstd, _weight(shape[-1], cuda, 4), True)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vector", "scalar"])
@pytest.mark.parametrize("hw,C", R50_SHAPES)
def test_both_stages_at_resnet50_shapes_on_card(cuda, hw, C, variant):
    """bf16, batch 8; the scalar variant through views one element into
    their buffers."""
    vector = variant == "vector"
    dy, x, mean, rstd = _card_sums((8, hw, hw, C), torch.bfloat16, cuda,
                                   11, aligned=vector)
    _check_both_stages(dy, x, mean, rstd, _weight(C, cuda, 11), vector)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vector", "scalar"])
@pytest.mark.parametrize("dy_dtype,x_dtype", DTYPE_PAIRS)
def test_every_dtype_instantiation_on_card(cuda, dy_dtype, x_dtype,
                                           variant):
    """All four (dy, x) dtype pairs of both stages, at an odd M."""
    vector = variant == "vector"
    dy, x, mean, rstd = _card_sums((3, 7, 7, 64), dy_dtype, cuda, 12,
                                   x_dtype=x_dtype, aligned=vector)
    _check_both_stages(dy, x, mean, rstd, _weight(64, cuda, 12), vector)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_variant_for_c_not_a_multiple_of_8_on_card(cuda, dtype):
    """C 60 (3·7·7 × 60): bf16 takes the scalar variants, fp32 the 4-wide
    vector ones."""
    dy, x, mean, rstd = _card_sums((3, 7, 7, 60), dtype, cuda, 13)
    _check_both_stages(dy, x, mean, rstd, _weight(60, cuda, 13),
                       dtype == torch.float32)


@pytest.mark.cuda
def test_kernel_reads_an_nchw_contiguous_dy_on_card(cuda):
    dy, x, mean, rstd = _card_sums((4, 8, 8, 64), torch.bfloat16, cuda, 5,
                                   dy_layout="nchw")
    before = L.snapshot()
    out = _k4(dy, x, mean, rstd)
    assert (L.snapshot() - before)[("k4_dy", "copy")] == 1
    cl = dy.contiguous(memory_format=torch.channels_last)
    same = _k4(cl, x, mean, rstd)
    assert torch.equal(out, same)
    assert (L.snapshot() - before)[("k4_dy", "copy")] == 1
    ref = BN.bn_backward_sums_reference(dy, x, mean, rstd)
    assert rel_err(out, ref, math.sqrt(4 * 8 * 8)) <= CARD_TOL
    _check_both_stages(dy, x, mean, rstd, _weight(64, cuda, 5), True)
    w = _weight(64, cuda, 5)
    assert torch.equal(_k4_dx(dy, x, mean, rstd, w, ref),
                       _k4_dx(cl, x, mean, rstd, w, ref))


@pytest.mark.cuda
def test_kernel_gives_equal_bits_twice_on_card(cuda):
    dy, x, mean, rstd = _card_sums((16, 14, 14, 256), torch.bfloat16, cuda, 6)
    assert torch.equal(_k4(dy, x, mean, rstd), _k4(dy, x, mean, rstd))
    sums = _k4(dy, x, mean, rstd)
    w = _weight(256, cuda, 6)
    assert torch.equal(_k4_dx(dy, x, mean, rstd, w, sums),
                       _k4_dx(dy, x, mean, rstd, w, sums))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_backward_through_kernel_on_card(cuda, dtype):
    """dx, dγ, dβ through both kernels equal those through both plain
    versions, up to the sums' own rounding."""
    x, scale, bias, w = _inputs((4, 8, 8, 128), 7)
    grads = []
    for fns in ((BN.bn_backward_sums, BN.bn_backward_dx),
                (BN.bn_backward_sums_reference, BN.bn_backward_dx_reference)):
        before = L.snapshot()
        xt = _nchw(x, dtype).to(cuda).requires_grad_()
        st, bt = (torch.from_numpy(a).to(cuda).requires_grad_()
                  for a in (scale, bias))
        y, _, _ = BN.bn_train(xt, st, bt, EPS, dtype, *fns)
        (y.float() * _nchw(w).to(cuda)).sum().backward()
        kernels = fns[0] is BN.bn_backward_sums
        assert (_launched(before, "k4_sums")[0],
                _launched(before, "k4_dx")[0]) == (int(kernels), int(kernels))
        grads.append([xt.grad.float(), st.grad, bt.grad])
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, r, atol in zip(("dx", "dscale", "dbias"), *grads,
                                (1.0, 16.0, 16.0)):
        assert rel_err(a, r, atol) <= tol, name


# -- the forward's kernels on the card ---------------------------------------
# The statistics kernel and its plain version read x exactly and sum in fp32
# in other orders: per element |a − b| / (|ref| + 1) on the O(1) means, var
# and rstd, at most 1e-5. The apply kernel rounds as the torch ops do, so it
# is held to them bit for bit.
def _fwd_counts():
    """The forward's launches counted: (statistics, of them vector, apply,
    of them vector)."""
    n = L.snapshot()
    stats, apply = n[("bn_stats", "vector")], n[("bn_apply", "vector")]
    return (stats + n[("bn_stats", "scalar")], stats,
            apply + n[("bn_apply", "scalar")], apply)


def _card_x(shape, dtype, device, seed, aligned=True):
    """x ~ 2·N(0, 1) + 0.5 as an NCHW view of NHWC memory (one element into
    its buffer unless ``aligned``), and fp32 scale and bias."""
    x, scale, bias, _ = _inputs(shape, seed)
    xt = _nchw(x, dtype).to(device) if aligned else _offset_view(
        x, dtype, device)
    return xt, torch.from_numpy(scale).to(device), torch.from_numpy(
        bias).to(device)


def _fwd_stats(x, eps, vector, running=None):
    """The statistics kernel, checked to launch once in the variant asked."""
    before = _fwd_counts()
    out = BN.bn_forward_stats(x, eps, running)
    torch.cuda.synchronize()
    after = _fwd_counts()
    assert after[0] == before[0] + 1
    assert after[1] == before[1] + int(vector)
    return out


def _fwd_apply(x, mean, rstd, weight, bias, dtype, vector):
    """The apply kernel under no_grad, checked likewise."""
    before = _fwd_counts()
    with torch.no_grad():
        y = BN.bn_apply(x, mean, rstd, weight, bias, dtype)
    torch.cuda.synchronize()
    after = _fwd_counts()
    assert after[2:] == (before[2] + 1, before[3] + int(vector))
    assert y.shape == x.shape and y.dtype == dtype
    return y


def _check_forward_kernels(x, weight, bias, dtype, vector):
    """Both forward kernels against their plain versions, each launched
    twice for equal bits; the apply bit-equal to the torch ops on the
    kernel's own statistics, in ``dtype``."""
    stats = _fwd_stats(x, EPS, vector)
    assert torch.equal(stats, _fwd_stats(x, EPS, vector))
    ref = BN.bn_forward_stats_reference(x, EPS)
    assert stats.shape == ref.shape == (4, x.shape[1])
    for name, a, r in zip(("mean", "mean2", "var", "rstd"), stats, ref):
        assert rel_err(a, r, 1.0) <= 1e-5, name
    means = _fwd_stats(x, None, vector)
    assert torch.equal(means, stats[:2])
    mean, _, _, rstd = stats
    y = _fwd_apply(x, mean, rstd, weight, bias, dtype, vector)
    assert torch.equal(y, _fwd_apply(x, mean, rstd, weight, bias, dtype,
                                     vector))
    assert torch.equal(y, BN.bn_apply_reference(x, mean, rstd, weight, bias,
                                                dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vector", "scalar"])
@pytest.mark.parametrize("hw,C", R50_SHAPES)
def test_forward_kernels_at_resnet50_shapes_on_card(cuda, hw, C, variant):
    """bf16, batch 8; the scalar variants through a view one element into
    its buffer."""
    vector = variant == "vector"
    x, w, b = _card_x((8, hw, hw, C), torch.bfloat16, cuda, 17,
                      aligned=vector)
    _check_forward_kernels(x, w, b, torch.bfloat16, vector)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vector", "scalar"])
@pytest.mark.parametrize("x_dtype,dtype", DTYPE_PAIRS)
def test_forward_kernels_every_dtype_on_card(cuda, x_dtype, dtype, variant):
    """All four (x, output) dtype pairs at an odd M (3·7·7 × 64); the
    statistics in x's dtype."""
    vector = variant == "vector"
    x, w, b = _card_x((3, 7, 7, 64), x_dtype, cuda, 18, aligned=vector)
    _check_forward_kernels(x, w, b, dtype, vector)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernels_for_c_not_a_multiple_of_8_on_card(cuda, dtype):
    """C 60: bf16 takes the scalar variants, fp32 the 4-wide vector ones."""
    x, w, b = _card_x((3, 7, 7, 60), dtype, cuda, 19)
    _check_forward_kernels(x, w, b, dtype, dtype == torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["vector", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_statistics_kernel_updates_running_statistics_on_card(cuda, dtype,
                                                              variant):
    """Finalising, the statistics kernel updates the running statistics in
    the same launch, bit-equal to ``update_running_reference`` of its own
    mean and var, and the count by one; running statistics it cannot write
    (a strided view) get the same bits from the torch ops; without eps
    they are left alone. The statistics are the bits of a launch without
    running statistics."""
    vector = variant == "vector"
    x, _, _ = _card_x((8, 14, 14, 256), dtype, cuda, 26, aligned=vector)
    M = 8 * 14 * 14
    rng = np.random.RandomState(27)
    mean0 = torch.from_numpy((0.3 * rng.randn(256)).astype(np.float32))
    var0 = torch.from_numpy(rng.uniform(0.5, 2.0, 256).astype(np.float32))

    def running(strided=False):
        mean, var = mean0.to(cuda), var0.to(cuda)
        if strided:
            mean = torch.stack([mean, mean], 1)[:, 0]
            assert not mean.is_contiguous()
        return BN.Running(mean, var, torch.zeros((), dtype=torch.int64,
                                                 device=cuda), 0.9, M)

    stats = _fwd_stats(x, EPS, vector)
    want = running()
    BN.update_running_reference(want, stats[0], stats[2])
    for strided in (False, True):
        got = running(strided)
        assert torch.equal(_fwd_stats(x, EPS, vector, got), stats)
        assert torch.equal(got.mean, want.mean)
        assert torch.equal(got.var, want.var)
        assert int(got.count) == 1
    untouched = running()
    _fwd_stats(x, None, vector, untouched)
    assert torch.equal(untouched.mean.cpu(), mean0)
    assert torch.equal(untouched.var.cpu(), var0)
    assert int(untouched.count) == 0


@pytest.mark.cuda
def test_forward_kernels_read_an_nchw_contiguous_x_on_card(cuda):
    """An NCHW-contiguous x is copied to rows: the same bits as its
    channels_last twin."""
    x, w, b = _card_x((4, 8, 8, 64), torch.bfloat16, cuda, 20)
    nchw = x.contiguous()
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    stats = _fwd_stats(nchw, EPS, True)
    assert torch.equal(stats, _fwd_stats(x, EPS, True))
    mean, _, _, rstd = stats
    assert torch.equal(
        _fwd_apply(nchw, mean, rstd, w, b, torch.bfloat16, True),
        _fwd_apply(x, mean, rstd, w, b, torch.bfloat16, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_mode_apply_is_bit_equal_on_card(cuda, dtype):
    """An eval-mode SubsampledBatchNorm under no_grad: one apply launch and
    no statistics, the bits of the torch ops on its running statistics;
    with gradients on and x needing one, the torch ops and no launch."""
    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    x, w, b = _card_x((4, 14, 14, 256), dtype, cuda, 21)
    rng = np.random.RandomState(22)
    bn = SubsampledBatchNorm(256, dtype=dtype).to(cuda).eval()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(torch.from_numpy(
            (0.5 + 0.3 * rng.randn(256)).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 4.0, 256).astype(np.float32)))
    before = _fwd_counts()
    with torch.no_grad():
        y = bn(x)
    torch.cuda.synchronize()
    assert _fwd_counts() == (before[0], before[1], before[2] + 1,
                             before[3] + 1)
    rstd = 1.0 / torch.sqrt(bn.running_var + bn.eps)
    ref = BN.bn_apply_reference(x, bn.running_mean, rstd, bn.weight,
                                bn.bias, dtype)
    assert torch.equal(y, ref)
    before = _fwd_counts()
    y_grad = bn(x.detach().requires_grad_())
    assert y_grad.grad_fn is not None and _fwd_counts() == before
    assert torch.equal(y_grad.detach(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_forward_and_backward_through_kernels_on_card(cuda, dtype):
    """``bn_train`` with every kernel (two forward launches and two of K4)
    against the plain versions of all four: y within one rounding of
    ``dtype`` (the statistics differ in their last bits), the statistics
    within 1e-5, dx, dγ, dβ as the K4 test above holds them."""
    x, scale, bias, w = _inputs((4, 8, 8, 128), 23)
    xt = _nchw(x, dtype).to(cuda).requires_grad_()
    st, bt = (torch.from_numpy(a).to(cuda).requires_grad_()
              for a in (scale, bias))
    before = (_fwd_counts(), L.snapshot())
    y, mean, var = BN.bn_train(xt, st, bt, EPS, dtype)
    (y.float() * _nchw(w).to(cuda)).sum().backward()
    counts = _fwd_counts()
    assert counts[0] == before[0][0] + 1 and counts[2] == before[0][2] + 1
    assert (_launched(before[1], "k4_sums")[0],
            _launched(before[1], "k4_dx")[0]) == (1, 1)
    xr = xt.detach()
    stats = BN.bn_forward_stats_reference(xr, EPS)
    y_ref = BN.bn_apply_reference(xr, stats[0], stats[3], st.detach(),
                                  bt.detach(), dtype)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert rel_err(y.float(), y_ref.float(), 1.0) <= tol
    assert rel_err(mean, stats[0], 1.0) <= 1e-5
    assert rel_err(var, stats[2], 1.0) <= 1e-5
    dy = _nchw(w).to(cuda).to(dtype)
    sums = BN.bn_backward_sums_reference(dy, xr, stats[0], stats[3])
    dx = BN.bn_backward_dx_reference(dy, xr, stats[0], stats[3],
                                     st.detach(), sums)
    for name, a, r, atol in zip(("dx", "dscale", "dbias"),
                                (xt.grad.float(), st.grad, bt.grad),
                                (dx.float(), sums[1], sums[0]),
                                (1.0, 16.0, 16.0)):
        assert rel_err(a, r, atol) <= tol, name


@pytest.mark.cuda
def test_forward_counters_after_one_resnet50_forward_on_card(cuda):
    """ResNet-50 (bf16, B 2 at 64²): 53 statistics and 53 apply launches in
    train mode, all in the vector variants; 53 apply and no statistics in
    eval mode under no_grad; none of either at stat stride 4, whose
    sampler differentiates through the torch ops."""
    from virtex_tpu_torch.modules.resnet import make_resnet
    image = torch.from_numpy(np.random.RandomState(24).rand(
        2, 64, 64, 3).astype(np.float32)).to(cuda)
    model = make_resnet("resnet50").to(cuda)
    sampler = make_resnet("resnet50", bn_stat_stride=4).to(cuda)
    cases = ((model, True, torch.enable_grad, (53, 53, 53, 53)),
             (model, False, torch.no_grad, (0, 0, 53, 53)),
             (sampler, True, torch.enable_grad, (0, 0, 0, 0)))
    for net, training, mode, want in cases:
        net.train(training)
        L.reset()
        with mode():
            net(image)
        torch.cuda.synchronize()
        assert _fwd_counts() == want
