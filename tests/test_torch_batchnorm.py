"""The port's train-mode BatchNorm op (virtex_tpu_torch.ops.batchnorm:
``bn_train`` with kernel K4 and its plain version) against the JAX
package's ``virtex_tpu.ops.batchnorm``, on the same numpy inputs.

On the CPU: ``bn_train``'s output, statistics and dx, dγ, dβ against the
JAX ``bn_train`` with its Pallas reduction in interpret mode, at the JAX
op's four test shapes (M = 98 included, where the JAX side falls back to
jnp), in float32 and bfloat16; ``bn_backward_sums_reference`` against the
JAX ``bn_backward_sums(interpret=True)``. Every comparison is the
per-element error |a − b| / (|ref| + atol) with its bound stated.

Cases marked ``cuda`` hold K4 against the plain version on the card (an
NCHW-contiguous dy, an odd M, and equal bits from two launches); they skip
elsewhere (a CUDA kernel has no CPU mode).
"""
import math

import numpy as np
import pytest
import torch

from virtex_tpu_torch.ops import batchnorm as BN

EPS = 1e-5
SHAPES = [(4, 8, 8, 256), (4, 8, 8, 64), (2, 7, 7, 2048), (16, 4, 4, 128)]
DTYPES = ["float32", "bfloat16"]


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
    before = BN.launch_count
    out = BN.bn_backward_sums(_nchw(dy), _nchw(x), mean, rstd)
    assert BN.launch_count == before
    assert torch.equal(out, BN.bn_backward_sums_reference(
        _nchw(dy), _nchw(x), mean, rstd))
    with pytest.raises(ValueError, match="one"):
        BN.bn_backward_sums(_nchw(dy)[:1], _nchw(x), mean, rstd)


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
# --noconftest. K4 and the plain version both read the inputs exactly and
# sum in fp32 in other orders: per element |a − b| / (|ref| + sqrt(M)) with
# sqrt(M) the scale of a sum of M terms of scale 1.
CARD_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 is a CUDA kernel with no CPU "
                    "mode")
    return torch.device("cuda")


def _card_sums(shape, dtype, device, seed, dy_layout="channels_last"):
    x, _, _, dy = _inputs(shape, seed)
    rng = np.random.RandomState(seed + 1)
    C = shape[-1]
    mean = torch.from_numpy((0.5 + 0.1 * rng.randn(C)).astype(
        np.float32)).to(device)
    rstd = torch.from_numpy(rng.uniform(0.3, 0.7, C).astype(
        np.float32)).to(device)
    xt = _nchw(x, dtype).to(device)
    dyt = _nchw(dy, dtype).to(device)
    if dy_layout == "nchw":
        dyt = dyt.contiguous()
        assert not dyt.is_contiguous(memory_format=torch.channels_last)
    return dyt, xt, mean, rstd


def _k4(dy, x, mean, rstd):
    before = BN.launch_count
    out = BN.bn_backward_sums(dy, x, mean, rstd)
    torch.cuda.synchronize()
    assert BN.launch_count == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + [(3, 7, 7, 64)])  # odd M = 147
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    dy, x, mean, rstd = _card_sums(shape, dtype, cuda, 4)
    out = _k4(dy, x, mean, rstd)
    ref = BN.bn_backward_sums_reference(dy, x, mean, rstd)
    M = math.prod(shape[:-1])
    assert out.shape == ref.shape == (2, shape[-1])
    assert rel_err(out, ref, math.sqrt(M)) <= CARD_TOL


@pytest.mark.cuda
def test_kernel_reads_an_nchw_contiguous_dy_on_card(cuda):
    dy, x, mean, rstd = _card_sums((4, 8, 8, 64), torch.bfloat16, cuda, 5,
                                   dy_layout="nchw")
    out = _k4(dy, x, mean, rstd)
    same = _k4(dy.contiguous(memory_format=torch.channels_last), x, mean,
               rstd)
    assert torch.equal(out, same)
    ref = BN.bn_backward_sums_reference(dy, x, mean, rstd)
    assert rel_err(out, ref, math.sqrt(4 * 8 * 8)) <= CARD_TOL


@pytest.mark.cuda
def test_kernel_gives_equal_bits_twice_on_card(cuda):
    dy, x, mean, rstd = _card_sums((16, 14, 14, 256), torch.bfloat16, cuda, 6)
    assert torch.equal(_k4(dy, x, mean, rstd), _k4(dy, x, mean, rstd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_backward_through_kernel_on_card(cuda, dtype):
    """dx, dγ, dβ with K4's sums equal those with the plain sums, up to
    the sums' own rounding."""
    x, scale, bias, w = _inputs((4, 8, 8, 128), 7)
    grads = []
    for sums_fn in (BN.bn_backward_sums, BN.bn_backward_sums_reference):
        xt = _nchw(x, dtype).to(cuda).requires_grad_()
        st, bt = (torch.from_numpy(a).to(cuda).requires_grad_()
                  for a in (scale, bias))
        y, _, _ = BN.bn_train(xt, st, bt, EPS, dtype, sums_fn)
        (y.float() * _nchw(w).to(cuda)).sum().backward()
        grads.append([xt.grad.float(), st.grad, bt.grad])
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, r, atol in zip(("dx", "dscale", "dbias"), *grads,
                                (1.0, 16.0, 16.0)):
        assert rel_err(a, r, atol) <= tol, name
