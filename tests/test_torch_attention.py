"""The port's attention (virtex_tpu_torch.ops.attention) against the JAX
package's: ``xla_attention`` and the Pallas ``fused_attention`` in
interpret mode, on the same numpy inputs, in float32 on the CPU.

Every comparison is the per-element error |a − b| / (|ref| + atol) with
its bound stated. Cases marked ``cuda`` hold kernel K1 against the plain
version on the card and skip elsewhere (a CUDA kernel has no CPU mode).
"""
import functools

import numpy as np
import pytest
import torch

from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import attention as A

B, Tq, Tk, N, D = 2, 8, 12, 4, 16
# fp32 on the CPU: the two sides sum the D and Tk products in other orders
# and take exp by other routines; measured |a − b| <= 5e-7 on outputs of
# scale 1 (q, k, v ~ N(0, 1)). Bound: 1e-4 relative, with an absolute floor
# of 1e-2 of that scale (so <= 1e-6 absolute near zero).
TOL, ATOL = 1e-4, 1e-2


def rel_err(a, ref, atol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + atol)))


def _k1(q, k):
    """The count key of K1's launch on these operands."""
    mma = A.use_tensor_cores(q.dtype, q.shape[3], k.shape[1])
    return ("k1", "mma" if mma else "scalar")


@pytest.fixture
def jax_attn():
    """The JAX package's attention. Imported here, not at the top: the
    ``cuda`` cases below run on a machine without JAX."""
    from virtex_tpu.ops import attention
    return attention


def _qkv(seed, tk=Tk):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Tq, N, D).astype(np.float32),
            rng.randn(B, tk, N, D).astype(np.float32),
            rng.randn(B, tk, N, D).astype(np.float32))


def _mask(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "none":
        return None
    if kind == "causal_pad":  # causal + key padding, lengths 8 and 5
        lengths = np.array([Tq, 5])
        key_ok = np.arange(Tq)[None, :] < lengths[:, None]
        causal = np.tril(np.ones((Tq, Tq), bool))
        return key_ok[:, None, None, :] & causal[None, None]
    if kind == "per_head":  # (B, N, Tq, Tk), one key always kept per row
        m = rng.rand(B, N, Tq, Tk) > 0.4
        m[..., 0] = True
        return m
    if kind == "pad_only":  # masked LM's key padding alone, (B, 1, 1, Tq)
        lengths = np.array([Tq, 5])
        return (np.arange(Tq)[None, :] < lengths[:, None])[:, None, None, :]
    raise ValueError(kind)


# Self-attention masks: keys are the queries' positions.
SELF_KINDS = ("causal_pad", "pad_only")
KINDS = ["none", "causal_pad", "per_head", "pad_only"]


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the JAX package's Pallas kernel in interpret mode (CPU), as
    tests/test_ops.py does."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _port(q, k, v, mask):
    return A.fused_attention(_torch(q), _torch(k), _torch(v),
                             _torch(mask)).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_xla_attention(kind, jax_attn):
    q, k, v = _qkv(1, Tq if kind in SELF_KINDS else Tk)
    mask = _mask(kind)
    ref = jax_attn.xla_attention(q, k, v, mask)
    assert rel_err(_port(q, k, v, mask), ref, ATOL) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_pallas_kernel(kind, jax_attn, interpret_mode):
    q, k, v = _qkv(2, Tq if kind in SELF_KINDS else Tk)
    mask = _mask(kind)
    ref = jax_attn.fused_attention(q, k, v, mask)
    assert rel_err(_port(q, k, v, mask), ref, ATOL) <= TOL


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    q, k, v = map(_torch, _qkv(3))
    before = L.snapshot()
    out = A.fused_attention(q, k, v)
    assert L.snapshot() == before
    assert torch.equal(out, A.attention_reference(q, k, v))


def test_dropout_needs_a_seed():
    q, k, v = map(_torch, _qkv(4))
    with pytest.raises(ValueError, match="dropout_seed"):
        A.fused_attention(q, k, v, dropout_rate=0.1)


def _keep_fraction(fn, rate, seed):
    """q = k = 0 gives uniform P, so with v = 1 the mean output is the
    kept fraction over (1 − rate) (tests/tpu_attention_parity.py)."""
    b, t, n, d = 4, 64, 4, 8
    z = torch.zeros(b, t, n, d)
    out = fn(z, z, torch.ones(b, t, n, d), None, rate, seed)
    return float(out.mean()) * (1.0 - rate), out


# -- which variant of K1/K2 a call takes, and what it copies first -----------
@pytest.mark.parametrize("dtype,D,Tk,want", [
    (torch.bfloat16, 64, 30, True),     # flagship self-attention
    (torch.bfloat16, 64, 49, True),     # cross-attention over 7x7 tokens
    (torch.bfloat16, 64, 79, True),     # the wide gate shape
    (torch.bfloat16, 16, 1, True),
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 64, 129, False),   # logits of 16 rows exceed registers
    (torch.bfloat16, 24, 30, False),    # not whole k16 tiles
    (torch.bfloat16, 144, 30, False),   # over 128
    (torch.float32, 64, 30, False),     # fp32 keeps the scalar kernel
    (torch.float16, 64, 30, False),
])
def test_variant_rule(dtype, D, Tk, want):
    assert A.use_tensor_cores(dtype, D, Tk) is want


def _packed_views(extra, dtype=torch.bfloat16, b=2, t=5, n=4, d=16):
    """q, k, v as views of one (b, t, 3·n·d + extra) projection, starting
    ``extra`` elements in."""
    buf = torch.zeros(b, t, 3 * n * d + extra, dtype=dtype)
    return [x.view(b, t, n, d) for x in buf[..., extra:].split(n * d, -1)]


def test_alignment_rule():
    q = torch.zeros(2, 5, 4, 16, dtype=torch.bfloat16)
    assert L.aligned_16(q)
    assert all(L.aligned_16(x) for x in _packed_views(0))
    # one element in: base pointer 2 bytes off, row stride 193 elements
    assert not any(L.aligned_16(x) for x in _packed_views(1))
    # eight elements in: base 16 bytes in, row stride 200 elements = 400 B
    assert all(L.aligned_16(x) for x in _packed_views(8))
    # a stride that is never used (a dimension of 1) does not count
    one = torch.zeros(1, 5, 4, 16, dtype=torch.bfloat16).as_strided(
        (1, 5, 4, 16), (3, 64, 16, 1))
    assert L.aligned_16(one)
    # fp32 rows of 4 are 16 bytes; heads of 3 elements are not
    assert L.aligned_16(torch.zeros(2, 5, 4, 4))
    assert not L.aligned_16(torch.zeros(2, 5, 4, 3)[..., :2])


def test_unaligned_operand_is_copied_aligned_and_equal():
    q, _, _ = _packed_views(1)
    q.copy_(torch.randn(q.shape).to(q.dtype))
    got = L.aligned_operand(q)
    assert got.data_ptr() != q.data_ptr() and L.aligned_16(got)
    assert got.is_contiguous() and torch.equal(got, q)
    aligned = _packed_views(0)[0]
    assert L.aligned_operand(aligned) is aligned


def test_seed_tensor_is_an_int64_view_of_a_device_seed():
    seed = torch.tensor(123456789, dtype=torch.int64)
    got = A._seed_tensor(seed, seed.device)
    assert got.dtype == torch.int64 and got.shape == (1,)
    assert got.data_ptr() == seed.data_ptr()  # a view: nothing is read back
    assert int(A._seed_tensor(7, "cpu")) == 7
    assert A._seed_tensor(torch.tensor([5], dtype=torch.int32), "cpu").dtype \
        == torch.int64


def test_plain_dropout_keep_rate_and_seeding():
    rate = 0.1
    keep, out = _keep_fraction(A.attention_reference, rate, 7)
    # 65536 Bernoulli(0.9) draws: std 1.2e-3, so ±0.01 is > 8 sigma.
    assert abs(keep - (1.0 - rate)) < 0.01
    _, again = _keep_fraction(A.attention_reference, rate, 7)
    _, other = _keep_fraction(A.attention_reference, rate, 8)
    assert torch.equal(out, again)
    assert not torch.equal(out, other)


# -- kernel K1 on the card ---------------------------------------------------
# Run there with: python -m pytest tests/test_torch_attention.py -m cuda
# --noconftest (tests/conftest.py imports JAX, which that machine lacks).
# Per element |a − b| / (|ref| + 1): outputs are O(1), so the floor is their
# scale. fp32: two sums of <= Tk products in other orders; bf16: a flipped
# rounding of P or of the output is 2^-8 relative.
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU "
                    "mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(cuda, dtype, kind):
    q, k, v = (_torch(x).to(cuda, dtype)
               for x in _qkv(5, Tq if kind in SELF_KINDS else Tk))
    mask = _torch(_mask(kind))
    mask = None if mask is None else mask.to(cuda)
    before = L.snapshot()
    out = A.fused_attention(q, k, v, mask)
    assert L.snapshot() - before == {_k1(q, k): 1}
    ref = A.attention_reference(q, k, v, mask)
    assert out.dtype == ref.dtype == dtype
    assert rel_err(out.float().cpu(), ref.float().cpu(), 1.0) <= CARD_TOL[dtype]


def _task_ablation_case(kind, dtype, device, seed):
    """The attention of the task ablations' ``L1_H2048_A32_F8192`` head:
    32 heads of 64, q/k/v ~ N(0, 1) at batch 8, with the mask as
    ``make_self_attention_mask`` returns it: causal + key padding (B, 1,
    30, 30) for captioning, key padding alone (B, 1, 1, 30) for masked LM,
    which the kernels read with a query stride of 0; none for the 30×49
    cross-attention."""
    from virtex_tpu_torch.modules.transformer import make_self_attention_mask
    b, t, n, d = 8, 30, 32, 64
    rng = np.random.RandomState(seed)
    tk = 49 if kind == "cross" else t

    def draw(tt):
        return torch.from_numpy(rng.randn(b, tt, n, d).astype(
            np.float32)).to(device, dtype)
    q, k, v = draw(t), draw(tk), draw(tk)
    if kind == "cross":
        return q, k, v, None
    lengths = rng.randint(3, t + 1, b)
    lengths[0] = t
    mask = make_self_attention_mask(
        torch.zeros(b, t, dtype=torch.long, device=device),
        torch.from_numpy(lengths).to(device), causal=kind == "causal_pad")
    assert mask.shape == ((b, 1, t, t) if kind == "causal_pad"
                          else (b, 1, 1, t))
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal_pad", "pad_only", "cross"])
def test_kernel_matches_plain_at_32_heads_on_card(cuda, dtype, kind):
    q, k, v, mask = _task_ablation_case(kind, dtype, cuda, 9)
    before = L.snapshot()
    out = A.fused_attention(q, k, v, mask)
    assert L.snapshot() - before == {_k1(q, k): 1}
    ref = A.attention_reference(q, k, v, mask)
    assert rel_err(out.float().cpu(), ref.float().cpu(), 1.0) <= CARD_TOL[dtype]


@pytest.mark.cuda
def test_kernel_reads_strided_projections_on_card(cuda):
    """q/k/v as views into one packed (B, T, 3·N·D) projection, as the
    self-attention passes them, give what contiguous copies give."""
    rng = np.random.RandomState(6)
    packed = torch.from_numpy(rng.randn(B, Tq, 3 * N * D).astype(np.float32))
    q, k, v = (t.view(B, Tq, N, D) for t in packed.to(cuda).split(N * D, -1))
    assert not q.is_contiguous()
    mask = _torch(_mask("causal_pad")).to(cuda)
    out = A.fused_attention(q, k, v, mask)
    ref = A.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            mask)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_card(cuda):
    q, k, v = (_torch(x).to(cuda) for x in _qkv(7))
    with pytest.raises(TypeError):
        A.fused_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="unit stride"):
        A.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                          k, v)
    with pytest.raises(ValueError, match="different devices"):
        A.fused_attention(q, k.cpu(), v)


@pytest.mark.cuda
def test_kernel_dropout_keep_rate_on_card(cuda):
    rate = 0.1

    def kernel(q, k, v, mask, rate, seed):
        return A.fused_attention(q.to(cuda), k.to(cuda), v.to(cuda), mask,
                                 rate, seed).cpu()

    keep, out = _keep_fraction(kernel, rate, 42)
    assert 0.89 <= keep <= 0.91
    _, again = _keep_fraction(kernel, rate, 42)
    _, other = _keep_fraction(kernel, rate, 43)
    assert torch.equal(out, again) and not torch.equal(out, other)


# -- K1's tensor-core variant on the card ------------------------------------
# bf16 with D a multiple of 16: the main path's shapes at a small batch and
# the edges of the tiling. Tolerance as above (CARD_TOL, bf16).
MMA_CASES = {
    # name: (B, Tq, Tk, N, D, mask kind)
    "self 30x30 causal+pad": (4, 30, 30, 16, 64, "causal_pad"),
    "cross 30x49": (4, 30, 49, 16, 64, "none"),
    "32 heads pad-only": (4, 30, 30, 32, 64, "pad_only"),
    "gate 30x79": (4, 30, 79, 32, 64, "none"),
    "per-head mask": (2, 30, 49, 4, 64, "per_head"),
    "Tq 1": (3, 1, 49, 4, 64, "none"),
    "Tk 1": (3, 30, 1, 4, 64, "none"),
    "fully masked row": (2, 30, 30, 4, 64, "row_masked"),
    "D 16": (2, 30, 30, 4, 16, "causal_pad"),
    "D 32": (2, 30, 49, 4, 32, "per_head"),
    "D 128": (2, 30, 49, 4, 128, "causal_pad"),
    "Tq 100 (two Q chunks)": (2, 100, 49, 4, 64, "per_head"),
    "Tk 128": (2, 30, 128, 4, 64, "per_head"),
    "Tk 100 D 128": (2, 17, 100, 4, 128, "none"),
}


def card_case(B, Tq, Tk, N, D, kind, device, seed=11, dtype=torch.bfloat16):
    """q (B, Tq, N, D), k and v (B, Tk, N, D) ~ N(0, 1) and the mask:
    causal + key padding, key padding alone (B, 1, 1, Tk), per head, or
    causal with query row 3 fully masked. Shared with the K2 tests."""
    rng = np.random.RandomState(seed)

    def draw(t):
        return torch.from_numpy(rng.randn(B, t, N, D).astype(np.float32)).to(
            device, dtype)
    q, k, v = draw(Tq), draw(Tk), draw(Tk)
    lengths = rng.randint(1, Tk + 1, B)
    lengths[0] = Tk
    key_ok = np.arange(Tk)[None, :] < lengths[:, None]
    causal = np.arange(Tk)[None, :] <= np.arange(Tq)[:, None]
    if kind == "none":
        m = None
    elif kind == "causal_pad":
        m = key_ok[:, None, None, :] & causal[None, None]
    elif kind == "pad_only":
        m = key_ok[:, None, None, :]
    elif kind == "per_head":
        m = rng.rand(B, N, Tq, Tk) > 0.4
    elif kind == "row_masked":
        m = np.broadcast_to(causal, (B, 1, Tq, Tk)).copy()
        m[:, :, 3, :] = False
    else:
        raise ValueError(kind)
    mask = None if m is None else torch.from_numpy(np.ascontiguousarray(
        m)).to(device)
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_tensor_core_variant_matches_plain_on_card(cuda, name):
    q, k, v, mask = card_case(*MMA_CASES[name], cuda)
    before = L.snapshot()
    out = A.fused_attention(q, k, v, mask)
    assert L.snapshot() - before == {("k1", "mma"): 1}
    ref = A.attention_reference(q, k, v, mask)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert rel_err(out.float().cpu(), ref.float().cpu(), 1.0) \
        <= CARD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Tk", [(torch.float32, 64, 49),
                                        (torch.bfloat16, 24, 49),
                                        (torch.bfloat16, 64, 130)])
def test_scalar_variant_takes_the_rest_on_card(cuda, dtype, D, Tk):
    q, k, v, mask = card_case(2, 30, Tk, 4, D, "per_head", cuda, dtype=dtype)
    before = L.snapshot()
    out = A.fused_attention(q, k, v, mask)
    assert L.snapshot() - before == {("k1", "scalar"): 1}
    ref = A.attention_reference(q, k, v, mask)
    assert rel_err(out.float().cpu(), ref.float().cpu(), 1.0) \
        <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 8])
def test_tensor_core_variant_reads_unaligned_views_on_card(cuda, extra):
    """q/k/v as views of one packed projection starting ``extra`` elements
    in: at 1 neither the base nor the row stride is 16-byte aligned, so the
    wrapper copies them; at 8 it reads them in place. Either way the output
    is that of contiguous copies."""
    b, t, n, d = 3, 30, 4, 64
    rng = np.random.RandomState(12)
    buf = torch.from_numpy(rng.randn(b, t, 3 * n * d + extra).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (x.view(b, t, n, d) for x in buf[..., extra:].split(n * d, -1))
    assert L.aligned_16(q) is (extra == 8)
    mask = card_case(b, t, t, n, d, "causal_pad", cuda)[3]
    before = L.snapshot()
    out = A.fused_attention(q, k, v, mask)
    assert L.snapshot() - before == {("k1", "mma"): 1}
    ref = A.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            mask)
    assert torch.equal(out, ref)
