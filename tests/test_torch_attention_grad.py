"""The port's attention gradient (virtex_tpu_torch.ops.attention: kernel K2
and its plain version) against the JAX package's, and the dropout stream
K1 and K2 share.

On the CPU: dq/dk/dv by autograd through the port's plain attention and by
``attention_backward_reference``, against ``jax.grad`` of the JAX Pallas
``fused_attention`` in interpret mode and of ``xla_attention``, on the
same numpy inputs in float32; ``philox_keep_reference`` against the
Random123 known-answer vectors of Philox4x32-10. Every comparison is the
per-element error |a − b| / (|ref| + atol) with its bound stated.

Cases marked ``cuda`` hold K2 against the plain version on the card, and
K1's and K2's dropout against ``philox_keep_reference`` bit for bit; they
skip elsewhere (a CUDA kernel has no CPU mode).
"""
import functools

import numpy as np
import pytest
import torch

from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import attention as A

B, Tq, Tk, N, D = 2, 8, 12, 4, 16
# fp32 on the CPU: gradients of scale ~1 (q, k, v, g ~ N(0, 1)) summed over
# <= Tk or Tq products in other orders on each side. Bound: 1e-4 relative
# with an absolute floor of 1e-2 of that scale; measured <= 4e-5.
TOL, ATOL = 1e-4, 1e-2


def rel_err(a, ref, atol):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + atol)))


def _inputs(seed, tk=Tk, tq=Tq):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, tq, N, D).astype(np.float32),
            rng.randn(B, tk, N, D).astype(np.float32),
            rng.randn(B, tk, N, D).astype(np.float32),
            rng.randn(B, tq, N, D).astype(np.float32))


def _mask(kind, tq=Tq, tk=Tk, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "none":
        return None
    if kind == "causal_pad":  # causal + key padding, lengths tq and 5
        lengths = np.array([tq, 5])
        key_ok = np.arange(tq)[None, :] < lengths[:, None]
        causal = np.tril(np.ones((tq, tq), bool))
        return key_ok[:, None, None, :] & causal[None, None]
    if kind == "per_head":  # (B, N, Tq, Tk), one key always kept per row
        m = rng.rand(B, N, tq, tk) > 0.4
        m[..., 0] = True
        return m
    if kind == "pad_only":  # masked LM's key padding alone, (B, 1, 1, tq)
        lengths = np.array([tq, 5])
        return (np.arange(tq)[None, :] < lengths[:, None])[:, None, None, :]
    raise ValueError(kind)


# Self-attention masks: keys are the queries' positions.
SELF_KINDS = ("causal_pad", "pad_only")
KINDS = ["none", "causal_pad", "per_head", "pad_only"]


def _case(kind, seed):
    tk = Tq if kind in SELF_KINDS else Tk
    q, k, v, g = _inputs(seed, tk)
    return q, k, v, g, _mask(kind, Tq, tk)


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (CPU), as
    tests/test_ops.py does."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax_grads(fn, q, k, v, g, mask):
    import jax
    import jax.numpy as jnp

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mask) * g)
    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _autograd_plain(q, k, v, g, mask):
    q, k, v = (_torch(x).requires_grad_() for x in (q, k, v))
    out = A.fused_attention(q, k, v, _torch(mask))  # CPU: the plain version
    out.backward(_torch(g))
    return [x.grad.numpy() for x in (q, k, v)]


def _explicit_plain(q, k, v, g, mask):
    return [x.numpy() for x in A.attention_backward_reference(
        _torch(q), _torch(k), _torch(v), _torch(mask), _torch(g))]


@pytest.mark.parametrize("port", ["autograd", "explicit"])
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_pallas_kernel(kind, port, interpret_mode):
    from virtex_tpu.ops import attention as jattn
    q, k, v, g, mask = _case(kind, 1)
    ref = _jax_grads(jattn.fused_attention, q, k, v, g, mask)
    fn = _autograd_plain if port == "autograd" else _explicit_plain
    for name, ours, theirs in zip("qkv", fn(q, k, v, g, mask), ref):
        assert rel_err(ours, theirs, ATOL) <= TOL, name


@pytest.mark.parametrize("port", ["autograd", "explicit"])
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_xla_attention(kind, port):
    from virtex_tpu.ops import attention as jattn
    q, k, v, g, mask = _case(kind, 2)
    ref = _jax_grads(jattn.xla_attention, q, k, v, g, mask)
    fn = _autograd_plain if port == "autograd" else _explicit_plain
    for name, ours, theirs in zip("qkv", fn(q, k, v, g, mask), ref):
        assert rel_err(ours, theirs, ATOL) <= TOL, name


def test_explicit_dropout_gradient_matches_autograd():
    """With a keep mask, attention_backward_reference is the gradient of
    the forward that drops with that mask (P·keep/(1 − rate) before P·V)."""
    rate = 0.25
    q, k, v, g, mask = (_torch(x) for x in _case("causal_pad", 3))
    keep = A.philox_keep_reference(7, B, N, Tq, Tq, rate)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    p = torch.softmax(A._logits(q, k, mask), dim=-1)
    p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    torch.einsum("bnqk,bknd->bqnd", p, v).backward(g)
    ours = A.attention_backward_reference(q.detach(), k.detach(), v.detach(),
                                          mask, g, keep, rate)
    for name, a, x in zip("qkv", ours, (q, k, v)):
        assert rel_err(a.numpy(), x.grad.numpy(), ATOL) <= TOL, name


# Random123's known-answer vectors for Philox4x32-10:
# (counter; key) → output, 32-bit words.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    def words(ws):
        return [torch.tensor([w], dtype=torch.int64) for w in ws]
    got = A.philox4x32_10(words(counter), words(key))
    assert tuple(int(w) for w in got) == want


def test_philox_keep_mask_layout_and_rate():
    rate = 0.1
    keep = A.philox_keep_reference(42, 4, 16, 30, 49, rate)
    assert keep.shape == (4, 16, 30, 49) and keep.dtype == torch.bool
    # 94080 Bernoulli(0.9) draws: std 1e-3, so ±0.01 is > 9 sigma.
    assert abs(float(keep.float().mean()) - (1.0 - rate)) < 0.01
    # Entry (b, h, q, k) is the first word of counter (h, q, k, 0) under key
    # (seed, b), compared unsigned with ceil(rate·2³²).
    c0, _, _, _ = A.philox4x32_10(
        [torch.tensor([w]) for w in (5, 7, 11, 0)],
        [torch.tensor([42]), torch.tensor([3])])
    assert bool(keep[3, 5, 7, 11]) == (int(c0) >= int(np.ceil(rate * 2**32)))
    assert not torch.equal(keep, A.philox_keep_reference(43, 4, 16, 30, 49,
                                                         rate))
    assert bool(A.philox_keep_reference(42, 2, 2, 3, 3, 0.0).all())


# -- kernel K2 on the card ---------------------------------------------------
# Run there with: python -m pytest tests/test_torch_attention_grad.py -m cuda
# --noconftest. Per element |a − b| / (|ref| + 1), gradients O(1).
# fp32: sums of <= Tk or Tq products in other orders; bf16: the gradients
# are rounded to 8 bits once on each side, 2^-8 relative.
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 is a CUDA kernel with no CPU "
                    "mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _card_case(kind, dtype, device, seed, tq=Tq, tk=Tk, d=D):
    rng = np.random.RandomState(seed)
    tk = tq if kind in SELF_KINDS else tk

    def draw(t):
        return torch.from_numpy(rng.randn(B, t, N, d).astype(np.float32)).to(
            device, dtype)
    mask = _torch(_mask(kind, tq, tk, seed))
    return (draw(tq), draw(tk), draw(tk), draw(tq),
            None if mask is None else mask.to(device))


def _k2(q, k, v, g, mask, rate=0.0, seed=0):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    before = L.snapshot()
    A.fused_attention(q, k, v, mask, rate, seed if rate else None).backward(g)
    torch.cuda.synchronize()
    ran = L.snapshot() - before
    assert ran[("k2", "mma")] + ran[("k2", "scalar")] == 1
    return q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_gradients_match_plain_on_card(cuda, dtype, kind):
    q, k, v, g, mask = _card_case(kind, dtype, cuda, 5)
    ours = _k2(q, k, v, g, mask)
    ref = A.attention_backward_reference(q, k, v, mask, g)
    for name, a, r in zip("qkv", ours, ref):
        assert a.dtype == r.dtype == dtype
        assert rel_err(a.float().cpu(), r.float().cpu(), 1.0) \
            <= CARD_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal_pad", "pad_only", "cross"])
def test_kernel_gradients_match_plain_at_32_heads_on_card(cuda, dtype, kind):
    """The task ablations' 32 heads of 64 at batch 8, with masks as
    ``make_self_attention_mask`` returns them: causal + key padding (B, 1,
    30, 30), masked LM's key padding alone (B, 1, 1, 30), read with a
    query stride of 0, and none for the 30×49 cross-attention; without and
    with dropout."""
    from virtex_tpu_torch.modules.transformer import make_self_attention_mask
    b, tq, n, d = 8, 30, 32, 64
    tk = 49 if kind == "cross" else tq
    rng = np.random.RandomState(10)

    def draw(t):
        return torch.from_numpy(rng.randn(b, t, n, d).astype(np.float32)).to(
            cuda, dtype)
    q, k, v, g = draw(tq), draw(tk), draw(tk), draw(tq)
    mask = None
    if kind != "cross":
        lengths = rng.randint(3, tq + 1, b)
        lengths[0] = tq
        mask = make_self_attention_mask(
            torch.zeros(b, tq, dtype=torch.long, device=cuda),
            torch.from_numpy(lengths).to(cuda), causal=kind == "causal_pad")
        assert mask.shape[2] == (tq if kind == "causal_pad" else 1)
    rate, seed = 0.1, 77
    keep = A.philox_keep_reference(seed, b, n, tq, tk, rate, device=cuda)
    for r, ref in ((0.0, A.attention_backward_reference(q, k, v, mask, g)),
                   (rate, A.attention_backward_reference(q, k, v, mask, g,
                                                         keep, rate))):
        ours = _k2(q, k, v, g, mask, r, seed)
        for name, a, x in zip("qkv", ours, ref):
            assert rel_err(a.float().cpu(), x.float().cpu(), 1.0) \
                <= CARD_TOL[dtype], (r, name)


@pytest.mark.cuda
def test_kernel_takes_the_cross_shape_over_48k_shared_memory_on_card(cuda):
    """Tq 30, Tk 49, D 64 needs ~53 KB of shared memory per block: the
    launcher opts the kernel in above the 48 KB default."""
    from virtex_tpu_torch.ops import _build
    assert _build.library().virtex_attention_bwd_smem_bytes(30, 49, 64) \
        > 48 * 1024
    q, k, v, g, mask = _card_case("none", torch.float32, cuda, 6, 30, 49, 64)
    ours = _k2(q, k, v, g, mask)
    ref = A.attention_backward_reference(q, k, v, mask, g)
    for name, a, r in zip("qkv", ours, ref):
        assert rel_err(a.cpu(), r.cpu(), 1.0) <= CARD_TOL[torch.float32], name


@pytest.mark.cuda
def test_kernel_reads_strided_projections_and_gradient_on_card(cuda):
    """q/k/v as views of one packed projection and a non-contiguous g give
    what contiguous copies give."""
    rng = np.random.RandomState(7)
    packed = torch.from_numpy(rng.randn(B, Tq, 3 * N * D).astype(
        np.float32)).to(cuda)
    q, k, v = (t.view(B, Tq, N, D) for t in packed.split(N * D, -1))
    g = torch.from_numpy(rng.randn(B, N, Tq, D).astype(np.float32)).to(
        cuda).transpose(1, 2)
    assert not q.is_contiguous() and not g.is_contiguous()
    mask = _torch(_mask("causal_pad")).to(cuda)
    ours = _k2(q, k, v, g, mask)
    ref = _k2(q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous(),
              mask)
    for a, r in zip(ours, ref):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_kernel_dropout_is_philox_bit_for_bit_on_card(cuda):
    """q = k = 0 makes P uniform. With v the identity over (key, d), K1's
    output row i is keep[i, :]/(Tk·(1 − rate)); with g the identity over
    (query, d), K2's dv[j, i] is keep[i, j]/(Tk·(1 − rate)). Both keep masks
    must equal philox_keep_reference exactly."""
    rate, seed, tq, tk, d = 0.1, 1234, 30, 49, 64
    z_q = torch.zeros(B, tq, N, d, device=cuda)
    z_k = torch.zeros(B, tk, N, d, device=cuda)
    eye_v = torch.eye(tk, d, device=cuda)[None, :, None, :].expand(
        B, tk, N, d).contiguous()
    eye_g = torch.eye(tq, d, device=cuda)[None, :, None, :].expand(
        B, tq, N, d).contiguous()
    want = A.philox_keep_reference(seed, B, N, tq, tk, rate, device=cuda)
    out = A.fused_attention(z_q, z_k, eye_v, None, rate, seed)
    k1_keep = out.permute(0, 2, 1, 3)[..., :tk] > 0
    assert torch.equal(k1_keep, want)
    _, _, dv = _k2(z_q, z_k, eye_v, eye_g, None, rate, seed)
    k2_keep = dv.permute(0, 2, 3, 1)[:, :, :tq, :] > 0
    assert torch.equal(k2_keep, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_dropout_gradients_match_plain_on_card(cuda, dtype):
    rate, seed = 0.1, 99
    q, k, v, g, mask = _card_case("causal_pad", dtype, cuda, 8)
    ours = _k2(q, k, v, g, mask, rate, seed)
    keep = A.philox_keep_reference(seed, B, N, Tq, Tq, rate, device=cuda)
    ref = A.attention_backward_reference(q, k, v, mask, g, keep, rate)
    for name, a, r in zip("qkv", ours, ref):
        assert rel_err(a.float().cpu(), r.float().cpu(), 1.0) \
            <= CARD_TOL[dtype], name


# -- K2's tensor-core variant on the card ------------------------------------
# bf16, D a multiple of 16. dS and Pd are fp32 and enter their products as
# two-term bf16 splits (~2^-16 relative), so the error left is the bf16
# rounding of the stored gradients: CARD_TOL[bf16] as above.
MMA_CASES = {
    # name: (B, Tq, Tk, N, D, mask kind)
    "self 30x30 causal+pad": (4, 30, 30, 16, 64, "causal_pad"),
    "cross 30x49": (4, 30, 49, 16, 64, "none"),
    "32 heads pad-only": (4, 30, 30, 32, 64, "pad_only"),
    "per-head mask": (2, 30, 49, 4, 64, "per_head"),
    "Tq 1": (3, 1, 49, 4, 64, "none"),
    "Tk 1": (3, 30, 1, 4, 64, "none"),
    "fully masked row": (2, 30, 30, 4, 64, "row_masked"),
    "D 16": (2, 30, 30, 4, 16, "causal_pad"),
    "D 32": (2, 30, 49, 4, 32, "per_head"),
    "D 128": (2, 30, 49, 4, 128, "causal_pad"),
    "Tq 70": (2, 70, 49, 4, 64, "per_head"),
    "Tk 128": (2, 30, 128, 4, 64, "per_head"),
    "Tk 100 D 128": (2, 17, 100, 4, 128, "none"),
}


def _mma_case(B, Tq, Tk, N, D, kind, device, seed=13):
    """bf16 q, g (B, Tq, N, D), k, v (B, Tk, N, D) ~ N(0, 1) and the mask:
    causal + key padding, key padding alone (B, 1, 1, Tk), per head, or
    causal with query row 3 fully masked."""
    rng = np.random.RandomState(seed)

    def draw(t):
        return torch.from_numpy(rng.randn(B, t, N, D).astype(np.float32)).to(
            device, torch.bfloat16)
    q, k, v, g = draw(Tq), draw(Tk), draw(Tk), draw(Tq)
    lengths = rng.randint(1, Tk + 1, B)
    lengths[0] = Tk
    key_ok = np.arange(Tk)[None, :] < lengths[:, None]
    causal = np.arange(Tk)[None, :] <= np.arange(Tq)[:, None]
    m = {"none": None,
         "causal_pad": key_ok[:, None, None, :] & causal[None, None],
         "pad_only": key_ok[:, None, None, :],
         "per_head": rng.rand(B, N, Tq, Tk) > 0.4,
         "row_masked": np.broadcast_to(causal, (B, 1, Tq, Tk)).copy()}[kind]
    if kind == "row_masked":
        m[:, :, 3, :] = False
    mask = None if m is None else torch.from_numpy(np.ascontiguousarray(
        m)).to(device)
    return q, k, v, g, mask


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", list(MMA_CASES))
def test_tensor_core_gradients_match_plain_on_card(cuda, name, rate):
    B_, Tq_, Tk_, N_ = MMA_CASES[name][:4]
    q, k, v, g, mask = _mma_case(*MMA_CASES[name], cuda)
    seed = 31
    before = L.snapshot()
    ours = _k2(q, k, v, g, mask, rate, seed)
    assert (L.snapshot() - before)[("k2", "mma")] == 1
    keep = (A.philox_keep_reference(seed, B_, N_, Tq_, Tk_, rate, device=cuda)
            if rate else None)
    ref = A.attention_backward_reference(q, k, v, mask, g, keep, rate)
    for part, a, r in zip("qkv", ours, ref):
        assert a.dtype == r.dtype == torch.bfloat16
        assert torch.isfinite(a.float()).all(), part
        assert rel_err(a.float().cpu(), r.float().cpu(), 1.0) \
            <= CARD_TOL[torch.bfloat16], part


@pytest.mark.cuda
def test_tensor_core_gradients_read_unaligned_views_on_card(cuda):
    """q/k/v one element into a packed projection and g a transposed view:
    copied by the wrapper, the gradients equal those of contiguous
    copies."""
    b, t, n, d = 3, 30, 4, 64
    rng = np.random.RandomState(14)
    buf = torch.from_numpy(rng.randn(b, t, 3 * n * d + 1).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (x.view(b, t, n, d) for x in buf[..., 1:].split(n * d, -1))
    g = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)).to(
        cuda, torch.bfloat16).transpose(1, 2)
    assert not L.aligned_16(q)
    mask = _mma_case(b, t, t, n, d, "causal_pad", cuda)[4]
    before = L.snapshot()
    ours = _k2(q, k, v, g, mask)
    ref = _k2(q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous(),
              mask)
    assert (L.snapshot() - before)[("k2", "mma")] == 2
    for a, r in zip(ours, ref):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_tensor_core_dropout_is_philox_bit_for_bit_on_card(cuda):
    """As the fp32 case above, in bf16, so that both tensor-core variants
    draw their keep masks: K1's output and K2's dv are positive exactly
    where philox_keep_reference keeps."""
    rate, seed, tq, tk, d = 0.1, 4321, 30, 49, 64
    z_q = torch.zeros(B, tq, N, d, device=cuda, dtype=torch.bfloat16)
    z_k = torch.zeros(B, tk, N, d, device=cuda, dtype=torch.bfloat16)

    def eye(t):
        return torch.eye(t, d, device=cuda, dtype=torch.bfloat16)[
            None, :, None, :].expand(B, t, N, d).contiguous()
    want = A.philox_keep_reference(seed, B, N, tq, tk, rate, device=cuda)
    before = L.snapshot()
    out = A.fused_attention(z_q, z_k, eye(tk), None, rate, seed)
    assert torch.equal(out.permute(0, 2, 1, 3)[..., :tk] > 0, want)
    _, _, dv = _k2(z_q, z_k, eye(tk), eye(tq), None, rate, seed)
    assert torch.equal(dv.permute(0, 2, 3, 1)[:, :, :tq, :] > 0, want)
    assert L.snapshot() - before == {("k1", "mma"): 2, ("k2", "mma"): 1}
