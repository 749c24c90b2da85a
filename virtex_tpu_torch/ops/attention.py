r"""
Fused scaled-dot-product attention: kernels K1 (forward) and K2 (backward)
and their plain versions.

Counterpart of ``virtex_tpu/ops/attention.py``: :func:`fused_attention`
keeps the contract of the JAX ``fused_attention`` (layouts, mask, dropout
seed), :func:`attention_reference` is the math of its ``xla_attention``
plus dropout from an explicit :class:`torch.Generator`, and
:func:`attention_backward_reference` is the math of its backward kernel
given an explicit keep mask.

On a CPU tensor :func:`fused_attention` computes the plain version, and
autograd differentiates it. On a CUDA tensor it launches K1
(``csrc/attention_fwd.cu``), whose gradient launches K2
(``csrc/attention_bwd.cu``), or raises; there is no fallback. Each kernel
has two variants, chosen by :func:`use_tensor_cores`: bf16 operands with D
a multiple of 16 up to 128 and at most 128 keys take the tensor-core
variant (``mma.sync``), everything else the scalar one. An operand the
tensor-core variant cannot read with 16-byte loads (``ops/_launch.py
aligned_16``) is copied first. ``ops/_launch.py`` counts the launches under
``("k1" | "k2", "mma" | "scalar")``.

Dropout on the card draws from Philox4x32-10 (``csrc/philox.cuh``), keyed
on (seed, b) and counted on (head, q, k), so K2 regenerates K1's keep
mask; :func:`philox_keep_reference` computes that mask in torch integer
ops, bit for bit. The kernels read the seed from device memory, so a
seed drawn on the card is never read back to the host.

Layouts: q (B, Tq, N, D); k, v (B, Tk, N, D); bool mask (B, 1|N, Tq, Tk),
True = attend. Returns (B, Tq, N, D) in q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from virtex_tpu_torch.ops import _build
from virtex_tpu_torch.ops._launch import (
    MAX_SMEM_BYTES,
    aligned_operand,
    launch,
)

NEG_INF = -1e9  # masked logit, as in the JAX package (not -inf)

Seed = Union[int, torch.Tensor, None]


def _seed_int(seed: Seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The dropout seed as one int64 on ``device``; a tensor already there
    is viewed, not read."""
    if torch.is_tensor(seed):
        return seed.reshape(-1)[:1].to(device=device, dtype=torch.int64)
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


def _threshold(rate: float) -> int:
    """Keep iff the 32-bit word, read unsigned, is >= ceil(rate * 2^32)."""
    return min(2**32 - 1, math.ceil(rate * 2**32))


def _logits(q, k, mask):
    """fp32 S = QKᵀ/√D, −1e9 where the mask is False: (B, N, Tq, Tk)."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1])
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Seed = None) -> torch.Tensor:
    """Plain PyTorch attention: fp32 logits and softmax, P cast to v's
    dtype, P·V accumulated in fp32. Dropout keeps where u >= rate, with u
    drawn from a generator seeded by ``dropout_seed``."""
    p = torch.softmax(_logits(q, k, mask), dim=-1)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("attention_reference: dropout_rate > 0 "
                             "requires dropout_seed")
        gen = torch.Generator(device=q.device)
        gen.manual_seed(_seed_int(dropout_seed))
        u = torch.rand(p.shape, generator=gen, device=q.device)
        p = torch.where(u >= dropout_rate, p / (1.0 - dropout_rate),
                        torch.zeros_like(p))
    p = p.to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", p.float(), v.float())
    return out.to(q.dtype)


def attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor,
        keep: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 (the JAX ``_bwd_kernel``), all in fp32: P is
    recomputed, ``keep`` (bool (B, N, Tq, Tk), or None for no dropout)
    drops with scale 1/(1 − rate), and dq, dk, dv come out in q's, k's and
    v's dtype."""
    p = torch.softmax(_logits(q, k, mask), dim=-1)
    gf, vf = g.float(), v.float()
    dp = torch.einsum("bqnd,bknd->bnqk", gf, vf)
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_rate)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
    else:
        pd = p
    dv = torch.einsum("bnqk,bqnd->bknd", pd, gf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if mask is not None:
        ds = torch.where(mask, ds, torch.zeros_like(ds))
    ds = ds / math.sqrt(q.shape[-1])
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k.float())
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- Philox4x32-10 in torch integer ops (csrc/philox.cuh) ---------------------
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(m: int, x: torch.Tensor):
    """High and low 32-bit words of m·x for m, x < 2³², from 16-bit halves
    so that no int64 product overflows."""
    ml, mh = m & 0xFFFF, m >> 16
    xl, xh = x & 0xFFFF, x >> 16
    ll, lh, hl, hh = ml * xl, ml * xh, mh * xl, mh * xh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter: Sequence, key: Sequence) -> Tuple:
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words:
    counter (c0, c1, c2, c3), key (k0, k1) → four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_MUL[0], c0)
        hi1, lo1 = _mulhilo32(_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _WEYL[0]) & _MASK32
        k1 = (k1 + _WEYL[1]) & _MASK32
    return c0, c1, c2, c3


def philox_keep_reference(seed: Seed, B: int, N: int, Tq: int, Tk: int,
                          rate: float, device=None) -> torch.Tensor:
    """The keep mask K1 and K2 draw, (B, N, Tq, Tk) bool: key (seed, b),
    counter (head, q, k, 0), keep iff the first word ≥ ceil(rate·2³²)."""
    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    shape = (B, N, Tq, Tk)
    b, h, i, j = (axis(n, d).expand(shape)
                  for d, n in enumerate((B, N, Tq, Tk)))
    seed = torch.full(shape, _seed_int(seed) & _MASK32, dtype=torch.int64,
                      device=device)
    word, _, _, _ = philox4x32_10((h, i, j, torch.zeros_like(seed)),
                                  (seed, b))
    return word >= _threshold(rate)


# -- the kernels ---------------------------------------------------------------
def _check_operands(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"fused_attention: want q (B,Tq,N,D), k = v "
                         f"(B,Tk,N,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, N, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, N, D):
        raise ValueError(f"fused_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, N or D")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("fused_attention: q, k, v on different devices")
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError(f"fused_attention: mask must be bool, got "
                            f"{mask.dtype}")
        if mask.dim() != 4 or mask.shape[1] not in (1, N):
            raise ValueError(f"fused_attention: mask must be (B, 1|N, Tq, "
                             f"Tk), got {tuple(mask.shape)}")
        if mask.device != q.device:
            raise ValueError("fused_attention: mask on another device")


def _check_kernel_operands(name, q, k, v):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} needs one dtype for q, k, v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{name} needs unit stride along D")
    B, Tq, N, D = q.shape
    Tk = k.shape[1]
    if min(B, Tq, Tk, N, D) == 0:
        raise ValueError(f"{name} needs non-empty operands; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if B * N >= 2**31:
        raise ValueError(f"{name}: B*N = {B * N} blocks is too many")


def _mask_arg(mask, B, Tq, Tk):
    """The mask's pointer and element strides (b, h, q, k); a head stride
    of 0 broadcasts over heads, a null pointer means no mask."""
    if mask is None:
        return None, (0, 0, 0, 0)
    mask = mask.expand(B, mask.shape[1], Tq, Tk)
    return mask.data_ptr(), (mask.stride(0),
                             mask.stride(1) if mask.shape[1] > 1 else 0,
                             mask.stride(2), mask.stride(3))


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def use_tensor_cores(dtype: torch.dtype, D: int, Tk: int) -> bool:
    """Whether K1 and K2 take their tensor-core variants: bf16 operands, D
    a multiple of 16 up to 128 (whole m16n8k16 tiles, fragments that fit
    in registers) and at most 128 keys (the logits of 16 query rows held
    in registers)."""
    return (dtype == torch.bfloat16 and D % 16 == 0 and D <= 128
            and Tk <= 128)


class _AttentionFwd(torch.autograd.Function):
    """K1 launch; its gradient is a K2 launch, which recomputes P from the
    saved operands and regenerates the dropout mask from the seed (a
    device tensor, or None without dropout)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, rate, seed):
        ctx.save_for_backward(q, k, v, mask)
        ctx.rate, ctx.seed = rate, seed
        return _launch(q, k, v, mask, rate, seed)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, mask, grad, ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None


def _seed_arg(rate: float, seed: Optional[torch.Tensor]):
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed tensor")
    return None if rate == 0.0 else seed.data_ptr()


def _launch(q, k, v, mask, rate: float,
            seed: Optional[torch.Tensor]) -> torch.Tensor:
    """K1 on the card; ``seed`` is one int64 on q's device (or None when
    ``rate`` is 0)."""
    _check_kernel_operands("K1", q, k, v)
    B, Tq, N, D = q.shape
    Tk = k.shape[1]
    mma = use_tensor_cores(q.dtype, D, Tk)
    if mma:
        q, k, v = (aligned_operand(t) for t in (q, k, v))
    else:
        smem = _build.library().virtex_attention_fwd_smem_bytes(Tk, D)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"K1: Tk={Tk}, D={D} needs {smem} B of shared "
                             f"memory, more than a block has")
    mask_ptr, ms = _mask_arg(mask, B, Tq, Tk)
    out = torch.empty((B, Tq, N, D), dtype=q.dtype, device=q.device)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                out.data_ptr(), B, Tq, Tk, N, D)
    rest = (*_strides(q), *_strides(k), *_strides(v), *ms,
            1.0 / math.sqrt(D), rate, _threshold(rate), _seed_arg(rate, seed))
    if mma:
        launch(("k1", "mma"), "virtex_attention_fwd_mma", q, *operands,
               *rest)
    else:
        launch(("k1", "scalar"), "virtex_attention_fwd", q, *operands,
               int(q.dtype == torch.bfloat16), *rest)
    return out


def _launch_bwd(q, k, v, mask, g, rate: float, seed: Optional[torch.Tensor]):
    """K2 on the card: (dq, dk, dv); ``seed`` as for :func:`_launch`."""
    _check_kernel_operands("K2", q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"K2: gradient {tuple(g.shape)} {g.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if g.stride(3) != 1:
        g = g.contiguous()  # K2 reads g by (b, t, n) strides, D unit stride
    B, Tq, N, D = q.shape
    Tk = k.shape[1]
    lib = _build.library()
    mma = use_tensor_cores(q.dtype, D, Tk)
    if mma:
        q, k, v, g = (aligned_operand(t) for t in (q, k, v, g))
        smem = lib.virtex_attention_bwd_mma_smem_bytes(Tq, Tk, D)
    else:
        smem = lib.virtex_attention_bwd_smem_bytes(Tq, Tk, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K2: Tq={Tq}, Tk={Tk}, D={D} needs {smem} B of "
                         f"shared memory, more than a block has")
    mask_ptr, ms = _mask_arg(mask, B, Tq, Tk)
    dq = torch.empty((B, Tq, N, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, N, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, N, D), dtype=v.dtype, device=q.device)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Tq, Tk, N, D)
    rest = (*_strides(q), *_strides(k), *_strides(v), *_strides(g), *ms,
            1.0 / math.sqrt(D), rate, _threshold(rate), _seed_arg(rate, seed))
    if mma:
        launch(("k2", "mma"), "virtex_attention_bwd_mma", q, *operands,
               *rest)
    else:
        launch(("k2", "scalar"), "virtex_attention_bwd", q, *operands,
               int(q.dtype == torch.bfloat16), *rest)
    return dq, dk, dv


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Seed = None) -> torch.Tensor:
    r"""Fused SDPA. Shapes: q (B, Tq, N, D); k, v (B, Tk, N, D); bool
    ``mask`` (B, 1|N, Tq, Tk), True = attend. Returns (B, Tq, N, D)."""
    _check_operands(q, k, v, mask)
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_attention: dropout_rate {rate} is not in "
                         "[0, 1)")
    if rate > 0.0 and dropout_seed is None:
        # A silent constant seed would reuse the identical keep-mask every
        # step and layer.
        raise ValueError("fused_attention: dropout_rate > 0 requires "
                         "dropout_seed")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, rate, dropout_seed)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for {q.device}")
    seed = _seed_tensor(dropout_seed, q.device) if rate > 0.0 else None
    return _AttentionFwd.apply(q, k, v, mask, rate, seed)
