r"""
Fused scaled-dot-product attention: kernel K1 and its plain version.

Counterpart of ``virtex_tpu/ops/attention.py``: :func:`fused_attention`
keeps the contract of the JAX ``fused_attention`` (layouts, mask, dropout
seed), and :func:`attention_reference` is the math of its
``xla_attention`` plus dropout from an explicit :class:`torch.Generator`.

On a CPU tensor :func:`fused_attention` computes the plain version. On a
CUDA tensor it launches K1 (``csrc/attention_fwd.cu``) or raises; there is
no fallback. :data:`launch_count` counts K1 launches.

Layouts: q (B, Tq, N, D); k, v (B, Tk, N, D); bool mask (B, 1|N, Tq, Tk),
True = attend. Returns (B, Tq, N, D) in q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

NEG_INF = -1e9  # masked logit, as in the JAX package (not -inf)
MAX_SMEM_BYTES = 227 * 1024  # shared memory one Hopper block can use

Seed = Union[int, torch.Tensor, None]

launch_count = 0  # K1 launches since import or the last reset


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _seed_int(seed: Seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Seed = None) -> torch.Tensor:
    """Plain PyTorch attention: fp32 logits and softmax, P cast to v's
    dtype, P·V accumulated in fp32. Dropout keeps where u >= rate, with u
    drawn from a generator seeded by ``dropout_seed``."""
    depth = q.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = s / math.sqrt(depth)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
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


class _AttentionFwd(torch.autograd.Function):
    """K1 launch. Its gradient is kernel K2, which the training slice
    brings; until then :func:`fused_attention` refuses inputs that need
    one, so :meth:`backward` is never reached."""

    @staticmethod
    def forward(ctx, q, k, v, mask, rate, seed):
        return _launch(q, k, v, mask, rate, seed)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("K1 has no backward kernel yet")


def _launch(q, k, v, mask, rate: float, seed: int) -> torch.Tensor:
    global launch_count
    from virtex_tpu_torch.ops import _build

    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K1 needs one dtype for q, k, v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("K1 needs unit stride along D")
    B, Tq, N, D = q.shape
    Tk = k.shape[1]
    if min(B, Tq, Tk, N, D) == 0:
        raise ValueError(f"K1 needs non-empty operands; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if B * N >= 2**31:
        raise ValueError(f"K1: B*N = {B * N} blocks is too many")
    lib = _build.library()
    smem = lib.virtex_attention_fwd_smem_bytes(Tk, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K1: Tk={Tk}, D={D} needs {smem} B of shared "
                         f"memory, more than a block has")
    if mask is None:
        mask_ptr, ms = None, (0, 0, 0, 0)
    else:
        mask = mask.expand(B, mask.shape[1], Tq, Tk)
        mask_ptr = mask.data_ptr()
        ms = (mask.stride(0), mask.stride(1) if mask.shape[1] > 1 else 0,
              mask.stride(2), mask.stride(3))
    out = torch.empty((B, Tq, N, D), dtype=q.dtype, device=q.device)
    threshold = min(2**32 - 1, math.ceil(rate * 2**32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.virtex_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            out.data_ptr(), B, Tq, Tk, N, D, int(q.dtype == torch.bfloat16),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), *ms,
            1.0 / math.sqrt(D), rate, threshold, seed & 0xFFFFFFFF, stream)
    _build.check(err, "K1 attention_fwd launch")
    launch_count += 1
    return out


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "fused_attention on CUDA has no backward kernel yet (K2); "
            "run it under torch.no_grad()")
    seed = _seed_int(dropout_seed) if dropout_seed is not None else 0
    return _AttentionFwd.apply(q, k, v, mask, rate, seed)
