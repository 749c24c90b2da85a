r"""
Decode attention: one new query token per row against a K/V cache, as the
caption loop's decode step runs it, and its plain version.

``decode_attention(q, k, v, n_valid, rows_per_kv)``: q (R, 1, N, D); k, v
(R / rows_per_kv, Tk, N, D), any row, position and head strides with unit
stride along D, so the caches are read where they lie. Query row r attends
K/V row r // rows_per_kv at its first ``n_valid`` positions. Returns (R,
1, N, D) in q's dtype.

Replaces no TPU kernel: the JAX package's decode step is plain einsum
attention (``virtex_tpu/modules/transformer.py``). On CUDA in bf16 it
launches ``csrc/decode_attention.cu``, which reads each K/V position once
per K/V row (once per image for the beams' cross-attention) and never the
positions at or past ``n_valid``. ``ops/_launch.py`` counts its launches
under ``("decode_attention", "vector")`` and, while a profiler records,
notes each one's shape (R, K/V rows, n_valid, N, D) under
``"decode_attention"`` in the store of ``utils/tracing.py``, at each replay
of a CUDA graph that captured it too. On the CPU and in fp32 it computes
:func:`decode_attention_reference`: fp32 logits scaled by 1/√D, −1e9 at
the positions past ``n_valid``, an fp32 softmax, the probabilities
rounded to q's dtype and P·V summed in fp32, each K/V row repeated to its
query rows, which are the decode path's einsum ops as they were.
"""
from __future__ import annotations

import math

import torch

from virtex_tpu_torch.ops import _build
from virtex_tpu_torch.ops._launch import (
    MAX_SMEM_BYTES,
    aligned_operand,
    launch,
)
from virtex_tpu_torch.ops.attention import NEG_INF

# Head sizes the kernel is built for: D / 8 lanes, 16 bytes each, cover a
# position, and they have to divide a warp.
KERNEL_DIMS = (8, 16, 32, 64, 128, 256)
KEY = ("decode_attention", "vector")  # the launches' count key


def _check(q, k, v, n_valid: int, rows_per_kv: int) -> None:
    if (q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4
            or k.shape != v.shape):
        raise ValueError(f"decode_attention: want q (R, 1, N, D), k = v "
                         f"(rows, Tk, N, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    R, _, N, D = q.shape
    rows, Tk = k.shape[:2]
    if (k.shape[2], k.shape[3]) != (N, D):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on N or D")
    if rows_per_kv < 1 or R != rows * rows_per_kv:
        raise ValueError(f"decode_attention: {R} query rows are not "
                         f"{rows_per_kv} per K/V row of {rows}")
    if not 1 <= n_valid <= Tk:
        raise ValueError(f"decode_attention: n_valid {n_valid} outside "
                         f"[1, {Tk}]")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("decode_attention: q, k, v on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention needs one dtype for q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, n_valid: int,
                               rows_per_kv: int = 1) -> torch.Tensor:
    """Plain PyTorch decode attention (see the module docstring)."""
    if rows_per_kv > 1:
        k = k.repeat_interleave(rows_per_kv, dim=0)
        v = v.repeat_interleave(rows_per_kv, dim=0)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    Tk = k.shape[1]
    if n_valid < Tk:
        valid = torch.arange(Tk, device=q.device) < n_valid
        logits = torch.where(valid[None, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs.float(),
                        v.float()).to(q.dtype)


def _launch(q, k, v, n_valid: int, rows_per_kv: int) -> torch.Tensor:
    R, _, N, D = q.shape
    rows = k.shape[0]
    if D not in KERNEL_DIMS:
        raise ValueError(f"decode_attention: no kernel for D = {D} (built "
                         f"for {KERNEL_DIMS})")
    if rows * N >= 2**31:
        raise ValueError(f"decode_attention: {rows} K/V rows of {N} heads "
                         "are too many")
    lib = _build.library()
    smem = lib.virtex_decode_attention_smem_bytes(rows_per_kv, n_valid)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: n_valid {n_valid} needs {smem} "
                         f"B of shared memory, more than a block has")
    q, k, v = (aligned_operand(t) for t in (q, k, v))
    out = torch.empty((R, 1, N, D), dtype=q.dtype, device=q.device)
    launch(KEY, "virtex_decode_attention", q,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), rows,
           rows_per_kv, n_valid, N, D, q.stride(0), q.stride(2),
           *k.stride()[:3], *v.stride()[:3], math.sqrt(D),
           note=(R, rows, n_valid, N, D))
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: int, rows_per_kv: int = 1) -> torch.Tensor:
    r"""Attention of each query row to the first ``n_valid`` positions of
    its K/V row (see the module docstring): the kernel on CUDA in bf16, the
    plain version on the CPU and in fp32."""
    _check(q, k, v, n_valid, rows_per_kv)
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        return _launch(q, k, v, n_valid, rows_per_kv)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    return decode_attention_reference(q, k, v, n_valid, rows_per_kv)
