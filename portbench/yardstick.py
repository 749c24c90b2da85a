r"""
The yardstick's arithmetic: the card's published peaks, a kernel's bound
(least time) from its bytes and operations, the bytes and operations of
kernels K1, K2 and K4's two stages, and the model FLOPs of a bicaptioning
train step.

Frozen copies: ``bound`` and ``attention_bound`` are ``chip_smoke.py``'s,
and K4's byte and operation counts are those ``chip_smoke.py time_bn``
holds each stage to. Later changes to the program do not move them.
Every count reads each input once and writes each output once.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# HBM bytes/s, bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

BF16, FP32, BOOL = 2, 4, 1  # bytes per element


def bound(bytes_moved: float, flops: float,
          flop_rate: float = BF16_FLOPS) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take, the larger of moving ``bytes_moved`` at HBM rate and doing
    ``flops`` at ``flop_rate``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(B: int, Tq: int, Tk: int, N: int, D: int,
                    mask_elems: int, backward: bool,
                    elem: int = BF16) -> Tuple[float, str]:
    """K1's (or K2's) bound: q, k, v (and g) read once, the output (or dq,
    dk, dv) written once, the bool mask read once; 2 (or 5) products of
    2·B·N·Tq·Tk·D FLOPs at the bf16 rate."""
    qb, kb = B * Tq * N * D * elem, B * Tk * N * D * elem
    moved = ((2 * qb + 2 * kb + 2 * kb + qb) if backward
             else (qb + 2 * kb + qb)) + mask_elems * BOOL
    return bound(moved, 2 * (5 if backward else 2) * B * N * Tq * Tk * D)


def k4_sums_bound(M: int, C: int, elem: int = BF16) -> Tuple[float, str]:
    """K4 stage 1: dy and x read (M, C), mean and rstd read (C,), the
    (2, C) fp32 sums written; 4·M·C fp32 operations."""
    moved = 2 * M * C * elem + 2 * C * FP32 + 2 * C * FP32
    return bound(moved, 4 * M * C, FP32_FLOPS)


def k4_dx_bound(M: int, C: int, elem: int = BF16) -> Tuple[float, str]:
    """K4 stage 2: dy and x read, dx written (M, C); mean, rstd, weight
    and the (2, C) sums read; 6·M·C fp32 operations."""
    moved = 3 * M * C * elem + 5 * C * FP32
    return bound(moved, 6 * M * C, FP32_FLOPS)


def k4_bound_s(bn_inputs: Iterable[Sequence[int]], elem: int = BF16
               ) -> float:
    """Seconds of both K4 stages' bounds over BatchNorm inputs (B, C, H,
    W), one backward (two launches) each."""
    total = 0.0
    for B, C, H, W in bn_inputs:
        M = B * H * W
        total += k4_sums_bound(M, C, elem)[0] + k4_dx_bound(M, C, elem)[0]
    return total


# -- model FLOPs --------------------------------------------------------------
RESNET50_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def resnet50_forward_flops(image_size: int) -> int:
    """Convolution FLOPs (2 per multiply-add) of one image through
    torchvision's ResNet-50 trunk ("v1.5": the stride on the 3×3 conv),
    no classifier."""
    macs = 0
    s = image_size // 2                      # the 7×7 stem, stride 2
    macs += 64 * 3 * 49 * s * s
    s //= 2                                  # the 3×3 max pool, stride 2
    cin = 64
    for stage, (blocks, width) in enumerate(RESNET50_STAGES):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            out = s // stride
            macs += width * cin * s * s                # 1×1 reduce
            macs += width * width * 9 * out * out      # 3×3, strided
            macs += 4 * width * width * out * out      # 1×1 expand
            if block == 0:                             # projection shortcut
                macs += 4 * width * cin * out * out
            cin, s = 4 * width, out
    return 2 * macs


def decoder_forward_flops(L: int, visual_tokens: int, visual_dim: int,
                          H: int, F: int, vocab: int, layers: int) -> int:
    """Matrix-product FLOPs of one caption of ``L`` valid tokens through
    one direction of a post-norm transformer head: the visual projection,
    per layer causal self-attention (the i-th token attends to i keys),
    cross-attention to the visual tokens (their K/V projected once) and
    the FFN, then the tied output logits."""
    V = visual_tokens
    macs = V * visual_dim * H
    per_layer = (L * 3 * H * H + L * (L + 1) // 2 * H * 2 + L * H * H
                 + L * H * H + V * 2 * H * H + L * V * H * 2 + L * H * H
                 + L * 2 * H * F)
    macs += layers * per_layer + L * H * vocab
    return 2 * macs


def bicaptioning_train_flops(image_size: int, lengths: Iterable[int],
                             visual_tokens: int, visual_dim: int, H: int,
                             F: int, vocab: int, layers: int) -> int:
    """Model FLOPs of one update: forward × 3 (forward, and the backward's
    two products per forward product), no recomputation; the ResNet once
    per image and the head in both directions over each caption's valid
    length."""
    lengths = list(lengths)
    forward = len(lengths) * resnet50_forward_flops(image_size) + sum(
        2 * decoder_forward_flops(L, visual_tokens, visual_dim, H, F, vocab,
                                  layers) for L in lengths)
    return 3 * forward
