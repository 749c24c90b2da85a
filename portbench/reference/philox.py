r"""
The attention dropout keep mask of kernels K1 and K2, worked out again in
torch integer ops: Philox4x32-10 keyed on (seed, batch row) and counted on
(head, query, key, 0); keep iff the first word, read unsigned, is at least
ceil(rate · 2³²). A frozen copy of the rule the kernels follow.
"""
from __future__ import annotations

import math

import torch

_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(m: int, x: torch.Tensor):
    """High and low words of m·x for 32-bit m and x, from 16-bit halves
    so that no int64 product overflows."""
    ml, mh = m & 0xFFFF, m >> 16
    xl, xh = x & 0xFFFF, x >> 16
    ll, lh, hl, hh = ml * xl, ml * xh, mh * xl, mh * xh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_MUL[0], c0)
        hi1, lo1 = _mulhilo32(_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _WEYL[0]) & _MASK32
        k1 = (k1 + _WEYL[1]) & _MASK32
    return c0, c1, c2, c3


def keep_mask(seed: int, B: int, N: int, Tq: int, Tk: int, rate: float,
              device) -> torch.Tensor:
    """(B, N, Tq, Tk) bool."""
    shape = (B, N, Tq, Tk)

    def axis(n, dim):
        view = [1, 1, 1, 1]
        view[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(
            view).expand(shape)

    b, h, i, j = (axis(n, d) for d, n in enumerate(shape))
    key0 = torch.full(shape, seed & _MASK32, dtype=torch.int64,
                      device=device)
    word = philox4x32_10((h, i, j, torch.zeros_like(key0)), (key0, b))[0]
    return word >= min(2**32 - 1, math.ceil(rate * 2**32))
