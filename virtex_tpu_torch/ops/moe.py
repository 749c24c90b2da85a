r"""
The routed experts of a mixture-of-experts layer: each token's rows sent
to its chosen experts, each expert's SwiGLU, the results weighted and
summed back per token.

``routed_experts(x, choice, weights, gate_up, down)``: x (N, H); choice
(N, k) expert ids and weights (N, k) fp32 combine weights; gate_up (E, 2F,
H), the gate's F rows above the up projection's; down (E, H, F). Returns
(N, H) in x's dtype: Σ_j weights[n, j] · down_e(silu(gate_e(x_n)) ·
up_e(x_n)), e = choice[n, j].

On CUDA the dispatch has a static size: the N·k assignments are sorted by
expert on the device (a stable sort), each expert's rows end at an offset
found on the device (:func:`dispatch`), and the projections are two
grouped GEMMs over those offsets (``torch._grouped_mm``): gate and up as
one launch, the SiLU product scaled by the combine weights, then down. No
``.item()``, no ``.tolist()`` and no shape that depends on the routing,
so a CUDA graph captures the layer whole. Each grouped launch is counted
in ``ops/_launch.py`` under :data:`KEY` and noted (rows, k, E, H, F,
projection), ``projection`` ``"gate_up"`` or ``"down"``, while a profiler
records, and again at each replay of a graph that captured it.

Off CUDA the plain per-expert loop: every expert over every row, each
row's result weighted by its combine weight for that expert (0 where the
expert was not chosen), which has no data-dependent shape either.
:func:`grouped_experts` runs the grouped path on any device, with
:func:`grouped_mm`'s plain loop over the groups off CUDA, for the tests.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from virtex_tpu_torch.ops._launch import count

KEY = ("moe_experts", "grouped_mm")  # the grouped launches' count key


def _check(x, choice, weights, gate_up, down) -> None:
    N, H = x.shape
    E, two_f, H2 = gate_up.shape
    if (choice.shape != weights.shape or choice.shape[0] != N
            or H2 != H or two_f % 2 or down.shape != (E, H, two_f // 2)):
        raise ValueError(
            f"routed_experts: want x (N, H), choice = weights (N, k), "
            f"gate_up (E, 2F, H), down (E, H, F); got {tuple(x.shape)}, "
            f"{tuple(choice.shape)}, {tuple(weights.shape)}, "
            f"{tuple(gate_up.shape)}, {tuple(down.shape)}")


def dispatch(choice: torch.Tensor, experts: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, ends): ``order`` (N·k,) the assignments (flat indices into
    ``choice``) sorted by expert, stably; ``ends`` (E,) int32, where each
    expert's rows end in that order. Both on the device, of static size."""
    flat = choice.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(1, experts + 1, device=choice.device,
                          dtype=flat.dtype)
    ends = torch.searchsorted(flat[order], bounds).to(torch.int32)
    return order, ends


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """(M, K) rows grouped by ``ends`` times (E, N, K) weights, each group
    by its own: (M, N). ``torch._grouped_mm`` on CUDA; off CUDA a plain
    loop over the groups (the offsets read on the host)."""
    if a.device.type == "cuda":
        return torch._grouped_mm(a, b.transpose(-2, -1), offs=ends)
    out = a.new_empty((a.shape[0], b.shape[1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        out[start:end] = a[start:end] @ b[e].t()
        start = end
    return out


def grouped_experts(x, choice, weights, gate_up, down) -> torch.Tensor:
    """:func:`routed_experts` through the sorted dispatch and two grouped
    GEMMs (see the module docstring)."""
    _check(x, choice, weights, gate_up, down)
    (N, H), k = x.shape, choice.shape[1]
    E, two_f, _ = gate_up.shape
    Fw = two_f // 2
    order, ends = dispatch(choice, E)
    rows = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    cuda = x.device.type == "cuda"
    h = grouped_mm(rows, gate_up, ends)
    if cuda:
        count(KEY, note=(N, k, E, H, Fw, "gate_up"))
    scale = weights.reshape(-1).index_select(0, order)[:, None]
    a = (F.silu(h[:, :Fw].float()) * h[:, Fw:].float() * scale).to(x.dtype)
    y = grouped_mm(a, down, ends)
    if cuda:
        count(KEY, note=(N, k, E, H, Fw, "down"))
    out = torch.empty_like(y).index_copy_(0, order, y)
    return out.view(N, k, H).sum(dim=1, dtype=torch.float32).to(x.dtype)


def looped_experts(x, choice, weights, gate_up, down) -> torch.Tensor:
    """:func:`routed_experts` as the plain per-expert loop: every expert
    over every row, weighted by each row's combine weight for it."""
    _check(x, choice, weights, gate_up, down)
    E, two_f, _ = gate_up.shape
    Fw = two_f // 2
    dense = torch.zeros((x.shape[0], E), dtype=torch.float32,
                        device=x.device).scatter_(1, choice, weights.float())
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        g, u = (x @ gate_up[e].t()).float().split(Fw, dim=-1)
        y = (F.silu(g) * u).to(x.dtype) @ down[e].t()
        out += dense[:, e:e + 1] * y.float()
    return out.to(x.dtype)


def routed_experts(x, choice, weights, gate_up, down) -> torch.Tensor:
    """The grouped launches on CUDA, the plain loop elsewhere."""
    if x.device.type == "cuda":
        return grouped_experts(x, choice, weights, gate_up, down)
    return looped_experts(x, choice, weights, gate_up, down)
