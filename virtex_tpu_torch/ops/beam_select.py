r"""
Beam search's selection at one step, and its plain version.

``beam_select(logprobs, last, scores, eos_index, per_node)``: logprobs
(B·K, V) of B images' K beams, beam-major (image i owns rows [i·K,
(i+1)·K)); last (B·K,) or (B, K), each beam's last token; scores (B, K),
each beam's summed log-probability. A beam whose last token is EOS may only
go on with EOS, at no cost (the EOS latch); any other beam's last token
takes ``REPETITION_PENALTY``. Each beam keeps its top ``per_node`` (P)
tokens, each a candidate scored by the beam's score plus its log-prob, and
each image keeps the top K of its K·P candidates. Returns the new scores
(B, K) fp32, the new last tokens (B, K) int64 and each winner's source row
(B·K,) int64, i·K plus its candidate's flat index k·P + p over P.

``beam_select_first(logprobs, beam_size, k)``: step 0, where an image's
beams are copies of one start: the top ``k`` of row i·K of each image, as
(values (B, k) fp32, tokens (B, k) int64).

Top-k takes the largest values first and breaks ties toward the lowest
index, as ``lax.top_k`` does, and −0.0 ties with +0.0: :func:`topk`, a
stable descending sort (``torch.topk`` promises no tie order).

Replaces no TPU kernel: the JAX package selects in plain jnp
(``virtex_tpu/utils/beam_search.py _topk_small``). On CUDA both functions
launch ``csrc/beam_select.cu``, which reads each beam row once where it
lies (a finished beam's not at all), keeps no full-size intermediate and
selects the plain version's values, tokens and order bit for bit on every
NaN-free input; it takes K and P (or k) up to :data:`MAX_KEEP`, and raises
beyond. ``ops/_launch.py`` counts its launches under ``("beam_select",
"vector")`` and, while a profiler records, notes each one's (rows read, V,
values kept a row) under ``"beam_select"`` in the store of
``utils/tracing.py``. On the CPU they compute :func:`beam_select_reference`
and :func:`beam_select_first_reference`, the search's sort path as it was.
"""
from __future__ import annotations

from typing import Tuple

import torch

from virtex_tpu_torch.ops._launch import launch

NEG_INF = -1e18
REPETITION_PENALTY = -10000.0
MAX_KEEP = 16  # the most beams, and values kept a row, the kernel takes
KEY = ("beam_select", "vector")  # the launches' count key


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lowest index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_select_reference(logprobs: torch.Tensor, last: torch.Tensor,
                          scores: torch.Tensor, eos_index: int,
                          per_node: int):
    """Plain PyTorch selection (see the module docstring)."""
    B, K = scores.shape
    P, eos = per_node, eos_index
    V, device = logprobs.shape[-1], logprobs.device
    last_flat = last.reshape(B * K)
    after_end = torch.full((V,), NEG_INF, device=device)
    after_end[eos] = 0.0
    rows = torch.arange(B * K, device=device)
    base = (torch.arange(B, device=device) * K)[:, None]

    logprobs = logprobs.float().clone()
    logprobs[rows, last_flat] += REPETITION_PENALTY
    finished = (last_flat == eos)[:, None]
    logprobs = torch.where(finished, after_end, logprobs)

    node_lp, node_ix = topk(logprobs, P)                      # (B·K, P)
    cand = (scores.reshape(B * K)[:, None] + node_lp).reshape(B, K * P)
    scores, flat_ix = topk(cand, K)                           # (B, K)
    src = (base + torch.div(flat_ix, P, rounding_mode="floor"))
    src = src.reshape(B * K)                                  # rows
    last = node_ix.reshape(B, K * P).gather(1, flat_ix)
    return scores, last, src


def beam_select_first_reference(logprobs: torch.Tensor, beam_size: int,
                                k: int):
    """Plain PyTorch step-0 selection (see the module docstring)."""
    B = logprobs.shape[0] // beam_size
    lp0 = logprobs.reshape(B, beam_size, -1)[:, 0, :].float()
    return topk(lp0, k)


def _rows(logprobs: torch.Tensor, beam_size: int, keep: int) -> int:
    """B, after checking logprobs (B·K, V) and the counts."""
    if logprobs.dim() != 2:
        raise ValueError(f"beam_select: want log-probs (B·K, V); got "
                         f"{tuple(logprobs.shape)}")
    R, V = logprobs.shape
    if beam_size < 1 or R % beam_size or R == 0:
        raise ValueError(f"beam_select: {R} rows are not {beam_size} beams "
                         "an image")
    if not 1 <= keep <= V:
        raise ValueError(f"beam_select: cannot keep {keep} of {V} values "
                         "a row")
    return R // beam_size


def _device(logprobs: torch.Tensor) -> bool:
    """Whether to launch the kernel: on CUDA; the plain version on the
    CPU."""
    if logprobs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"beam_select: no kernel for {logprobs.device}")
    return logprobs.device.type == "cuda"


def _operand(logprobs: torch.Tensor) -> torch.Tensor:
    """fp32 with unit stride along V: the log-probs where they lie when
    they are so, as the search's are."""
    if logprobs.dtype != torch.float32:
        logprobs = logprobs.float()
    return logprobs if logprobs.stride(1) == 1 else logprobs.contiguous()


def _within_limits(beams: int, keep: int) -> None:
    if beams > MAX_KEEP or keep > MAX_KEEP:
        raise ValueError(f"beam_select: no kernel for {beams} beams keeping "
                         f"{keep} a row (built for up to {MAX_KEEP} of "
                         "each)")


def beam_select(logprobs: torch.Tensor, last: torch.Tensor,
                scores: torch.Tensor, eos_index: int, per_node: int):
    r"""One step's selection (see the module docstring): the kernel on
    CUDA, the plain version on the CPU."""
    if scores.dim() != 2:
        raise ValueError(f"beam_select: want scores (B, K); got "
                         f"{tuple(scores.shape)}")
    B, K = scores.shape
    if _rows(logprobs, K, per_node) != B or last.numel() != B * K:
        raise ValueError(f"beam_select: log-probs {tuple(logprobs.shape)}, "
                         f"last {tuple(last.shape)} and scores "
                         f"{tuple(scores.shape)} disagree on B·K")
    V = logprobs.shape[1]
    if not 0 <= eos_index < V:
        raise ValueError(f"beam_select: EOS {eos_index} outside [0, {V})")
    if len({logprobs.device, last.device, scores.device}) != 1:
        raise ValueError("beam_select: log-probs, last and scores on "
                         "different devices")
    if not _device(logprobs):
        return beam_select_reference(logprobs, last, scores, eos_index,
                                     per_node)
    _within_limits(K, per_node)
    x = _operand(logprobs)
    last = last.reshape(B * K).to(torch.int64).contiguous()
    scores = scores.to(torch.float32).contiguous()
    new_scores = torch.empty((B, K), dtype=torch.float32, device=x.device)
    new_last = torch.empty((B, K), dtype=torch.int64, device=x.device)
    src = torch.empty((B * K,), dtype=torch.int64, device=x.device)
    launch(KEY, "virtex_beam_select", x,
           x.data_ptr(), last.data_ptr(), scores.data_ptr(),
           new_scores.data_ptr(), new_last.data_ptr(), src.data_ptr(),
           B, K, V, K * x.stride(0), x.stride(0), per_node, K, eos_index,
           REPETITION_PENALTY, NEG_INF, note=(B * K, V, per_node))
    return new_scores, new_last, src


def beam_select_first(logprobs: torch.Tensor, beam_size: int, k: int):
    r"""Step 0's selection (see the module docstring): the kernel on CUDA,
    the plain version on the CPU."""
    B = _rows(logprobs, beam_size, k)
    if not _device(logprobs):
        return beam_select_first_reference(logprobs, beam_size, k)
    _within_limits(1, k)
    x = _operand(logprobs)
    V = x.shape[1]
    values = torch.empty((B, k), dtype=torch.float32, device=x.device)
    tokens = torch.empty((B, k), dtype=torch.int64, device=x.device)
    launch(KEY, "virtex_beam_select", x,
           x.data_ptr(), None, None, values.data_ptr(), tokens.data_ptr(),
           None, B, 1, V, beam_size * x.stride(0), x.stride(0), k, 0, -1,
           REPETITION_PENALTY, NEG_INF, note=(B, V, k))
    return values, tokens
