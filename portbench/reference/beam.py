r"""
VirTex's caption decoding by beam search, and the score of a caption
under it, in plain PyTorch.

The decoder sees the caption the way the published checkpoints were
decoded ("reference" prefix mode): the first step reads the start token
alone at position 0; every later step reads the tokens generated so far,
the start token dropped, at positions 0, 1, … with a causal mask and no
padding mask. Beam search (K beams, 2 candidates per beam, the published
rule): step 0 takes the top K of one distribution; each later step adds
−10000 to the log-probability of repeating a beam's last token, lets a
finished beam (last token EOS) continue only with EOS at no cost, takes
each beam's top 2, then the top K of the K·2 candidates by summed
log-probability, ties to the lowest index; it stops when every beam of
the batch has ended or after ``steps`` tokens.

Every token of a caption that beam search returns lies among the top K of
the first distribution (its first token) or among the top 2 of its
parent's next-token distribution, the repetition penalty applied (every
later token), since the returned caption's prefix is the parent's: the
token gap is how far, in nats, a token's log-probability lies below that
bound, and EOS after EOS is its only valid continuation. Every step is a
full forward pass over the caption so far: no cache.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

REPETITION_PENALTY = -10000.0
INVALID = -1e18

# (tokens (R, t) long) → (R, vocab) fp32 log-probabilities of the next one
NextFn = Callable[[torch.Tensor], torch.Tensor]


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _inputs(sos: int, preds: torch.Tensor, t: int) -> torch.Tensor:
    if t == 0:
        return torch.full((preds.shape[0], 1), sos, dtype=torch.long,
                          device=preds.device)
    return preds[:, :t]


def beam_search(next_fn: NextFn, B: int, K: int, steps: int, sos: int,
                eos: int, device, per_node: int = 2) -> torch.Tensor:
    """(B, steps) best captions, the start token excluded."""
    preds = torch.full((B * K, steps), eos, dtype=torch.long, device=device)
    lp0 = next_fn(_inputs(sos, preds, 0)).reshape(B, K, -1)[:, 0]
    V = lp0.shape[-1]
    scores, last = _topk(lp0, K)
    preds = preds.view(B, K, steps)
    preds[:, :, 0] = last
    after_end = torch.full((V,), INVALID, device=device)
    after_end[eos] = 0.0
    rows = torch.arange(B * K, device=device)
    base = (torch.arange(B, device=device) * K)[:, None]
    t = 1
    while t < steps and not bool((last == eos).all()):
        flat = preds.reshape(B * K, steps)
        last_flat = last.reshape(B * K)
        lp = next_fn(_inputs(sos, flat, t)).clone()
        lp[rows, last_flat] += REPETITION_PENALTY
        lp = torch.where((last_flat == eos)[:, None], after_end, lp)
        node_lp, node_ix = _topk(lp, per_node)
        cand = (scores.reshape(B * K)[:, None] + node_lp).reshape(
            B, K * per_node)
        scores, flat_ix = _topk(cand, K)
        src = (base + torch.div(flat_ix, per_node, rounding_mode="floor")
               ).reshape(B * K)
        last = node_ix.reshape(B, K * per_node).gather(1, flat_ix)
        preds = flat[src].reshape(B, K, steps)
        preds[:, :, t] = last
        t += 1
    return preds[:, 0, :]


def token_gaps(next_fn: NextFn, captions: torch.Tensor, sos: int, eos: int,
               K: int, per_node: int = 2) -> torch.Tensor:
    """(R, steps) token gaps of (R, steps) captions: how far each token's
    log-probability lies below the K-th best of the first distribution
    (step 0) or the ``per_node``-th best of its parent's distribution with
    the repetition penalty (later steps); 0 inside, 1e18 for a token
    other than EOS after EOS."""
    R, steps = captions.shape
    c = captions.long()
    rows = torch.arange(R, device=c.device)
    out = torch.zeros(R, steps, dtype=torch.float64, device=c.device)
    for t in range(steps):
        lp = next_fn(_inputs(sos, c, t)).double().clone()
        tok = c[:, t]
        if t > 0:
            lp[rows, c[:, t - 1]] += REPETITION_PENALTY
        rank = K if t == 0 else per_node
        edge = _topk(lp, rank)[0][:, -1]
        gap = (edge - lp[rows, tok]).clamp_min(0.0)
        if t > 0:
            ended = c[:, t - 1] == eos
            gap = torch.where(ended, torch.where(
                tok == eos, 0.0, -INVALID), gap)
        out[:, t] = gap
    return out


def scores(next_fn: NextFn, captions: torch.Tensor, sos: int,
           eos: int) -> torch.Tensor:
    """(R,) the score beam search gives each of (R, steps) captions: the
    sum of its tokens' log-probabilities, the repetition penalty applied,
    EOS after EOS at no cost."""
    R, steps = captions.shape
    c = captions.long()
    rows = torch.arange(R, device=c.device)
    out = torch.zeros(R, dtype=torch.float64, device=c.device)
    for t in range(steps):
        lp = next_fn(_inputs(sos, c, t)).double().clone()
        if t > 0:
            lp[rows, c[:, t - 1]] += REPETITION_PENALTY
            lp[c[:, t - 1] == eos] = 0.0
        out += lp[rows, c[:, t]]
    return out
