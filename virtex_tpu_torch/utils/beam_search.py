r"""
Autoregressive beam search, as a Python loop over steps.

Counterpart of ``virtex_tpu/utils/beam_search.py``
:class:`AutoRegressiveBeamSearch`, with the same semantics:

- batch-expanded (B·K) prefixes, beam-major (image i owns rows
  [i·K, (i+1)·K));
- step 0 peeled: all K beams start from the same token, so the first
  expansion takes the top-K of ONE distribution, with no repetition
  penalty;
- later steps: −10000 on each beam's last predicted token, EOS-absorbing
  finished beams (only EOS, at zero cost), per-node top-P, then the global
  top-K of the K·P candidates;
- the search state (e.g. KV caches) is reordered to follow the winners,
  gathered into a second state of the same shapes (the step function's
  ``spare``, or one made once a call) and swapped with it, so that a
  state its step updates in place lies in one of two fixed sets of
  tensors at every step;
- early stop when every beam ends in EOS (the step after the last is
  launched before the host learns it, and its result dropped).

Each step's selection, the penalty and the EOS latch through the top-K of
the candidates, is ``ops/beam_select.py``: one kernel launch a step on
CUDA (step 0's in a mode of its own), its plain version on the CPU. Top-k
takes the largest values first and breaks ties toward the lowest index, as
``lax.top_k`` does (:func:`topk`, a stable descending sort; ``torch.topk``
promises no tie order).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from virtex_tpu_torch.ops.beam_select import (  # noqa: F401 (topk)
    NEG_INF,
    beam_select,
    beam_select_first,
    topk,
)
from virtex_tpu_torch.utils.tracing import span

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]


def all_equal_later(x: torch.Tensor, value) -> Callable[[], bool]:
    """Start testing whether every element of ``x`` equals ``value``; the
    function returned waits for the answer: the search loops' host sync,
    a span of its own. On CUDA the answer is copied to pinned host memory
    behind an event, so the work launched between the start and the wait
    keeps the card busy while the host waits and turns round."""
    equal = (x == value).all()
    if x.device.type != "cuda":
        host, done = equal, None
    else:
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        host.copy_(equal, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def wait() -> bool:
        with span("host_sync", x):
            if done is not None:
                done.synchronize()
            return bool(host)
    return wait


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor in nested lists / tuples / dicts, and
    to the tensors at the same places in ``rest``, trees of one
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


class AutoRegressiveBeamSearch:
    r"""
    Args:
        eos_index: token latched once a beam finishes.
        max_steps: decode length.
        beam_size: K.
        per_node_beam_size: candidates drawn per live beam before
            re-ranking (reference default 2).
    """

    def __init__(self, eos_index: int, max_steps: int = 30,
                 beam_size: int = 5, per_node_beam_size: int = 2):
        self.eos_index = eos_index
        self.max_steps = max_steps
        self.beam_size = beam_size
        self.per_node_beam_size = per_node_beam_size or beam_size

    def search(self, start_tokens: torch.Tensor, step_fn: StepFn,
               state: Any, only_return_best: bool = True):
        r"""
        Args:
            start_tokens: (B,) int — usually ``[SOS]``.
            step_fn: ``(last_tokens (B·K,), position, state) →
                (logprobs (B·K, V), state)``; ``state`` is nested
                lists/dicts of tensors whose dim 0 is B·K. Its attribute
                ``spare``, where it has one, is a state of the same shapes
                that the reorder gathers into, the state's twin (its
                contents are overwritten); else one is made at the first
                reorder.
            only_return_best: return the best beam (B, T) or all (B, K, T).

        Returns:
            (predictions, scores): the start token is excluded, and
            finished beams are padded with EOS.
        """
        B = start_tokens.shape[0]
        K, P = self.beam_size, self.per_node_beam_size
        eos, device = self.eos_index, start_tokens.device

        start_flat = start_tokens.long().repeat_interleave(K)
        logprobs0, state = step_fn(start_flat, 0, state)
        V = logprobs0.shape[-1]
        k0 = min(K, V)  # degenerate tiny-vocab case: K may exceed V
        scores, last = beam_select_first(logprobs0, K, k0)        # (B, k0)
        if k0 < K:
            scores = torch.cat(
                [scores, scores.new_full((B, K - k0), NEG_INF)], dim=1)
            last = torch.cat([last, last[:, -1:].expand(B, K - k0)], dim=1)
        preds = torch.full((B, K, self.max_steps), eos, dtype=torch.long,
                           device=device)
        preds[:, :, 0] = last
        # The state needs no reorder: every beam's step-0 update is the
        # same start-token update.

        spare = getattr(step_fn, "spare", None)
        t = 1
        stop = all_equal_later(last, eos) if t < self.max_steps else None
        while stop is not None:
            last_flat = last.reshape(B * K)
            # Step t is launched before the wait for the stop test (is
            # every beam at EOS after step t − 1?), and is wasted when it
            # says stop: the card works while the host turns round.
            logprobs, state = step_fn(last_flat, t, state)
            if stop():
                break
            with span("beam_select", logprobs):
                scores, last, src = beam_select(logprobs, last_flat, scores,
                                                eos, P)

            with span("beam_reorder", src):
                preds = preds.reshape(B * K, -1)[src].reshape(B, K, -1)
                preds[:, :, t] = last
                if spare is None:
                    spare = tree_map(torch.empty_like, state)
                tree_map(lambda x, out: torch.index_select(x, 0, src,
                                                           out=out),
                         state, spare)
                state, spare = spare, state
            t += 1
            stop = all_equal_later(last, eos) if t < self.max_steps else None

        if only_return_best:
            return preds[:, 0, :], scores[:, 0]
        return preds, scores
