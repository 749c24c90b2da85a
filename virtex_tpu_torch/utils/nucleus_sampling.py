r"""
Nucleus (top-p) sampling, as a Python loop over steps.

Counterpart of ``virtex_tpu/utils/nucleus_sampling.py``
:class:`AutoRegressiveNucleusSampling`, with the same semantics:

- top-p on the raw fp32 logits (:func:`topp_drop`): sort descending, ties
  by index; drop a token where the softmax mass sorted strictly before it
  exceeds p; the top token is always kept;
- then −1e18 on each row's previous token (the repetition guard);
- one categorical draw per row, by Gumbel-max in fp32 (argmax of logits
  plus Gumbel noise), as ``jax.random.categorical`` draws, with the noise
  from an explicit :class:`torch.Generator`. Where the guard has left a row
  at −1e18 throughout, the noise vanishes in the rounding and the argmax
  takes token 0, as it does in the JAX package;
- EOS latched once ``t > 0``; an early stop when every row is latched
  (the step after the last is launched before the host learns it).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from virtex_tpu_torch.utils.beam_search import all_equal_later

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]
NEG_INF = -1e18


def topp_drop(logits: torch.Tensor, p: float) -> torch.Tensor:
    """(B, V) fp32 logits → bool (B, V) drop mask, in vocabulary order:
    True where the probability mass sorted strictly before the token
    (descending, stable) exceeds ``p``; never the top token."""
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True,
                                      stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    drop = (torch.cumsum(probs, dim=-1) - probs) > p
    drop[:, 0] = False
    return torch.empty_like(drop).scatter_(-1, order, drop)


def gumbel_argmax(logits: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of (B, V) fp32 logits:
    argmax(logits − log(−log u)), u uniform in [tiny, 1)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


class AutoRegressiveNucleusSampling:
    r"""
    Args:
        eos_index: token latched once a row emits it.
        max_steps: decode length.
        nucleus_size: p.
    """

    def __init__(self, eos_index: int, max_steps: int = 30,
                 nucleus_size: float = 0.9):
        self.eos_index = eos_index
        self.max_steps = max_steps
        self.nucleus_size = nucleus_size

    def search(self, start_tokens: torch.Tensor, step_fn: StepFn, state: Any,
               generator: Optional[torch.Generator]):
        r"""
        Args:
            start_tokens: (B,) int — usually ``[SOS]``.
            step_fn: ``(last_tokens (B,), position, state) → (logits (B, V),
                state)``.
            generator: draws the samples; on the logits' device.

        Returns:
            (predictions (B, max_steps), None): the start token excluded,
            rows padded with EOS after they finish.
        """
        if generator is None:
            raise ValueError("nucleus sampling draws from a torch.Generator "
                             "(generator=); none was given")
        B = start_tokens.shape[0]
        eos = self.eos_index
        preds = torch.full((B, self.max_steps), eos, dtype=torch.long,
                           device=start_tokens.device)
        last = start_tokens.long()
        t, stop = 0, None
        while t < self.max_steps:
            # As in beam search, step t is launched before the wait for
            # the stop test of step t − 1.
            logits, state = step_fn(last, t, state)
            if stop is not None and stop():
                break
            logits = logits.float()
            filtered = logits.masked_fill(
                topp_drop(logits, self.nucleus_size), NEG_INF)
            filtered.scatter_(-1, last[:, None], NEG_INF)
            sampled = gumbel_argmax(filtered, generator)
            if t > 0:
                sampled = torch.where(last == eos, eos, sampled)
            preds[:, t] = sampled
            last = sampled
            t += 1
            if t < self.max_steps:
                stop = all_equal_later(last, eos)
        return preds, None
