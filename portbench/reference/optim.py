r"""
The published optimizer chain of VirTex's pretraining, in plain PyTorch on
a dict of fp32 parameters: clip the gradients by their global norm, SGD
with momentum and coupled weight decay (no decay for the textual
embedding's and decoder's norms and biases), the learning rate of the
CNN or of the rest times a linear-warmup-then-cos² schedule, Lookahead
(every k-th update lands on slow + α·(fast − slow)).

Which names decay: ``OPTIM.NO_DECAY`` matched (``re.match``) against the
parameter's name, where the backward direction's decoder is named
``textual.backward_transformer`` (as the configuration's names are read
in this repository), so its norms and biases do decay.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float
    cnn_lr: float
    momentum: float
    weight_decay: float
    no_decay: str
    clip: float
    warmup: int
    total: int
    lookahead_k: int
    lookahead_alpha: float


def decays(name: str, no_decay: str) -> bool:
    jax_like = name.replace("backward_textual.transformer",
                            "textual.backward_transformer")
    return re.match(no_decay, jax_like) is None


def lr_of(name: str, h: Hyper) -> float:
    return h.cnn_lr if "cnn" in name else h.lr


def schedule(step: int, h: Hyper) -> float:
    if step < h.warmup:
        return step / max(h.warmup, 1)
    frac = (step - h.warmup) / max(h.total - h.warmup, 1)
    return math.cos(min(max(frac, 0.0), 1.0) * math.pi / 2.0) ** 2


class Chain:
    """The chain's state over ``params`` (name → tensor), its step and
    Lookahead counts starting at ``start``."""

    def __init__(self, params: Dict[str, torch.Tensor], h: Hyper,
                 start: int = 0):
        self.h = h
        self.names: List[str] = list(params)
        self.trace = {n: torch.zeros_like(p) for n, p in params.items()}
        self.slow = {n: p.detach().clone() for n, p in params.items()}
        self.step_count = self.lookahead_count = start
        self.last_norm, self.last_sync = 0.0, False  # of the last update

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; return each leaf's clipped
        gradient (the gradient as the chain takes it, before decay)."""
        h = self.h
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values())).float()
        coef = 1.0 if float(norm) < h.clip else h.clip / float(norm)
        mult = schedule(self.step_count, h)
        self.step_count += 1
        self.lookahead_count += 1
        sync = self.lookahead_count % h.lookahead_k == 0
        self.last_norm, self.last_sync = float(norm), sync
        clipped = {}
        for n in self.names:
            p, g = params[n], grads[n]
            u = g * coef
            clipped[n] = u
            if decays(n, h.no_decay):
                u = u + h.weight_decay * p
            self.trace[n] = h.momentum * self.trace[n] + u
            update = -lr_of(n, h) * mult * self.trace[n]
            if sync:
                fast = p + update
                self.slow[n] = self.slow[n] + h.lookahead_alpha * (
                    fast - self.slow[n])
                p.copy_(self.slow[n])
            else:
                p.add_(update)
        return clipped
