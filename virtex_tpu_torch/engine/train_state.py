r"""
What one checkpoint restores of a training run: the model, the optimizer,
the iteration, and the dropout stream.

Counterpart of ``virtex_tpu/engine/train_state.py`` :class:`TrainState`.
The JAX package's train step folds the step into one fixed key, so the
dropout bits of step ``i`` are a function of the seed and ``i``. The port
does the same: :func:`step_seed` derives each iteration's
``torch.Generator`` seed from ``(RANDOM_SEED, iteration)``, so the stream
is restored from the iteration alone and a resumed run draws the same
dropout bits as an unbroken one (no generator state is saved). Under data
parallelism the rank is part of the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from virtex_tpu_torch.optim.optimizer import Optimizer


def step_seed(seed: int, iteration: int, rank: int = 0) -> int:
    """The dropout generator's seed for ``iteration`` of a run seeded with
    ``seed``, on process ``rank`` of a data-parallel run: each rank draws
    its own masks and its own attention-kernel seeds (the counterpart of
    the JAX package's per-shard seed offset,
    ``virtex_tpu/ops/attention.py:259-262``). Rank 0's seed is the
    single-process run's."""
    key = (seed, iteration) if rank == 0 else (seed, iteration, rank)
    return int(np.random.SeedSequence(key).generate_state(
        1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    iteration: int = 0

    def state_dict(self) -> Dict[str, Any]:
        """The model's state dict (the reference's ``.pth`` names), the
        optimizer's, and the iteration."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "iteration": int(self.iteration)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])
