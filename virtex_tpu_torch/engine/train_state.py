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
parallelism the data rank is part of the seed; the ranks of one model
group share it, so their generators stay in lockstep.

Under tensor parallelism (``mesh.model`` > 1) :meth:`TrainState.state_dict`
gathers the model's and the optimizer's split tensors to full ones over
the model group (every rank calls it), and :meth:`load_state_dict` takes
full tensors and keeps this rank's shard, so a checkpoint holds the full
model at any ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from virtex_tpu_torch.optim.optimizer import Optimizer
from virtex_tpu_torch.parallel.mesh import (
    Mesh,
    gather_state_dict,
    shard_state_dict,
)


def step_seed(seed: int, iteration: int, rank: int = 0) -> int:
    """The dropout generator's seed for ``iteration`` of a run seeded with
    ``seed``, on data rank ``rank`` (``Mesh.data_rank``) of a
    data-parallel run: each data shard draws its own masks and its own
    attention-kernel seeds (the counterpart of the JAX package's per-shard
    seed offset, ``virtex_tpu/ops/attention.py:259-262``), and the ranks
    of one model group draw one stream. Rank 0's seed is the
    single-process run's."""
    key = (seed, iteration) if rank == 0 else (seed, iteration, rank)
    return int(np.random.SeedSequence(key).generate_state(
        1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    iteration: int = 0
    mesh: Optional[Mesh] = None

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.model > 1

    def state_dict(self) -> Dict[str, Any]:
        """The model's state dict (the reference's ``.pth`` names, full
        tensors), the optimizer's, and the iteration."""
        model = self.model.state_dict()
        if self._sharded():
            model = gather_state_dict(model, self.mesh)
        return {"model": model, "optimizer": self.optimizer.state_dict(),
                "iteration": int(self.iteration)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        model = state["model"]
        if self._sharded():
            model = shard_state_dict(model, self.mesh)
        self.model.load_state_dict(model, strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])
