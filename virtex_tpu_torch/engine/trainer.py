r"""
The train step.

Counterpart of ``virtex_tpu/engine/trainer.py`` :func:`make_train_step`.
One call is one optimizer update: the model runs in train mode (BatchNorm
on batch statistics, dropout on), its loss is backpropagated, and the
optimizer chain (:mod:`virtex_tpu_torch.optim.optimizer`) takes one step.

With ``accum_steps > 1`` every batch leaf carries a leading micro-step
axis ``(accum_steps, batch, ...)``, as in the JAX package. The micro-batches
run in sequence: each updates the BatchNorm running statistics in turn,
their gradients are summed into ``.grad`` and divided by ``accum_steps``,
and one update follows. Activation memory is one micro-batch's.

With a ``mesh`` (:func:`virtex_tpu_torch.parallel.create_mesh`) under a
process group, the step is the JAX package's step over a ``data`` mesh:
each rank holds its shard of every micro-batch, the group is published to
the ops around the forward and backward (synced BatchNorm, K4's sums
reduced between its stages, the losses' global denominators;
``ops/_mesh.py``), and after the micro-steps every ``.grad`` is summed
over the ranks in one flat buffer and divided by ``world × accum_steps``,
before the optimizer, so that clipping sees the global gradient's norm.
The metrics are the means over the ranks. Every rank then takes the same
update.

With ``model`` > 1 (tensor parallelism, ``parallel/mesh.py``) the "ranks"
above are the data group's, the ranks that hold this rank's shard of the
head: the gradient sum runs over them and divides by ``data ×
accum_steps``, and the metrics are their means. The model group is
published beside the data group; a replicated parameter's gradient is
whole on every rank of it (the Megatron pair in ``ops/_mesh.py``), a split
one's is this rank's shard, and the optimizer's clip sums the shards'
squares over the model group.

Dropout draws from ``generator`` (a :class:`torch.Generator` on the
model's device), which advances with every micro-step, so a run is
reproducible from its seed. Its bits are not the JAX package's threefry
bits.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from virtex_tpu_torch.ops._mesh import kernel_group
from virtex_tpu_torch.optim.optimizer import Optimizer
from virtex_tpu_torch.utils.distributed import all_reduce_sum
from virtex_tpu_torch.utils.tracing import span

Batch = Dict[str, torch.Tensor]


def make_train_step(model, optimizer: Optimizer, accum_steps: int = 1,
                    generator: Optional[torch.Generator] = None,
                    mesh=None
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``batch → {"loss", "grad_norm", <component>: …}``, each an fp32
    scalar on the model's device: the loss and its components averaged
    over the micro-batches (and the ranks), and the global norm of the
    averaged gradient before clipping."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    world = 1 if mesh is None else mesh.data

    # Taken once: walking the module tree for them costs host time every
    # update, and the optimizer holds these same tensors.
    params = list(model.parameters())
    where = params[0]  # the stream the spans time

    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        with span("train_step", where):
            return _step(batch)

    def _step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.train()
        for p in params:
            p.grad = None
        losses, comps = [], {}
        with kernel_group(group, model_group):
            for i in range(accum_steps):
                micro = (batch if accum_steps == 1
                         else {k: v[i] for k, v in batch.items()})
                out = model(micro, generator=generator)
                with span("backward", where):
                    out["loss"].backward()  # sums into .grad
                losses.append(out["loss"].detach().float())
                for k, v in out["loss_components"].items():
                    comps.setdefault(k, []).append(v.detach().float())
        grads = [p.grad for p in params if p.grad is not None]
        if group is not None:  # summed over the ranks in one flat buffer
            with span("grad_all_reduce", where):
                flat = all_reduce_sum(_flatten_dense_tensors(grads), "grads",
                                      group)
                torch._foreach_copy_(grads,
                                     _unflatten_dense_tensors(flat, grads))
        if world * accum_steps > 1:
            torch._foreach_div_(grads, float(world * accum_steps))
        grad_norm = optimizer.step()
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": grad_norm}
        metrics.update({k: torch.stack(v).mean() for k, v in comps.items()})
        if group is not None:
            names = [k for k in metrics if k != "grad_norm"]
            means = all_reduce_sum(torch.stack([metrics[k] for k in names]),
                                   "metrics", group) / world
            metrics.update(zip(names, means))
        return metrics

    return train_step
