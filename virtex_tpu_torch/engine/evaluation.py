r"""
Validation step: the loss and its components on fixed weights.

Counterpart of ``virtex_tpu/engine/trainer.py`` :func:`make_eval_step`:
BatchNorm on running statistics, no dropout, fp32 results. With a
``mesh`` under a process group each rank scores its shard of a batch, the
group is published to the losses (their global denominators,
``ops/_mesh.py``), and the metrics are the means over the ranks. Under
tensor parallelism the ranks are the data group's, and the model group
is published to the sharded head.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from virtex_tpu_torch.ops._mesh import kernel_group
from virtex_tpu_torch.utils.distributed import all_reduce_sum


def make_eval_step(model, mesh=None) -> Callable[[Dict[str, torch.Tensor]],
                                                 Dict[str, torch.Tensor]]:
    """``batch → {"loss", <component>: …}``, every value an fp32 scalar."""
    group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        with kernel_group(group, model_group):
            out = model(batch)
        metrics = {"loss": out["loss"].float()}
        for k, v in out["loss_components"].items():
            metrics[k] = v.float()
        if group is not None:
            means = all_reduce_sum(torch.stack(list(metrics.values())),
                                   "metrics", group) / mesh.data
            metrics = dict(zip(metrics, means))
        return metrics

    return eval_step
