r"""
Validation step: the loss and its components on fixed weights.

Counterpart of ``virtex_tpu/engine/trainer.py`` :func:`make_eval_step`:
BatchNorm on running statistics, no dropout, fp32 results.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def make_eval_step(model) -> Callable[[Dict[str, torch.Tensor]],
                                      Dict[str, torch.Tensor]]:
    """``batch → {"loss", <component>: …}``, every value an fp32 scalar."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        out = model(batch)
        metrics = {"loss": out["loss"].float()}
        for k, v in out["loss_components"].items():
            metrics[k] = v.float()
        return metrics

    return eval_step
