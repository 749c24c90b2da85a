r"""
Checkpoints of a training run: save, prune, keep the best, resume.

Counterpart of ``virtex_tpu/engine/checkpointing.py``. A checkpoint is one
file, ``checkpoint_<iteration>.pth``, written by ``torch.save`` to a
temporary name and renamed into place. It holds

- ``"model"``: the model's state dict in the reference's ``.pth`` names
  (the names of the weight bridge, ``utils/weights.py``), on the CPU, so
  the JAX package's ``load_torch_checkpoint`` reads it as it reads a
  reference checkpoint;
- ``"optimizer"``: :meth:`Optimizer.state_dict`, keyed by parameter name;
- ``"iteration"``, ``"best_metric"`` and ``"best_iteration"``, and
  ``"loader"`` (``{"items_consumed"}``, the data stream's position).

:class:`CheckpointManager` keeps the ``keep_recent`` newest, and a rolling
``checkpoint_best.pth`` (higher metric is better) with a ``best.json``
sidecar naming the iteration it holds; a load heals a best copy that a
crash left stale. Every load goes through ``torch.load(weights_only=True)``,
which refuses a pickle that would run code.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Union

import torch

from virtex_tpu_torch.engine.train_state import TrainState

logger = logging.getLogger("virtex_tpu_torch")

_NUMBERED = re.compile(r"checkpoint_(\d+)\.pth")


def read_checkpoint(path: str, map_location: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, Any]:
    """A checkpoint file's contents, through the weights-only unpickler
    only."""
    return torch.load(path, map_location=map_location, weights_only=True)


def _cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    r"""
    Args:
        serialization_dir: where ``checkpoint_<iteration>.pth`` files go.
        keep_recent: how many numbered checkpoints to keep.
    """

    def __init__(self, serialization_dir: str, keep_recent: int = 100):
        self.serialization_dir = os.path.abspath(serialization_dir)
        os.makedirs(self.serialization_dir, exist_ok=True)
        self.keep_recent = keep_recent
        self.best_metric: Optional[float] = None
        self.best_iteration: Optional[int] = None

    def path(self, name) -> str:
        return os.path.join(self.serialization_dir, f"checkpoint_{name}.pth")

    def _numbered(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NUMBERED.fullmatch, os.listdir(self.serialization_dir)) if m)

    def latest(self) -> Optional[str]:
        numbered = self._numbered()
        return self.path(numbered[-1]) if numbered else None

    # -- save ------------------------------------------------------------------
    def step(self, state: TrainState, metric: Optional[float] = None,
             loader_state: Optional[Dict[str, int]] = None) -> str:
        """Save ``state`` as ``checkpoint_<state.iteration>.pth``; if
        ``metric`` beats the best so far, copy it to the best; prune."""
        iteration = int(state.iteration)
        if metric is not None and (self.best_metric is None
                                   or metric > self.best_metric):
            self.best_metric, self.best_iteration = float(metric), iteration
        payload = _cpu(state.state_dict())
        payload.update(
            best_metric=self.best_metric, best_iteration=self.best_iteration,
            loader={"items_consumed": int((loader_state or {}).get(
                "items_consumed", 0))})
        path = self.path(iteration)
        _atomic_save(payload, path)
        if self.best_iteration == iteration:
            self._copy_best(iteration)
        self._prune()
        return path

    def _copy_best(self, iteration: int) -> None:
        """checkpoint_<iteration> → checkpoint_best, then the sidecar."""
        best = self.path("best")
        shutil.copyfile(self.path(iteration), f"{best}.tmp")
        os.replace(f"{best}.tmp", best)
        sidecar = os.path.join(self.serialization_dir, "best.json")
        with open(f"{sidecar}.tmp", "w") as f:
            json.dump({"iteration": iteration, "metric": self.best_metric}, f)
        os.replace(f"{sidecar}.tmp", sidecar)

    def _prune(self) -> None:
        numbered = self._numbered()
        for it in numbered[: max(0, len(numbered) - self.keep_recent)]:
            os.remove(self.path(it))

    # -- load ------------------------------------------------------------------
    def load(self, path: str, state: TrainState, loader=None) -> int:
        """Restore ``state`` (model, optimizer, iteration) from ``path``,
        and the ``loader``'s stream position if given; returns the
        iteration. Also restores the best-so-far and heals a stale best
        copy."""
        device = next(state.model.parameters()).device
        ckpt = read_checkpoint(path, map_location=device)
        state.load_state_dict(ckpt)
        if loader is not None:
            loader.load_state_dict(ckpt["loader"])
        self.best_metric = ckpt.get("best_metric")
        self.best_iteration = ckpt.get("best_iteration")
        self._heal_best()
        return state.iteration

    def _heal_best(self) -> None:
        """If ``best.json`` does not name the restored best iteration (a
        crash between a save and its best copy), copy that checkpoint to
        the best again, if it still exists."""
        if self.best_iteration is None:
            return
        try:
            with open(os.path.join(self.serialization_dir, "best.json")) as f:
                held = json.load(f).get("iteration")
        except (OSError, ValueError):
            held = None
        if held != self.best_iteration and os.path.isfile(
                self.path(self.best_iteration)):
            self._copy_best(self.best_iteration)


def load_model_variables(path: str, model: torch.nn.Module) -> List[str]:
    """Partial load: the entries of a checkpoint's model state dict (or of
    a bare state dict) whose names and shapes match ``model``'s; the rest
    of ``model`` keeps its values. Returns the names ``model`` kept."""
    ckpt = read_checkpoint(path)
    saved = ckpt.get("model", ckpt)
    own = model.state_dict()
    kept = []
    with torch.no_grad():
        for name, value in own.items():
            src = saved.get(name)
            if src is None or tuple(src.shape) != tuple(value.shape):
                kept.append(name)
                continue
            value.copy_(src)
    if kept:
        logger.info(f"Partial load from {path}: kept {len(kept)} of "
                    f"{len(own)} entries (e.g. {kept[:3]})")
    return kept


def apply_backbone_weight_init(visual: torch.nn.Module, weight_init: str,
                               checkpoint_path: Optional[str]) -> None:
    """Initialise a visual backbone (``.cnn`` a ResNet) by the reference's
    ``--weight-init`` modes:

    - ``virtex``: the ``visual.*`` entries of one of the port's pretraining
      checkpoints;
    - ``torchvision``: a torchvision ResNet's state dict from a local
      ``.pth`` (bare, or under ``"state_dict"`` or ``"model"``); every
      entry of the trunk must be there (``fc.*`` is ignored);
    - ``random``: the fresh initialisation stays.

    ``imagenet`` (torchvision's download) is not supported: this port
    downloads nothing.
    """
    if weight_init == "random":
        return
    if weight_init not in ("virtex", "torchvision"):
        raise ValueError(f"unsupported weight init {weight_init!r}; the "
                         "port takes virtex, torchvision (a local .pth) and "
                         "random")
    if not checkpoint_path:
        raise ValueError(f"weight init {weight_init!r} needs a checkpoint "
                         "path")
    ckpt = read_checkpoint(checkpoint_path)
    if weight_init == "virtex":
        sd = {k[len("visual."):]: v for k, v in ckpt["model"].items()
              if k.startswith("visual.")}
        visual.load_state_dict(sd, strict=True)
    else:
        for key in ("state_dict", "model"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
        sd = {k: v for k, v in ckpt.items() if not k.startswith("fc.")}
        missing, unexpected = visual.cnn.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"{checkpoint_path}: not this trunk's weights "
                             f"(missing {missing[:3]}, unexpected "
                             f"{unexpected[:3]})")
    logger.info(f"Visual backbone from {checkpoint_path} ({weight_init})")
