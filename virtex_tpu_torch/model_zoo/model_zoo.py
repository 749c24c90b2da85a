r"""
Model zoo: build any pretraining config of ``configs/`` and, if asked,
load its pretrained weights from a local directory of ``.pth`` files.

Counterpart of ``virtex_tpu/model_zoo/model_zoo.py``: the same 16 entries
over the task, width, depth and backbone ablations, the same
``$VIRTEX_TPU_CONFIGS_DIR`` and ``$VIRTEX_TPU_ZOO_DIR`` (one directory of
``<name>.pth`` files serves both packages) and the same ``fetch``. The
port's differences:

- :func:`get` returns ``(model, config)``: the model holds its weights,
  so there is no separate ``variables``;
- the model is built on the card unless ``device`` says otherwise, and
  without a card :func:`get` raises;
- a ``.pth`` is the reference's ``{"model": state_dict}`` in the port's
  own names, so it loads without a converter, by
  :func:`~virtex_tpu_torch.engine.checkpointing.load_model_variables`
  (a partial load: what the file lacks keeps its initialisation);
- an orbax checkpoint directory is refused: the JAX package's
  ``scripts/export_torch_checkpoint.py`` turns one into a ``.pth``.

    >>> model, config = get("width_ablations/bicaptioning_R_50_L1_H1024.yaml",
    ...                     pretrained=True)
"""
from __future__ import annotations

import hashlib
import os
import urllib.parse
import urllib.request
from typing import List, Optional, Tuple, Union

import torch

from virtex_tpu_torch.config import Config
from virtex_tpu_torch.engine.checkpointing import load_model_variables
from virtex_tpu_torch.factories import PretrainingModelFactory

ZOO_DIR_ENV = "VIRTEX_TPU_ZOO_DIR"
CACHE_DIR_ENV = "VIRTEX_TPU_CACHE_DIR"
CONFIGS_DIR_ENV = "VIRTEX_TPU_CONFIGS_DIR"
_URL_SCHEMES = ("https://", "http://", "file://")

# config path (relative to configs/) → zoo checkpoint basename
_MODEL_ZOO_CONFIGS = {
    # Pretraining task ablations
    "task_ablations/bicaptioning_R_50_L1_H2048.yaml": "bicaptioning_R_50_L1_H2048",
    "task_ablations/captioning_R_50_L1_H2048.yaml": "captioning_R_50_L1_H2048",
    "task_ablations/token_classification_R_50.yaml": "token_classification_R_50",
    "task_ablations/multilabel_classification_R_50.yaml": "multilabel_classification_R_50",
    "task_ablations/masked_lm_R_50_L1_H2048.yaml": "masked_lm_R_50_L1_H2048",
    # Width ablations
    "width_ablations/bicaptioning_R_50_L1_H512.yaml": "bicaptioning_R_50_L1_H512",
    "width_ablations/bicaptioning_R_50_L1_H768.yaml": "bicaptioning_R_50_L1_H768",
    "width_ablations/bicaptioning_R_50_L1_H1024.yaml": "bicaptioning_R_50_L1_H1024",
    "width_ablations/bicaptioning_R_50_L1_H2048.yaml": "bicaptioning_R_50_L1_H2048",
    # Depth ablations
    "depth_ablations/bicaptioning_R_50_L1_H1024.yaml": "bicaptioning_R_50_L1_H1024",
    "depth_ablations/bicaptioning_R_50_L2_H1024.yaml": "bicaptioning_R_50_L2_H1024",
    "depth_ablations/bicaptioning_R_50_L3_H1024.yaml": "bicaptioning_R_50_L3_H1024",
    "depth_ablations/bicaptioning_R_50_L4_H1024.yaml": "bicaptioning_R_50_L4_H1024",
    # Backbone ablations
    "backbone_ablations/bicaptioning_R_50_L1_H1024.yaml": "bicaptioning_R_50_L1_H1024",
    "backbone_ablations/bicaptioning_R_50W2X_L1_H1024.yaml": "bicaptioning_R_50W2X_L1_H1024",
    "backbone_ablations/bicaptioning_R_101_L1_H1024.yaml": "bicaptioning_R_101_L1_H1024",
}


def _configs_root() -> str:
    """``$VIRTEX_TPU_CONFIGS_DIR``, else the repository's ``configs/``."""
    return os.environ.get(CONFIGS_DIR_ENV) or os.path.join(os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs")


def get(config_path: str, pretrained: bool = False,
        checkpoint_path: Optional[str] = None,
        overrides: Optional[list] = None,
        device: Union[str, torch.device, None] = None
        ) -> Tuple[torch.nn.Module, Config]:
    r"""Build the model of a zoo config, on ``device`` (default: the
    card; without one this raises unless ``device="cpu"``).

    Args:
        config_path: relative to the configs root (e.g.
            ``"width_ablations/bicaptioning_R_50_L1_H1024.yaml"``) or
            absolute.
        pretrained: load weights, from ``checkpoint_path`` or else from
            ``$VIRTEX_TPU_ZOO_DIR``.
        checkpoint_path: a ``.pth`` file or an ``http(s)://``/``file://``
            URL of one.
        overrides: dotted-key value pairs over the config.

    Returns:
        ``(model, config)``: the model randomly initialised unless
        pretrained, in train mode as the factory builds it.
    """
    if not os.path.isabs(config_path):
        config_path = os.path.join(_configs_root(), config_path)
    _C = Config(config_path, overrides or [])
    model = PretrainingModelFactory.from_config(_C, device or "cuda")
    if pretrained:
        path = checkpoint_path or _zoo_checkpoint_path(config_path)
        if path.startswith(_URL_SCHEMES):
            path = fetch(path)
        _load_weights(path, model)
    return model, _C


def fetch(url: str, sha256: Optional[str] = None,
          cache_dir: Optional[str] = None) -> str:
    """Download ``url`` into the cache once and return the file's path.

    The cache is ``cache_dir``, else ``$VIRTEX_TPU_CACHE_DIR``, else
    ``~/.cache/virtex_tpu``, one file per URL. A ``#sha256=<hex>``
    fragment (or ``sha256``) is checked after the download and on every
    cache hit; a mismatch deletes the file and raises. ``file://`` URLs
    serve a local mirror."""
    parsed = urllib.parse.urlparse(url)
    if parsed.fragment.startswith("sha256="):
        sha256 = parsed.fragment[len("sha256="):]
        url = url.split("#", 1)[0]
    cache_dir = cache_dir or os.environ.get(CACHE_DIR_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "virtex_tpu")
    os.makedirs(cache_dir, exist_ok=True)
    digest = hashlib.sha256(url.encode()).hexdigest()[:16]
    target = os.path.join(cache_dir,
                          f"{digest}_{os.path.basename(parsed.path)}")

    def check(path: str) -> None:
        if not sha256:
            return
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != sha256:
            os.remove(path)
            raise RuntimeError(
                f"checksum mismatch for {url}: expected {sha256}, got "
                f"{h.hexdigest()} (the cached file was removed)")

    if not os.path.exists(target):
        tmp = target + ".part"
        with urllib.request.urlopen(url, timeout=600) as r, \
                open(tmp, "wb") as f:
            for chunk in iter(lambda: r.read(1 << 20), b""):
                f.write(chunk)
        os.replace(tmp, target)
    check(target)
    return target


def _zoo_checkpoint_path(config_path: str) -> str:
    """``$VIRTEX_TPU_ZOO_DIR/<name>`` or ``<name>.pth`` for the config's
    zoo name (its file name if it is not a zoo entry), or that name's
    ``.pth`` under a URL base."""
    zoo_dir = os.environ.get(ZOO_DIR_ENV)
    if not zoo_dir:
        raise RuntimeError(
            f"pretrained=True needs ${ZOO_DIR_ENV} pointing at a directory "
            "of zoo checkpoints (orbax dirs or reference .pth files), or "
            "an http(s):// base URL hosting '<name>.pth' files.")
    rel = os.path.relpath(config_path, _configs_root()).replace(os.sep, "/")
    base = _MODEL_ZOO_CONFIGS.get(rel) or os.path.splitext(
        os.path.basename(config_path))[0]
    if zoo_dir.startswith(_URL_SCHEMES):
        return fetch(f"{zoo_dir.rstrip('/')}/{base}.pth")
    for cand in (os.path.join(zoo_dir, base),
                 os.path.join(zoo_dir, base + ".pth")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"No zoo checkpoint for {base!r} in {zoo_dir}")


def _load_weights(path: str, model: torch.nn.Module) -> List[str]:
    """Load a ``.pth`` into ``model`` (a partial load); returns the names
    the file did not give."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); the PyTorch port reads .pth files: convert it with "
            "the JAX package's scripts/export_torch_checkpoint.py")
    return load_model_variables(path, model)
