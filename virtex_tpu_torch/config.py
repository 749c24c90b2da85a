r"""
The model and optimizer descriptions that the port reads.

Counterpart of :class:`virtex_tpu.config.Config`, cut to the keys that
building, running and training the pretext-task models need. It reads no
yaml: :meth:`ModelSpec.flagship` builds the flagship
``bicaptioning_R_50_L1_H1024`` in code, :meth:`ModelSpec.task_ablation`
and :meth:`OptimSpec.task_ablation` build the five
``configs/task_ablations/*.yaml``, :class:`OptimSpec` holds the ``OPTIM.*``
keys with the JAX package's defaults (the flagship trains with them), and
the ``from_config`` methods copy the keys out of a
``virtex_tpu.config.Config`` (duck-typed, so this module imports nothing
of the JAX package).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Tuple

import torch

# ``transdec_{post,pre}norm::L{l}_H{h}_A{a}_F{f}`` — the grammar of
# virtex_tpu/factories.py TextualHeadFactory.NAME_RE.
TEXTUAL_NAME_RE = re.compile(
    r"transdec_(?P<norm>post|pre)norm::"
    r"L(?P<L>\d+)_H(?P<H>\d+)_A(?P<A>\d+)_F(?P<F>\d+)")

# Model names whose textual head masks future positions, and those that
# caption in both directions (virtex_tpu/factories.py).
CAPTIONING_MODELS = ("virtex", "captioning", "bicaptioning")
BIDIRECTIONAL_MODELS = ("virtex", "bicaptioning")
MODEL_NAMES = CAPTIONING_MODELS + (
    "masked_lm", "token_classification", "multilabel_classification")
DECODER_NAMES = ("beam_search", "nucleus_sampling")

# configs/task_ablations/<stem>.yaml: the keys each file sets over
# configs/_base_bicaptioning_R_50_L1_H1024.yaml (the base's MODEL.NAME is
# "virtex"). Both classification files also set OPTIM.NO_DECAY "none".
_H2048 = "transdec_postnorm::L1_H2048_A32_F8192"
TASK_ABLATIONS = {
    "bicaptioning_R_50_L1_H2048": {"model_name": "virtex",
                                   "textual_name": _H2048},
    "captioning_R_50_L1_H2048": {"model_name": "captioning",
                                 "textual_name": _H2048},
    "masked_lm_R_50_L1_H2048": {"model_name": "masked_lm",
                                "textual_name": _H2048},
    "token_classification_R_50": {"model_name": "token_classification",
                                  "textual_name": "none"},
    "multilabel_classification_R_50": {
        "model_name": "multilabel_classification", "textual_name": "none",
        "vocab_size": 81},
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model_name: str = "virtex"
    visual_name: str = "torchvision::resnet50"
    visual_feature_size: int = 2048
    visual_frozen: bool = False
    bn_stat_stride: int = 1
    stem_s2d: bool = False
    textual_name: str = "transdec_postnorm::L1_H2048_A32_F8192"
    textual_dropout: float = 0.1
    remat: bool = False
    dtype: str = "bfloat16"
    vocab_size: int = 10000
    max_caption_length: int = 30
    image_size: int = 224
    unk_index: int = 0
    sos_index: int = 1
    eos_index: int = 2
    mask_index: int = 3
    decoder_name: str = "beam_search"
    beam_size: int = 5
    nucleus_size: float = 0.9
    max_decoding_steps: int = 30
    prefix_mode: str = "reference"

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise KeyError(f"unknown MODEL.NAME {self.model_name!r}; "
                           f"known: {MODEL_NAMES}")
        if self.decoder_name not in DECODER_NAMES:
            raise KeyError(f"unknown MODEL.DECODER.NAME "
                           f"{self.decoder_name!r}; known: {DECODER_NAMES}")

    @classmethod
    def flagship(cls) -> "ModelSpec":
        """``bicaptioning_R_50_L1_H1024``: the model that
        ``__graft_entry__._flagship_config()`` builds."""
        return cls(model_name="bicaptioning",
                   textual_name="transdec_postnorm::L1_H1024_A16_F4096")

    @classmethod
    def task_ablation(cls, name: str) -> "ModelSpec":
        """``configs/task_ablations/<name>.yaml``, e.g.
        ``masked_lm_R_50_L1_H2048`` or ``token_classification_R_50``."""
        if name not in TASK_ABLATIONS:
            raise KeyError(f"unknown task ablation {name!r}; known: "
                           f"{sorted(TASK_ABLATIONS)}")
        return cls(**TASK_ABLATIONS[name])

    @classmethod
    def from_config(cls, cfg: Any) -> "ModelSpec":
        """Copy the slice's keys out of a ``virtex_tpu.config.Config``."""
        M, D = cfg.MODEL, cfg.DATA
        return cls(
            model_name=M.NAME,
            visual_name=M.VISUAL.NAME,
            visual_feature_size=int(M.VISUAL.FEATURE_SIZE),
            visual_frozen=bool(M.VISUAL.FROZEN),
            bn_stat_stride=int(M.VISUAL.BN_STAT_STRIDE),
            stem_s2d=bool(M.VISUAL.STEM_S2D),
            textual_name=M.TEXTUAL.NAME,
            textual_dropout=float(M.TEXTUAL.DROPOUT),
            remat=bool(M.VISUAL.REMAT or M.TEXTUAL.REMAT),
            dtype=cfg.DTYPE,
            vocab_size=int(D.VOCAB_SIZE),
            max_caption_length=int(D.MAX_CAPTION_LENGTH),
            image_size=int(D.IMAGE_CROP_SIZE),
            unk_index=int(D.UNK_INDEX),
            sos_index=int(D.SOS_INDEX),
            eos_index=int(D.EOS_INDEX),
            mask_index=int(D.MASK_INDEX),
            decoder_name=M.DECODER.NAME,
            beam_size=int(M.DECODER.BEAM_SIZE),
            nucleus_size=float(M.DECODER.NUCLEUS_SIZE),
            max_decoding_steps=int(M.DECODER.MAX_DECODING_STEPS),
            prefix_mode=M.DECODER.PREFIX_MODE,
        )

    # -- derived ------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown DTYPE {self.dtype!r}; "
                             f"supported: {sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    @property
    def visual_arch(self) -> str:
        """``torchvision::resnet50`` → ``resnet50``."""
        zoo, _, arch = self.visual_name.rpartition("::")
        if zoo not in ("", "torchvision"):
            raise KeyError(f"unknown visual backbone family {zoo!r}")
        return arch

    @property
    def linear_head(self) -> bool:
        """``TEXTUAL.NAME: "none"``: the pooled linear head of the
        classification tasks."""
        return self.textual_name == "none"

    @property
    def textual(self) -> dict:
        """The parsed textual grammar: norm, layers, hidden, heads, ffn."""
        m = TEXTUAL_NAME_RE.fullmatch(self.textual_name)
        if not m:
            raise ValueError(
                f"Cannot parse textual head name {self.textual_name!r}")
        return {"norm_type": m.group("norm"),
                "num_layers": int(m.group("L")),
                "hidden_size": int(m.group("H")),
                "attention_heads": int(m.group("A")),
                "feedforward_size": int(m.group("F"))}

    @property
    def caption_backward(self) -> bool:
        return self.model_name in BIDIRECTIONAL_MODELS


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """The ``OPTIM.*`` keys of the optimizer chain and its LR schedule
    (``virtex_tpu/config.py``), defaults included. The batch size and the
    accumulation count are the train step's to take."""
    optimizer_name: str = "sgd"
    sgd_momentum: float = 0.9
    weight_decay: float = 0.0001
    no_decay: str = ".*textual.(embedding|transformer).*(norm.*|bias)"
    clip_grad_norm: float = 10.0
    lookahead_use: bool = True
    lookahead_alpha: float = 0.5
    lookahead_steps: int = 5
    cnn_lr: float = 0.2
    lr: float = 0.001
    num_iterations: int = 500000
    warmup_steps: int = 10000
    lr_decay_name: str = "cosine"
    lr_steps: Tuple[int, ...] = ()
    lr_gamma: float = 0.1

    @classmethod
    def flagship(cls) -> "OptimSpec":
        """The flagship's optimizer: ``_flagship_config()`` keeps every
        ``OPTIM`` default."""
        return cls()

    @classmethod
    def task_ablation(cls, name: str) -> "OptimSpec":
        """The optimizer of ``configs/task_ablations/<name>.yaml``: the
        defaults, and NO_DECAY "none" (no name matches, so every parameter
        decays) for the two with the linear head."""
        linear = ModelSpec.task_ablation(name).linear_head
        return cls(no_decay="none") if linear else cls()

    @classmethod
    def from_config(cls, cfg: Any) -> "OptimSpec":
        O = cfg.OPTIM
        return cls(
            optimizer_name=O.OPTIMIZER_NAME,
            sgd_momentum=float(O.SGD_MOMENTUM),
            weight_decay=float(O.WEIGHT_DECAY),
            no_decay=O.NO_DECAY,
            clip_grad_norm=float(O.CLIP_GRAD_NORM),
            lookahead_use=bool(O.LOOKAHEAD.USE),
            lookahead_alpha=float(O.LOOKAHEAD.ALPHA),
            lookahead_steps=int(O.LOOKAHEAD.STEPS),
            cnn_lr=float(O.CNN_LR),
            lr=float(O.LR),
            num_iterations=int(O.NUM_ITERATIONS),
            warmup_steps=int(O.WARMUP_STEPS),
            lr_decay_name=O.LR_DECAY_NAME,
            lr_steps=tuple(int(s) for s in O.LR_STEPS),
            lr_gamma=float(O.LR_GAMMA),
        )
