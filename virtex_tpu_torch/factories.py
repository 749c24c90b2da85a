r"""
Models, caption decoders, tokenizers, datasets and optimizers from a
:class:`~virtex_tpu_torch.config.Config` or a
:class:`~virtex_tpu_torch.config.ModelSpec`.

Counterpart of ``virtex_tpu/factories.py``: the six ``MODEL.NAME``s, each
with its textual head (the transformer head masks future positions only for
the captioning names; ``TEXTUAL.NAME: "none"`` is the linear head), its
padding index and its ignored labels; the two ``MODEL.DECODER.NAME``s; the
tokenizer of ``DATA.TOKENIZER_MODEL``; each ``MODEL.NAME``'s pretraining
dataset over the data plane; and the optimizer chain and LR schedule of
``OPTIM.*``.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from virtex_tpu_torch.config import (
    CAPTIONING_MODELS,
    Config,
    ModelSpec,
    OptimSpec,
)
from virtex_tpu_torch.data.datasets.captioning import CaptioningDataset
from virtex_tpu_torch.data.datasets.classification import (
    MultiLabelClassificationDataset,
    TokenClassificationDataset,
)
from virtex_tpu_torch.data.datasets.masked_lm import MaskedLmDataset
from virtex_tpu_torch.data.native_pipeline import make_pipeline
from virtex_tpu_torch.data.tokenizers import SentencePieceBPETokenizer
from virtex_tpu_torch.models.captioning import (
    BidirectionalCaptioningModel,
    ForwardCaptioningModel,
)
from virtex_tpu_torch.models.classification import (
    MultiLabelClassificationModel,
    TokenClassificationModel,
)
from virtex_tpu_torch.models.masked_lm import MaskedLMModel
from virtex_tpu_torch.modules.textual_heads import (
    LinearTextualHead,
    TransformerTextualHead,
)
from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone
from virtex_tpu_torch.native import DataPlane
from virtex_tpu_torch.optim.lr_schedules import Schedule, make_schedule
from virtex_tpu_torch.optim.optimizer import Optimizer, build_optimizer
from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch
from virtex_tpu_torch.utils.nucleus_sampling import (
    AutoRegressiveNucleusSampling,
)


def visual_from_spec(spec: ModelSpec) -> ResNetVisualBackbone:
    return ResNetVisualBackbone(
        spec.visual_arch, frozen=spec.visual_frozen, dtype=spec.torch_dtype,
        bn_stat_stride=spec.bn_stat_stride, stem_s2d=spec.stem_s2d,
        remat=spec.remat)


def textual_from_spec(spec: ModelSpec) -> nn.Module:
    if spec.linear_head:
        return LinearTextualHead(spec.visual_feature_size, spec.vocab_size)
    return TransformerTextualHead(
        visual_feature_size=spec.visual_feature_size,
        vocab_size=spec.vocab_size, dropout=spec.textual_dropout,
        mask_future_positions=spec.model_name in CAPTIONING_MODELS,
        max_caption_length=spec.max_caption_length,
        padding_idx=spec.unk_index, dtype=spec.torch_dtype, remat=spec.remat,
        **spec.textual)


class PretrainingModelFactory:
    PRODUCTS = {
        "virtex": BidirectionalCaptioningModel,
        "bicaptioning": BidirectionalCaptioningModel,
        "captioning": ForwardCaptioningModel,
        "masked_lm": MaskedLMModel,
        "token_classification": TokenClassificationModel,
        "multilabel_classification": MultiLabelClassificationModel,
    }

    @classmethod
    def from_spec(cls, spec: ModelSpec,
                  device: Union[str, torch.device] = "cuda") -> nn.Module:
        """The model of ``spec`` on ``device``: the card unless the caller
        asks for another. Raises if the device is CUDA and there is none.
        Parameters are drawn on the CPU and moved, so a seed gives the same
        weights on every device."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PretrainingModelFactory.from_spec: no CUDA "
                               "device; pass device='cpu' to build on the "
                               "CPU")
        visual, textual = visual_from_spec(spec), textual_from_spec(spec)
        name = spec.model_name
        product = cls.PRODUCTS[name]
        if name in CAPTIONING_MODELS:
            model = product(visual, textual, sos_index=spec.sos_index,
                            eos_index=spec.eos_index,
                            padding_idx=spec.unk_index)
        elif name == "masked_lm":
            model = product(visual, textual, padding_idx=spec.unk_index)
        elif name == "token_classification":
            model = product(visual, textual, ignore_indices=(
                spec.unk_index, spec.sos_index, spec.eos_index,
                spec.mask_index))
        else:
            model = product(visual, textual, ignore_indices=(0,))
        return model.to(device)

    @classmethod
    def from_config(cls, config: Config,
                    device: Union[str, torch.device] = "cuda") -> nn.Module:
        return cls.from_spec(ModelSpec.from_config(config), device)


Decoder = Union[AutoRegressiveBeamSearch, AutoRegressiveNucleusSampling]


class CaptionDecoderFactory:
    @classmethod
    def from_spec(cls, spec: ModelSpec) -> Decoder:
        if spec.decoder_name == "beam_search":
            return AutoRegressiveBeamSearch(
                spec.eos_index, spec.max_decoding_steps, spec.beam_size)
        return AutoRegressiveNucleusSampling(
            spec.eos_index, spec.max_decoding_steps, spec.nucleus_size)


class TokenizerFactory:
    @classmethod
    def from_config(cls, config: Config) -> SentencePieceBPETokenizer:
        return SentencePieceBPETokenizer(config.DATA.TOKENIZER_MODEL)


class PretrainingDatasetFactory:
    """Each ``MODEL.NAME``'s dataset, its images through the data plane
    ``plane`` with the transforms of ``DATA.IMAGE_TRANSFORM_TRAIN`` (split
    "train") or ``_VAL``."""

    PRODUCTS = {
        "virtex": CaptioningDataset,
        "bicaptioning": CaptioningDataset,
        "captioning": CaptioningDataset,
        "masked_lm": MaskedLmDataset,
        "token_classification": TokenClassificationDataset,
        "multilabel_classification": MultiLabelClassificationDataset,
    }

    @classmethod
    def from_config(cls, config: Config, plane: DataPlane,
                    split: str = "train"):
        _C = config
        if not _C.DATA.USE_NATIVE_LOADER:
            raise ValueError("DATA.USE_NATIVE_LOADER is False: the port has "
                             "one image path, the native data plane")
        names = (_C.DATA.IMAGE_TRANSFORM_TRAIN if split == "train"
                 else _C.DATA.IMAGE_TRANSFORM_VAL)
        pipeline = make_pipeline(names, _C.DATA.IMAGE_CROP_SIZE, plane,
                                 _C.DATA.DEVICE_NORMALIZE)
        name = _C.MODEL.NAME
        if name == "multilabel_classification":
            return MultiLabelClassificationDataset(_C.DATA.ROOT, split,
                                                   pipeline)
        kwargs = {"data_root": _C.DATA.ROOT, "split": split,
                  "tokenizer": TokenizerFactory.from_config(_C),
                  "pipeline": pipeline,
                  "max_caption_length": _C.DATA.MAX_CAPTION_LENGTH}
        if name == "masked_lm":
            kwargs.update(
                mask_proportion=_C.DATA.MASKED_LM.MASK_PROPORTION,
                mask_probability=_C.DATA.MASKED_LM.MASK_PROBABILITY,
                replace_probability=_C.DATA.MASKED_LM.REPLACE_PROBABILITY)
        if name not in cls.PRODUCTS:
            raise KeyError(f"Unknown model {name!r}")
        return cls.PRODUCTS[name](**kwargs)


class OptimizerFactory:
    """The chain of ``OPTIM.*`` over a model's named parameters, a frozen
    visual backbone stepped by zero."""

    @classmethod
    def from_config(cls, config: Config, named_params) -> Optimizer:
        return build_optimizer(named_params, OptimSpec.from_config(config),
                               visual_frozen=bool(config.MODEL.VISUAL.FROZEN))


class LRSchedulerFactory:
    @classmethod
    def from_config(cls, config: Config) -> Schedule:
        O = config.OPTIM
        return make_schedule(O.LR_DECAY_NAME, O.NUM_ITERATIONS,
                             O.WARMUP_STEPS, list(O.LR_STEPS), O.LR_GAMMA)
