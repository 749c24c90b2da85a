r"""
Models and caption decoders from a :class:`~virtex_tpu_torch.config.ModelSpec`.

Counterpart of ``virtex_tpu/factories.py`` ``PretrainingModelFactory`` and
``CaptionDecoderFactory``: the six ``MODEL.NAME``s, each with its textual
head (the transformer head masks future positions only for the captioning
names; ``TEXTUAL.NAME: "none"`` is the linear head), its padding index and
its ignored labels, and the two ``MODEL.DECODER.NAME``s.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from virtex_tpu_torch.config import CAPTIONING_MODELS, ModelSpec
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


Decoder = Union[AutoRegressiveBeamSearch, AutoRegressiveNucleusSampling]


class CaptionDecoderFactory:
    @classmethod
    def from_spec(cls, spec: ModelSpec) -> Decoder:
        if spec.decoder_name == "beam_search":
            return AutoRegressiveBeamSearch(
                spec.eos_index, spec.max_decoding_steps, spec.beam_size)
        return AutoRegressiveNucleusSampling(
            spec.eos_index, spec.max_decoding_steps, spec.nucleus_size)
