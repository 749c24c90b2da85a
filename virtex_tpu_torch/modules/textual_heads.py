r"""
Textual heads: the visual grid (and caption tokens) → vocabulary logits.

Counterpart of ``virtex_tpu/modules/textual_heads.py``.
:class:`LinearTextualHead` (the classification tasks) pools the grid and
applies one fp32 linear layer. :class:`TransformerTextualHead`: visual
projection C→H over the flattened
grid, word + position embedding, transformer decoder with
cross-attention to the visual tokens, and an output projection whose
weight is the word table (``output.weight`` is tied to
``embedding.words.weight``) plus an fp32 ``output.bias``.

Bicaptioning's backward direction is a second head from
:meth:`TransformerTextualHead.backward_head` that shares the projection,
embedding and output with this one and owns its own transformer, the way
the reference builds it, so the state dict holds ``backward_textual.*``
beside ``textual.*``. That transformer is initialised on its own, as
``virtex_tpu``'s ``backward_transformer`` is (the torch original starts
both directions from one copy); weights loaded through the bridge replace
it either way.

:class:`LatentMoETextualHead` (``moe_mla::<preset>_L<n>``, captioning
only; no counterpart in the JAX package) runs a DeepSeek-V3-style decoder
(``modules/latent_moe.py``) with the image as a prefix of its own causal
sequence, the way Kimi-VL feeds its vision tower's tokens.

A head that decodes tells the caption loop (``engine/captioner.py``):

- which parts of its decode caches follow the beams and which are one per
  image: ``split_cache(caches) → (per_beam, per_image)`` and
  ``join_cache`` back;
- the searches it serves, ``searches``;
- what one caption call holds: ``decoding()``, a context manager around
  the call's prefill and steps.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from virtex_tpu_torch.modules.embedding import WordAndPositionalEmbedding
from virtex_tpu_torch.modules.latent_moe import (
    FP32_MATRICES,
    LatentMoEDecoder,
    LatentMoEDims,
    RMSNorm,
    Weights,
    rms_norm,
)
from virtex_tpu_torch.modules.transformer import (
    Cache,
    Linear,
    TransformerDecoder,
    make_self_attention_mask,
)


class LinearTextualHead(nn.Module):
    """Average-pool the (B, Hg, Wg, C) grid, then an fp32 ``Linear`` to
    the vocabulary (weight N(0, 0.02), bias zero)."""

    def __init__(self, visual_feature_size: int, vocab_size: int):
        super().__init__()
        self.output = nn.Linear(visual_feature_size, vocab_size)
        nn.init.normal_(self.output.weight, std=0.02)
        nn.init.zeros_(self.output.bias)

    def forward(self, visual_grid, caption_tokens=None, caption_lengths=None,
                generator: Optional[torch.Generator] = None):
        """(B, Hg, Wg, C) → (B, vocab) fp32 logits. The mean is taken in
        fp32 and rounded to the grid's dtype, as ``jnp.mean`` of a bf16
        grid returns bf16, before the fp32 layer."""
        pooled = visual_grid.float().mean(dim=(1, 2)).to(visual_grid.dtype)
        return self.output(pooled.float())


class TransformerTextualHead(nn.Module):
    searches = ("beam search", "nucleus sampling")

    def __init__(self, visual_feature_size: int, vocab_size: int,
                 hidden_size: int, num_layers: int, attention_heads: int,
                 feedforward_size: int, dropout: float = 0.1,
                 norm_type: str = "post", mask_future_positions: bool = True,
                 max_caption_length: int = 30, padding_idx: int = 0,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.mask_future_positions = mask_future_positions
        self.max_caption_length = max_caption_length
        self.dtype = dtype
        self.visual_projection = Linear(visual_feature_size, hidden_size,
                                        dtype)
        self.embedding = WordAndPositionalEmbedding(
            vocab_size, hidden_size, dropout, max_caption_length,
            padding_idx, dtype)
        self._transformer_args = (num_layers, hidden_size, attention_heads,
                                  feedforward_size, dropout, norm_type, dtype,
                                  remat)
        self.transformer = TransformerDecoder(*self._transformer_args)
        self.output = nn.Linear(hidden_size, vocab_size)
        self.output.weight = self.embedding.words.weight
        nn.init.zeros_(self.output.bias)

    def backward_head(self) -> "TransformerTextualHead":
        """A head for reversed captions: shares the visual projection, the
        embedding and the tied output with this head; its transformer is
        its own, freshly initialised (from torch's global generator, after
        this head's)."""
        twin = copy.deepcopy(self)
        twin.transformer = TransformerDecoder(*self._transformer_args)
        twin.visual_projection = self.visual_projection
        twin.embedding = self.embedding
        twin.output = self.output
        return twin

    # -- shared pieces -------------------------------------------------------
    def project_visual(self, visual_grid: torch.Tensor) -> torch.Tensor:
        """(B, Hg, Wg, C) NHWC grid → (B, Hg·Wg, H) visual tokens."""
        B, Hg, Wg, C = visual_grid.shape
        return self.visual_projection(
            visual_grid.reshape(B, Hg * Wg, C).to(self.dtype))

    def output_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied projection in the compute dtype, plus the fp32 bias, cast
        back to the compute dtype."""
        logits = self.embedding.attend(hidden)
        return (logits.float() + self.output.bias).to(logits.dtype)

    # -- full-sequence forward -----------------------------------------------
    def forward(self, visual_grid, caption_tokens, caption_lengths,
                generator: Optional[torch.Generator] = None):
        """(B,Hg,Wg,C), (B,T), (B,) → (B, T, vocab). ``generator`` draws
        the dropout bits in training."""
        visual = self.project_visual(visual_grid)
        x = self.embedding(caption_tokens, generator=generator)
        mask = make_self_attention_mask(caption_tokens, caption_lengths,
                                        causal=self.mask_future_positions)
        return self.output_logits(self.transformer(x, visual, mask,
                                                   generator))

    # -- KV-cached decode ----------------------------------------------------
    def init_decode(self, visual_grid, max_length: Optional[int] = None
                    ) -> List[Cache]:
        """Project the visual grid and build each layer's cache."""
        visual = self.project_visual(visual_grid)
        return self.transformer.init_cache(
            visual, visual.shape[0], max_length or self.max_caption_length)

    def decode_step(self, token: torch.Tensor, position: int,
                    caches: List[Cache]):
        """token (B,), position, caches → logits (B, vocab), caches."""
        x = self.embedding(token[:, None], position_offset=position)
        x, caches = self.transformer.decode(x, caches, position)
        return self.output_logits(x[:, 0, :]), caches

    def decoding(self):
        """A caption call holds nothing of this head's beyond its caches."""
        return contextlib.nullcontext()

    @staticmethod
    def split_cache(caches: List[Cache]) -> Tuple[list, list]:
        """(per beam, per image): each layer's self K/V follow the beams,
        its cross K/V are one per image."""
        return ([{"k": c["k"], "v": c["v"]} for c in caches],
                [{"ck": c["ck"], "cv": c["cv"]} for c in caches])

    @staticmethod
    def join_cache(per_beam: list, per_image: list) -> List[Cache]:
        return [{**b, **i} for b, i in zip(per_beam, per_image)]


class LatentMoETextualHead(nn.Module):
    r"""A captioning head around :class:`LatentMoEDecoder`: the visual grid
    (B, Hg, Wg, C) through ``visual_projection`` (LayerNorm, Linear C→H,
    GELU, Linear H→H) is a prefix of Hg·Wg tokens at positions 0..P−1 of
    the decoder's causal sequence, the caption follows from position P
    (its start token there), and a final RMSNorm and an untied
    ``lm_head`` give the logits. Matrices and the embedding N(0, 0.02),
    norms at 1, biases at 0.

    Inference only: training it (the router's bias update and the
    sequence auxiliary loss) is not written, and :meth:`forward` refuses
    training mode.

    In a bf16 head every matrix but the router's and the embedding's is
    read as a bf16 copy, made by :meth:`weights`. A caption call runs
    inside :meth:`decoding`, which casts once into copies that the head
    keeps between calls (so the decode steps' CUDA graphs read them where
    they lie) and that :meth:`init_decode` and :meth:`decode_step` read
    until the block ends; outside it each of those casts afresh, so no call
    reads copies older than its parameters. It captions by beam search
    only.
    """

    searches = ("beam search",)

    def __init__(self, visual_feature_size: int, vocab_size: int,
                 dims: LatentMoEDims, num_layers: int,
                 max_caption_length: int = 30,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if vocab_size != dims.vocab_size:
            raise ValueError(f"DATA.VOCAB_SIZE {vocab_size} differs from the "
                             f"preset's vocabulary, {dims.vocab_size}")
        H = dims.hidden_size
        self.dims, self.dtype = dims, dtype
        self.max_caption_length = max_caption_length
        self.visual_projection = nn.ModuleDict({
            "norm": nn.LayerNorm(visual_feature_size),
            "fc1": nn.Linear(visual_feature_size, H),
            "fc2": nn.Linear(H, H)})
        self.embed_tokens = nn.Embedding(vocab_size, H)
        self.decoder = LatentMoEDecoder(dims, num_layers)
        self.norm = RMSNorm(H)
        self.lm_head = nn.Linear(H, vocab_size, bias=False)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not name.startswith(("visual_projection.fc",
                                        "embed_tokens", "lm_head")):
                    continue
                if p.dim() == 2:
                    p.normal_(std=0.02)
                else:
                    p.zero_()
        self._decode_weights: Optional[Weights] = None
        self._in_call = False

    # -- the tensors the computation reads -----------------------------------
    def _stays(self, name: str, p: torch.Tensor) -> bool:
        return (self.dtype == torch.float32 or p.dim() < 2
                or name == "embed_tokens.weight"
                or FP32_MATRICES.search(name) is not None)

    @torch.no_grad()
    def weights(self, out: Optional[Weights] = None) -> Weights:
        """Every parameter by name: the matrices as copies in the head's
        dtype (cast into ``out``'s tensors where given), the rest (norms,
        biases, the router, the embedding) as they are."""
        W, dst, src = {}, [], []
        for name, p in self.named_parameters():
            if self._stays(name, p):
                W[name] = p.detach()
            elif out is None:
                W[name] = p.detach().to(self.dtype)
            else:
                W[name] = out[name]
                dst.append(out[name])
                src.append(p.detach())
        if dst:
            torch._foreach_copy_(dst, src)
        return W

    @contextlib.contextmanager
    def decoding(self):
        """One caption call: the matrices cast once, into the copies kept
        from the last call where they still fit, and read by the call's
        prefill and steps. The copies are inference tensors, made and
        updated under ``torch.inference_mode``, as the caption call runs."""
        kept = self._decode_weights
        with torch.inference_mode():
            if kept is not None and all(
                    kept[n].device == p.device and kept[n].shape == p.shape
                    for n, p in self.named_parameters()):
                self.weights(out=kept)
            else:
                self._decode_weights = None
                self._decode_weights = self.weights()
        self._in_call = True
        try:
            yield
        finally:
            self._in_call = False

    def _weights(self) -> Weights:
        return self._decode_weights if self._in_call else self.weights()

    # -- pieces ---------------------------------------------------------------
    def project_visual(self, W: Weights, visual_grid: torch.Tensor
                       ) -> torch.Tensor:
        """(B, Hg, Wg, C) → (B, Hg·Wg, H) fp32 prefix tokens."""
        p = "visual_projection."
        x = F.layer_norm(visual_grid.flatten(1, 2).float(),
                         (visual_grid.shape[-1],), W[p + "norm.weight"],
                         W[p + "norm.bias"])
        for fc in ("fc1", "fc2"):
            if fc == "fc2":
                x = F.gelu(x.float())
            x = F.linear(x.to(self.dtype), W[f"{p}{fc}.weight"],
                         W[f"{p}{fc}.bias"].to(self.dtype))
        return x.float()

    def _logits(self, W: Weights, x: torch.Tensor) -> torch.Tensor:
        y = rms_norm(x, W["norm.weight"], self.dims.rms_norm_eps, self.dtype)
        return F.linear(y, W["lm_head.weight"])

    # -- full-sequence forward ------------------------------------------------
    def forward(self, visual_grid, caption_tokens, caption_lengths=None,
                generator: Optional[torch.Generator] = None):
        """(B,Hg,Wg,C), (B,T) → (B, T, vocab) teacher-forced logits at the
        caption's positions only (the prefix's are never formed)."""
        if self.training:
            raise NotImplementedError(
                "the moe_mla head is inference only: its training (the "
                "router's bias update and the sequence auxiliary loss) is "
                "not written; call .eval()")
        W = self.weights()
        prefix = self.project_visual(W, visual_grid)
        P = prefix.shape[1]
        x = torch.cat((prefix, F.embedding(caption_tokens.long(),
                                           W["embed_tokens.weight"])), 1)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self.decoder(W, x, positions, self.dtype, "decoder.")
        return self._logits(W, x[:, P:])

    # -- cached decode --------------------------------------------------------
    def init_decode(self, visual_grid, max_length: Optional[int] = None
                    ) -> List[Dict[str, torch.Tensor]]:
        """The prefill: the prefix through the decoder, no logits. Per
        layer ``prefix`` (B, P, latent), its latents, and ``generated``
        (B, max_length, latent), zeros for the caption's positions."""
        W = self._weights()
        prefix = self.project_visual(W, visual_grid)
        B, P, _ = prefix.shape
        positions = torch.arange(P, device=prefix.device)
        _, latents = self.decoder(W, prefix, positions, self.dtype,
                                  "decoder.", caches_only=True)
        S = max_length or self.max_caption_length
        return [{"generated": c.new_zeros((B, S, c.shape[-1])), "prefix": c}
                for c in latents]

    def decode_step(self, token: torch.Tensor, position: int,
                    caches: List[Dict[str, torch.Tensor]]):
        """token (R,) at caption position ``position`` (its latent written
        there in each layer's ``generated``) → logits (R, vocab), caches."""
        W = self._weights()
        P = caches[0]["prefix"].shape[1]
        x = F.embedding(token.long(), W["embed_tokens.weight"])
        x = self.decoder.decode(W, x, P + position,
                                [c["prefix"] for c in caches],
                                [c["generated"] for c in caches], position,
                                self.dtype, "decoder.")
        return self._logits(W, x), caches

    @staticmethod
    def split_cache(caches) -> Tuple[list, list]:
        """(per beam, per image): the generated positions' latents follow
        the beams; the prefix's are one per image."""
        return ([{"generated": c["generated"]} for c in caches],
                [{"prefix": c["prefix"]} for c in caches])

    @staticmethod
    def join_cache(per_beam: list, per_image: list) -> list:
        return [{**b, **i} for b, i in zip(per_beam, per_image)]
