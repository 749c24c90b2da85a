r"""
End-to-end caption generation: visual encode → KV-cache init → beam search
or nucleus sampling.

Counterpart of ``virtex_tpu/engine/captioner.py`` :func:`make_caption_fn`
and :func:`decode_predictions`. The visual grid is encoded once and the
cross-attention K/V are projected once per image and kept so: one row per
image serves all of its beams (the decode attention reads it once per
image). Beam search holds them outside the search state (they do not
differ between an image's beams, so the per-step beam reorder never
gathers them) and reorders the self-attention caches with the beams.
Nucleus sampling keeps one row per image, so its state is the whole cache.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch
from virtex_tpu_torch.utils.nucleus_sampling import (
    AutoRegressiveNucleusSampling,
)
from virtex_tpu_torch.utils.tracing import span

CaptionFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def make_caption_fn(model, decoder, sos_index: int = 1,
                    prefix_mode: str = "reference") -> CaptionFn:
    r"""Build ``(images, generator=None) → predictions`` (B, max_steps)
    token ids, the start token excluded. Nucleus sampling draws from
    ``generator`` (on the images' device) and raises without one; beam
    search takes none.

    ``prefix_mode`` (config ``MODEL.DECODER.PREFIX_MODE``), beam search
    only:

    - ``"reference"`` (default, the parity contract): prefixes EXCLUDE the
      start token, as the reference decodes, so generated token i sits at
      position i−1 and the first prediction overwrites the SOS cache slot.
      This is the reference's train/inference mismatch, kept on purpose
      so that published checkpoints caption as they did.
    - ``"sos"``: keep SOS at position 0, as in training.

    Nucleus sampling always keeps SOS at position 0, as the reference
    does, and its step returns raw logits, not log-probabilities.
    """
    if not isinstance(decoder, (AutoRegressiveBeamSearch,
                                AutoRegressiveNucleusSampling)):
        raise TypeError(f"unknown caption decoder {type(decoder).__name__}")
    if prefix_mode not in ("reference", "sos"):
        raise ValueError(f"unknown prefix_mode {prefix_mode!r}")
    max_pos = model.textual.max_caption_length
    if decoder.max_steps > max_pos:
        raise ValueError(
            f"decoder.max_steps={decoder.max_steps} exceeds the positional "
            f"table ({max_pos} rows); raise DATA.MAX_CAPTION_LENGTH or "
            "lower MODEL.DECODER.MAX_DECODING_STEPS")
    if isinstance(decoder, AutoRegressiveNucleusSampling):
        return _nucleus_caption_fn(model, decoder, sos_index)
    rebase = prefix_mode == "reference"
    K = decoder.beam_size

    @torch.inference_mode()
    def caption_fn(images: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        with span("caption", images):
            model.eval()
            grid = model.encode_visual(images)
            B = images.shape[0]
            # Cross K/V from the untiled grid: projected, and kept, once
            # per image; row i serves beams [i·K, (i + 1)·K).
            caches = model.init_decode(grid, decoder.max_steps)
            cross = [{"ck": c["ck"], "cv": c["cv"]} for c in caches]
            self_caches = [{"k": c["k"].repeat_interleave(K, dim=0),
                            "v": c["v"].repeat_interleave(K, dim=0)}
                           for c in caches]

            def step_fn(tokens, position: int, state):
                if rebase:
                    position = max(position - 1, 0)
                with span("decode_step", tokens):
                    full = [{**sc, **cx} for sc, cx in zip(state, cross)]
                    logits, full = model.decode_step(tokens, position, full)
                    state = [{"k": c["k"], "v": c["v"]} for c in full]
                    return torch.log_softmax(logits.float(), dim=-1), state

            start = torch.full((B,), sos_index, dtype=torch.long,
                               device=images.device)
            preds, _ = decoder.search(start, step_fn, self_caches)
            return preds

    return caption_fn


def _nucleus_caption_fn(model, decoder: AutoRegressiveNucleusSampling,
                        sos_index: int) -> CaptionFn:
    @torch.inference_mode()
    def caption_fn(images: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        if generator is None:
            # A fixed seed would make "sampling" deterministic with no
            # symptom; the caller threads its own randomness.
            raise ValueError("nucleus captioning needs a torch.Generator "
                             "(generator=)")
        with span("caption", images):
            model.eval()
            caches = model.init_decode(model.encode_visual(images),
                                       decoder.max_steps)
            start = torch.full((images.shape[0],), sos_index,
                               dtype=torch.long, device=images.device)
            preds, _ = decoder.search(start, step_fn, caches, generator)
            return preds

    def step_fn(tokens, position: int, caches):
        with span("decode_step", tokens):
            return model.decode_step(tokens, position, caches)

    return caption_fn


def decode_predictions(tokens, tokenizer, eos_index: int = 2) -> list:
    """(B, T) token ids (a tensor or an array) → B captions: each row cut
    before its first ``eos_index``, then ``tokenizer.decode``, which drops
    the special ids."""
    if torch.is_tensor(tokens):
        tokens = tokens.cpu()
    out = []
    for row in tokens.tolist():
        ids = []
        for t in row:
            if t == eos_index:
                break
            ids.append(int(t))
        out.append(tokenizer.decode(ids))
    return out
