r"""
Plain PyTorch reference of a VirTex bicaptioning model (Desai & Johnson,
CVPR 2021; kdexd/virtex v1.4), on a flat dict of fp32 tensors named as
the published checkpoints name them.

- Visual: torchvision's ResNet-50 trunk ("v1.5", stride on the 3×3
  conv), NHWC images in, the NHWC layer4 grid out; BatchNorm on batch
  statistics in training (biased variance, ε 1e-5) and on running
  statistics in evaluation.
- Textual, per direction: the visual grid projected to H; word and
  position embeddings summed, LayerNorm (ε 1e-8), dropout, padding
  positions zeroed; post-norm decoder layers (self-attention masked to
  the past and to the caption's length, cross-attention to the 49 visual
  tokens, a GELU feed-forward), LayerNorm ε 1e-5; logits from the tied
  word table plus an output bias. Bicaptioning's backward direction runs
  its own decoder layers on the reversed caption and shares the
  projection, the embeddings and the output with the forward one.
- Loss: token cross-entropy of positions 0..T−2 against tokens 1..T−1
  over non-padding targets, forward plus backward.

Dropout draws from the caller's ``torch.Generator`` in the order the
computation meets it: embeddings, then per layer the self-attention's
kernel seed, the sublayer's mask, the cross-attention's seed and mask,
the feed-forward's inner mask and its sublayer mask. Attention dropout
drops softmax probabilities by the keep mask its seed gives (on a card
the Philox rule of ``philox.py``; on a CPU a generator seeded with it).

Every matrix product and convolution takes its operands through ``cast``
and its result through ``cast.out`` (both the identity for fp32; for the
control, :class:`FP8` rounds the operands, and the gradient each product
receives, to fp8). Nothing here imports the program under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.philox import keep_mask

Weights = Dict[str, torch.Tensor]
NEG_INF = -1e9
RESNET50_STAGES = (3, 4, 6, 3)


class Precision:
    """fp32 products: operands and gradients as they are."""

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def out(self, t: torch.Tensor) -> torch.Tensor:
        return t


def _round(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with a per-tensor scale that maps its
    largest magnitude to ``largest``, back in fp32."""
    scale = largest / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class FP8(Precision):
    """fp8 products, as fp8 training runs them: each operand rounded to
    e4m3, and the gradient that each product receives rounded to e5m2,
    with per-tensor scales; everything else in fp32."""

    def __call__(self, t):
        return _Operand.apply(t)

    def out(self, t):
        return _Result.apply(t)


identity = Precision()
Cast = Precision


@dataclasses.dataclass(frozen=True)
class Dims:
    hidden: int
    heads: int
    feedforward: int
    layers: int
    vocab: int
    max_length: int = 30
    dropout: float = 0.1
    pad: int = 0
    sos: int = 1
    eos: int = 2


# -- visual -------------------------------------------------------------------
def _bn(w: Weights, p: str, x, train: bool, calib: Optional[dict]):
    if calib is not None:  # batch statistics, recorded as running ones
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        calib[f"{p}.running_mean"], calib[f"{p}.running_var"] = mean, var
        return F.batch_norm(x, mean, var, w[f"{p}.weight"], w[f"{p}.bias"],
                            False, 0.0, 1e-5)
    if train:
        return F.batch_norm(x, None, None, w[f"{p}.weight"], w[f"{p}.bias"],
                            True, 0.0, 1e-5)
    return F.batch_norm(x, w[f"{p}.running_mean"], w[f"{p}.running_var"],
                        w[f"{p}.weight"], w[f"{p}.bias"], False, 0.0, 1e-5)


def _conv(w: Weights, p: str, x, stride: int, pad: int, cast: Cast):
    return cast.out(F.conv2d(cast(x), cast(w[f"{p}.weight"]), None, stride,
                             pad))


def _bottleneck(w, p, x, stride, down, train, cast, calib):
    y = F.relu(_bn(w, f"{p}.bn1", _conv(w, f"{p}.conv1", x, 1, 0, cast),
                   train, calib))
    y = F.relu(_bn(w, f"{p}.bn2", _conv(w, f"{p}.conv2", y, stride, 1,
                                        cast), train, calib))
    y = _bn(w, f"{p}.bn3", _conv(w, f"{p}.conv3", y, 1, 0, cast), train,
            calib)
    if down:
        x = _bn(w, f"{p}.downsample.1",
                _conv(w, f"{p}.downsample.0", x, stride, 0, cast), train,
                calib)
    return F.relu(y + x)


def resnet50(w: Weights, images: torch.Tensor, train: bool,
             cast: Cast = identity, remat: bool = False,
             calib: Optional[dict] = None,
             prefix: str = "visual.cnn") -> torch.Tensor:
    """(B, S, S, 3) → (B, S/32, S/32, 2048). ``remat`` recomputes each
    block in the backward (memory only); ``calib`` collects the batch
    statistics of every BatchNorm, used as its running statistics."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.relu(_bn(w, f"{prefix}.bn1",
                   _conv(w, f"{prefix}.conv1", x, 2, 3, cast), train, calib))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate(RESNET50_STAGES):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            p = f"{prefix}.layer{stage + 1}.{block}"
            args = (w, p, stride, block == 0, train, cast, calib)
            if remat and train and calib is None:
                x = checkpoint(lambda t, a=args: _bottleneck(
                    a[0], a[1], t, *a[2:]), x, use_reentrant=False)
            else:
                x = _bottleneck(w, p, x, stride, block == 0, train, cast,
                                calib)
    return x.permute(0, 2, 3, 1)


# -- textual ------------------------------------------------------------------
def _linear(w: Weights, p: str, x, cast: Cast):
    return cast.out(F.linear(cast(x), cast(w[f"{p}.weight"]),
                             w[f"{p}.bias"]))


def _dropout(x, rate: float, gen: Optional[torch.Generator]):
    if gen is None or rate == 0.0:
        return x
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x))


def attention_keep(seed: torch.Tensor, shape, rate: float, device
                   ) -> torch.Tensor:
    """The keep mask that attention dropout applies for ``seed`` (one
    int64 tensor) on ``device``."""
    s = int(seed.reshape(-1)[0])
    if torch.device(device).type == "cuda":
        return keep_mask(s, *shape, rate, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return torch.rand(shape, generator=gen, device=device) >= rate


def _attention(w, p, xq, xkv, mask, d: Dims, gen, cast: Cast):
    W, b = w[f"{p}.in_proj_weight"], w[f"{p}.in_proj_bias"]
    H = d.hidden
    N, D = d.heads, H // d.heads
    B, Tq, Tk = xq.shape[0], xq.shape[1], xkv.shape[1]
    q = cast.out(F.linear(cast(xq), cast(W[:H]), b[:H])).view(B, Tq, N, D)
    k = cast.out(F.linear(cast(xkv), cast(W[H:2 * H]), b[H:2 * H])).view(
        B, Tk, N, D)
    v = cast.out(F.linear(cast(xkv), cast(W[2 * H:]), b[2 * H:])).view(
        B, Tk, N, D)
    s = cast.out(torch.einsum("bqnd,bknd->bnqk", cast(q), cast(k))) \
        / math.sqrt(D)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)
    if gen is not None and d.dropout > 0.0:
        seed = torch.randint(2**31 - 1, (), generator=gen,
                             device=gen.device)
        keep = attention_keep(seed, prob.shape, d.dropout, prob.device)
        prob = torch.where(keep, prob / (1.0 - d.dropout),
                           torch.zeros_like(prob))
    ctx = cast.out(torch.einsum("bnqk,bknd->bqnd", cast(prob), cast(v)))
    return _linear(w, f"{p}.out_proj", ctx.reshape(B, Tq, H), cast)


def _layer_norm(w, p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w[f"{p}.weight"], w[f"{p}.bias"],
                        eps)


def decoder(w: Weights, d: Dims, direction: str, grid: torch.Tensor,
            tokens: torch.Tensor, lengths: Optional[torch.Tensor],
            gen: Optional[torch.Generator] = None,
            cast: Cast = identity) -> torch.Tensor:
    """(B, T, vocab) fp32 logits of ``direction`` ("textual" or
    "backward_textual") over (B, T) tokens. ``lengths`` None: no key
    padding (the decode path's view). ``gen`` None: no dropout."""
    B, Hg, Wg, C = grid.shape
    visual = _linear(w, "textual.visual_projection",
                     grid.reshape(B, Hg * Wg, C).float(), cast)
    t = tokens.long()
    T = t.shape[1]
    pos = torch.arange(T, device=t.device)
    x = (w["textual.embedding.words.weight"][t]
         + w["textual.embedding.positions.weight"][pos])
    x = _layer_norm(w, "textual.embedding.layer_norm", x, 1e-8)
    x = _dropout(x, d.dropout, gen)
    x = x * (t != d.pad).unsqueeze(-1).float()
    mask = (pos[None, :] <= pos[:, None])[None, None]
    if lengths is not None:
        mask = mask & (pos[None, :] < lengths.long()[:, None])[:, None,
                                                                 None, :]
    for layer in range(d.layers):
        p = f"{direction}.transformer.layers.{layer}"
        x = _layer_norm(w, f"{p}.norm1", x + _dropout(_attention(
            w, f"{p}.self_attn", x, x, mask, d, gen, cast), d.dropout, gen))
        x = _layer_norm(w, f"{p}.norm2", x + _dropout(_attention(
            w, f"{p}.multihead_attn", x, visual, None, d, gen, cast),
            d.dropout, gen))
        h = _dropout(F.gelu(_linear(w, f"{p}.linear1", x, cast)), d.dropout,
                     gen)
        x = _layer_norm(w, f"{p}.norm3", x + _dropout(
            _linear(w, f"{p}.linear2", h, cast), d.dropout, gen))
    return cast.out(F.linear(cast(x), cast(
        w["textual.embedding.words.weight"]), w["textual.output.bias"]))


def token_ce(logits: torch.Tensor, tokens: torch.Tensor, pad: int):
    """Mean cross-entropy of logits[:, :-1] against tokens[:, 1:] over the
    targets that are not padding."""
    target = tokens[:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -lp.gather(-1, target[..., None])[..., 0]
    mask = (target != pad).float()
    return (nll * mask).sum() / mask.sum()


def bicaptioning_loss(w: Weights, d: Dims, batch: Dict[str, torch.Tensor],
                      gen: Optional[torch.Generator], cast: Cast = identity,
                      remat: bool = False):
    """Train-mode loss (forward + backward direction) of one batch, and
    its two components."""
    grid = resnet50(w, batch["image"], True, cast, remat)
    lengths = batch["caption_lengths"]
    fwd = token_ce(decoder(w, d, "textual", grid, batch["caption_tokens"],
                           lengths, gen, cast), batch["caption_tokens"],
                   d.pad)
    bwd = token_ce(decoder(w, d, "backward_textual", grid,
                           batch["noitpac_tokens"], lengths, gen, cast),
                   batch["noitpac_tokens"], d.pad)
    return fwd + bwd, fwd, bwd
