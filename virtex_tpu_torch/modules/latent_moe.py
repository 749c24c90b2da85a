r"""
A DeepSeek-V3-style decoder (the language model of Kimi-VL-A3B and
Moonlight-16B-A3B): pre-norm layers of multi-head latent attention and a
feed-forward that is dense in the first layers and a routed mixture of
experts in the rest.

Per layer, with x the residual stream:

- ``h = x + MLA(RMSNorm(x))``, then ``out = h + FFN(RMSNorm(h))``;
- MLA (``q_lora_rank`` null): ``q = W_q y`` split per head into
  ``q_nope`` and ``q_rope``; ``[c; k_rope] = W_kva y`` with ``c`` through
  an RMSNorm and ``k_rope`` one key for all heads; ``[k_nope; v] = W_kvb
  c`` per head; RoPE on ``q_rope`` and ``k_rope``; scores
  ``(q_nope·k_nope + q_rope·k_rope) / √(nope + rope)``; ``W_o`` over the
  heads' contexts;
- FFN: SwiGLU ``down(silu(gate(y)) · up(y))``; in a routed layer
  ``Σ_{i ∈ top-k} w_i E_i(y) + Shared(y)``, the router in fp32: sigmoid
  scores, the top k of score + ``e_score_correction_bias`` (``noaux_tc``
  with one group), their scores renormalised and scaled by
  ``routed_scaling_factor``. The shared experts are one SwiGLU of
  ``n_shared_experts`` times the expert width.

RoPE rotates interleaved pairs (2i, 2i + 1) of the rope part by position ·
θ^(−2i/d), as DeepSeek-V3's checkpoints lay the rope dimensions out.

Every computation reads its tensors from ``W``, a flat dict of the
decoder's parameters by name (:meth:`LatentMoEDecoder.named_parameters`'
names): the parameters themselves, or bf16 copies of the matrices that a
caption call makes once (``textual_heads.LatentMoETextualHead``). RMSNorm
and the router run in fp32, the products in the copies' dtype, and the
residual stream stays fp32.

Two forms of the attention:

- :meth:`LatentMoEDecoder.forward`: a whole causal sequence, keys and
  values expanded per head (plain GEMMs and SDPA); it also returns each
  layer's latent cache ``[RMSNorm(c); RoPE(k_rope)]`` (kv_lora_rank +
  rope values a position, shared by the heads);
- :meth:`LatentMoEDecoder.decode`: one new token a row, in the absorbed
  form: ``q_nope·W_UK`` (kv_lora_rank a head) and ``q_rope`` score
  against the cached latents of a per-image prefix (read once for all of
  an image's rows) and of the row's own generated positions, with one
  softmax across both; the context is taken in latent space, then
  ``W_UV`` and ``W_o``.

Each routed layer's call is a span ``moe`` (``utils/tracing.py``).
Inside :func:`record_routing` each routed layer's eager call also hands
its expert choice to a list, for a reader that checks the computation
against a reference (a replayed CUDA graph runs no Python, so records
nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from virtex_tpu_torch.ops.moe import routed_experts
from virtex_tpu_torch.utils.tracing import span

Weights = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LatentMoEDims:
    """The decoder's published sizes, under the keys of its
    ``config.json``."""

    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float
    intermediate_size: int
    moe_intermediate_size: int
    n_routed_experts: int
    num_experts_per_tok: int
    n_shared_experts: int
    first_k_dense_replace: int
    routed_scaling_factor: float
    rms_norm_eps: float
    vocab_size: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a position of the latent cache holds."""
        return self.kv_lora_rank + self.qk_rope_head_dim


PRESETS = {
    # huggingface.co/moonshotai/Kimi-VL-A3B-Instruct config.json,
    # text_config (q_lora_rank null, topk_method noaux_tc, n_group 1,
    # norm_topk_prob, scoring_func sigmoid, hidden_act silu, no rope
    # scaling, untied embeddings).
    "kimi_vl_a3b": LatentMoEDims(
        hidden_size=2048, num_hidden_layers=27, num_attention_heads=16,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rope_theta=800000.0, intermediate_size=11264,
        moe_intermediate_size=1408, n_routed_experts=64,
        num_experts_per_tok=6, n_shared_experts=2, first_k_dense_replace=1,
        routed_scaling_factor=2.446, rms_norm_eps=1e-5, vocab_size=163840),
    # The same layer pattern at the tests' size.
    "tiny": LatentMoEDims(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
        v_head_dim=8, rope_theta=10000.0, intermediate_size=48,
        moe_intermediate_size=16, n_routed_experts=8, num_experts_per_tok=3,
        n_shared_experts=2, first_k_dense_replace=1,
        routed_scaling_factor=2.446, rms_norm_eps=1e-5, vocab_size=64),
}

# ``moe_mla::<preset>_L<layers>``: a preset of PRESETS cut to its first
# ``layers`` layers.
NAME_RE = re.compile(r"moe_mla::(?P<preset>\w+)_L(?P<layers>\d+)")


def parse_name(name: str) -> Optional[Tuple[LatentMoEDims, int]]:
    """(dims, layers) of a ``moe_mla::`` head name; None for another
    grammar; raises for an unknown preset or a depth outside it."""
    m = NAME_RE.fullmatch(name)
    if m is None:
        return None
    preset, layers = m.group("preset"), int(m.group("layers"))
    if preset not in PRESETS:
        raise KeyError(f"unknown moe_mla preset {preset!r}; known: "
                       f"{sorted(PRESETS)}")
    dims = PRESETS[preset]
    if not 1 <= layers <= dims.num_hidden_layers:
        raise ValueError(f"{name}: {layers} layers, the preset has "
                         f"{dims.num_hidden_layers}")
    return dims, layers


# -- parameters ---------------------------------------------------------------
def _matrix(*shape) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape) * 0.02)


class RMSNorm(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))


class LatentAttention(nn.Module):
    def __init__(self, d: LatentMoEDims):
        super().__init__()
        H, N = d.hidden_size, d.num_attention_heads
        self.q_proj = _matrix(N * d.qk_head_dim, H)
        self.kv_a_proj_with_mqa = _matrix(d.latent_dim, H)
        self.kv_a_layernorm = RMSNorm(d.kv_lora_rank)
        self.kv_b_proj = _matrix(N * (d.qk_nope_head_dim + d.v_head_dim),
                                 d.kv_lora_rank)
        self.o_proj = _matrix(H, N * d.v_head_dim)


class SwiGLU(nn.Module):
    """``gate_up_proj`` holds the gate's rows above the up projection's."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = _matrix(2 * width, hidden)
        self.down_proj = _matrix(hidden, width)


class Router(nn.Module):
    def __init__(self, d: LatentMoEDims):
        super().__init__()
        self.weight = _matrix(d.n_routed_experts, d.hidden_size)
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(d.n_routed_experts))


class Experts(nn.Module):
    def __init__(self, d: LatentMoEDims):
        super().__init__()
        E, H, Fw = d.n_routed_experts, d.hidden_size, d.moe_intermediate_size
        self.gate_up_proj = _matrix(E, 2 * Fw, H)
        self.down_proj = _matrix(E, H, Fw)


class MoE(nn.Module):
    def __init__(self, d: LatentMoEDims):
        super().__init__()
        self.gate = Router(d)
        self.experts = Experts(d)
        self.shared_experts = SwiGLU(
            d.hidden_size, d.n_shared_experts * d.moe_intermediate_size)


class DecoderLayer(nn.Module):
    def __init__(self, d: LatentMoEDims, dense: bool):
        super().__init__()
        self.dense = dense
        self.input_layernorm = RMSNorm(d.hidden_size)
        self.self_attn = LatentAttention(d)
        self.post_attention_layernorm = RMSNorm(d.hidden_size)
        self.mlp = (SwiGLU(d.hidden_size, d.intermediate_size) if dense
                    else MoE(d))


# Matrices that stay fp32 where the others are cast: the router's.
FP32_MATRICES = re.compile(r"\.mlp\.gate\.weight$")


# -- the computation ----------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             dtype: torch.dtype) -> torch.Tensor:
    x = x.float()
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
            * weight).to(dtype)


def rope_angles(positions: torch.Tensor, d: LatentMoEDims
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (S, rope / 2) fp32, of the angles position ·
    θ^(−2i/rope) at each of ``positions`` (S,)."""
    half = torch.arange(0, d.qk_rope_head_dim, 2, device=positions.device,
                        dtype=torch.float32)
    angle = positions.float()[:, None] * d.rope_theta ** (
        -half / d.qk_rope_head_dim)
    return angle.cos(), angle.sin()


def rope(x: torch.Tensor, angles) -> torch.Tensor:
    """x (..., S, [heads,] rope) with pair (2i, 2i + 1) of each position
    turned by its angle; fp32 inside."""
    cos, sin = angles
    if x.dim() == 4:                                           # heads
        cos, sin = cos[:, None, :], sin[:, None, :]
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    out = torch.stack((a * cos - b * sin, a * sin + b * cos), dim=-1)
    return out.flatten(-2).to(x.dtype)


def swiglu(W: Weights, p: str, y: torch.Tensor) -> torch.Tensor:
    g, u = F.linear(y, W[p + "gate_up_proj"]).chunk(2, dim=-1)
    return F.linear((F.silu(g.float()) * u.float()).to(y.dtype),
                    W[p + "down_proj"])


def route(W: Weights, p: str, y: torch.Tensor, d: LatentMoEDims
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(choice, weights) (N, k) of the rows of y, in fp32: sigmoid scores,
    the top k of score + correction bias, their scores renormalised and
    scaled."""
    scores = torch.sigmoid(F.linear(y.float(), W[p + "gate.weight"]))
    choice = torch.topk(scores + W[p + "gate.e_score_correction_bias"],
                        d.num_experts_per_tok, dim=-1).indices
    weights = scores.gather(1, choice)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return choice, weights * d.routed_scaling_factor


_routing: Optional[List[torch.Tensor]] = None  # record_routing's list


@contextlib.contextmanager
def record_routing():
    """Yield a list to which each routed layer's eager call appends its
    expert choice (rows, k), in call order, until the block ends."""
    global _routing
    kept, _routing = _routing, []
    try:
        yield _routing
    finally:
        _routing = kept


def moe(W: Weights, p: str, y: torch.Tensor,
        d: LatentMoEDims) -> torch.Tensor:
    """A routed layer's FFN of y (..., H)."""
    with span("moe", y):
        rows = y.reshape(-1, y.shape[-1])
        choice, weights = route(W, p, rows, d)
        if _routing is not None:
            _routing.append(choice)
        out = routed_experts(rows, choice, weights,
                             W[p + "experts.gate_up_proj"],
                             W[p + "experts.down_proj"])
        out = out + swiglu(W, p + "shared_experts.", rows)
        return out.view(y.shape)


def ffn(W: Weights, p: str, y: torch.Tensor, d: LatentMoEDims,
        dense: bool) -> torch.Tensor:
    return swiglu(W, p, y) if dense else moe(W, p, y, d)


def latent(W: Weights, p: str, y: torch.Tensor, angles,
           d: LatentMoEDims) -> torch.Tensor:
    """The latent cache of y (..., S, H): [RMSNorm(c); RoPE(k_rope)]."""
    c, k_rope = F.linear(y, W[p + "kv_a_proj_with_mqa"]).split(
        (d.kv_lora_rank, d.qk_rope_head_dim), dim=-1)
    c = rms_norm(c, W[p + "kv_a_layernorm.weight"], d.rms_norm_eps, y.dtype)
    return torch.cat((c, rope(k_rope, angles)), dim=-1)


def queries(W: Weights, p: str, y: torch.Tensor, angles,
            d: LatentMoEDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, RoPE(q_rope)) of y (..., S, H), each (..., S, heads, ·)."""
    q = F.linear(y, W[p + "q_proj"]).unflatten(
        -1, (d.num_attention_heads, d.qk_head_dim))
    q_nope, q_rope = q.split((d.qk_nope_head_dim, d.qk_rope_head_dim), -1)
    return q_nope, rope(q_rope, angles)


def attention_full(W: Weights, p: str, y: torch.Tensor, angles,
                   d: LatentMoEDims
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S, H), latent cache (B, S, latent_dim)) of a causal
    sequence y (B, S, H), keys and values expanded per head."""
    B, S, _ = y.shape
    N, nope = d.num_attention_heads, d.qk_nope_head_dim
    q_nope, q_rope = queries(W, p, y, angles, d)
    cache = latent(W, p, y, angles, d)
    c, k_rope = cache.split((d.kv_lora_rank, d.qk_rope_head_dim), -1)
    kv = F.linear(c, W[p + "kv_b_proj"]).unflatten(-1, (N, -1))
    k_nope, v = kv.split((nope, d.v_head_dim), dim=-1)
    q = torch.cat((q_nope, q_rope), -1).transpose(1, 2)
    k = torch.cat((k_nope, k_rope[:, :, None, :].expand(B, S, N, -1)),
                  -1).transpose(1, 2)
    ctx = F.scaled_dot_product_attention(
        q, k, v.transpose(1, 2), is_causal=True,
        scale=1.0 / math.sqrt(d.qk_head_dim))
    out = F.linear(ctx.transpose(1, 2).flatten(2), W[p + "o_proj"])
    return out, cache


def attention_decode(W: Weights, p: str, y: torch.Tensor, angles,
                     prefix: torch.Tensor, generated: torch.Tensor,
                     step: int, d: LatentMoEDims) -> torch.Tensor:
    """One token a row, absorbed: y (R, H) at one position (``angles`` of
    it); ``prefix`` (B, P, latent) per image, R / B rows an image;
    ``generated`` (R, S, latent) per row, this token's latent written at
    ``step`` in place and attended with the ones before it. Returns (R,
    H)."""
    R = y.shape[0]
    B, P, _ = prefix.shape
    N, nope, lora = d.num_attention_heads, d.qk_nope_head_dim, d.kv_lora_rank
    q_nope, q_rope = queries(W, p, y[:, None], angles, d)  # (R, 1, N, ·)
    generated[:, step] = latent(W, p, y[:, None], angles, d)[:, 0]
    kv_b = W[p + "kv_b_proj"].view(N, nope + d.v_head_dim, lora)
    w_uk, w_uv = kv_b[:, :nope], kv_b[:, nope:]
    # q (R, N, lora + rope): the nope part absorbed into latent space
    q = torch.cat((torch.einsum("rnd,ndc->rnc", q_nope[:, 0], w_uk),
                   q_rope[:, 0]), dim=-1)
    scale = 1.0 / math.sqrt(d.qk_head_dim)
    # per image: the K·N query rows of its beams against its P positions
    s_pre = torch.bmm(q.view(B, -1, q.shape[-1]), prefix.transpose(1, 2))
    gen = generated[:, :step + 1]
    s_gen = torch.bmm(q, gen.transpose(1, 2))              # (R, N, step+1)
    scores = torch.cat((s_pre.view(R, N, P).float(), s_gen.float()), -1)
    probs = torch.softmax(scores * scale, dim=-1).to(y.dtype)
    ctx = (torch.bmm(probs[..., :P].reshape(B, -1, P), prefix[..., :lora])
           .view(R, N, lora).float()
           + torch.bmm(probs[..., P:], gen[..., :lora]).float()
           ).to(y.dtype)                                   # (R, N, lora)
    out = torch.einsum("rnc,nvc->rnv", ctx, w_uv)
    return F.linear(out.flatten(1), W[p + "o_proj"])


class LatentMoEDecoder(nn.Module):
    """The first ``num_layers`` layers of a :class:`LatentMoEDims`
    decoder; layers below ``first_k_dense_replace`` dense."""

    def __init__(self, dims: LatentMoEDims, num_layers: int):
        super().__init__()
        self.dims, self.num_layers = dims, num_layers
        self.layers = nn.ModuleList(
            DecoderLayer(dims, i < dims.first_k_dense_replace)
            for i in range(num_layers))

    def forward(self, W: Weights, x: torch.Tensor, positions: torch.Tensor,
                dtype: torch.dtype, prefix: str = "",
                caches_only: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, S, H) fp32 residual stream, causal over S → (x after the
        last layer, each layer's latent cache (B, S, latent_dim)). With
        ``caches_only`` the last layer's FFN, which no cache needs, is left
        out (and x with it)."""
        d, caches = self.dims, []
        angles = rope_angles(positions, d)
        for i, layer in enumerate(self.layers):
            p = f"{prefix}layers.{i}."
            y = rms_norm(x, W[p + "input_layernorm.weight"], d.rms_norm_eps,
                         dtype)
            out, cache = attention_full(W, p + "self_attn.", y, angles, d)
            caches.append(cache)
            if caches_only and i == self.num_layers - 1:
                return x, caches
            x = x + out.float()
            y = rms_norm(x, W[p + "post_attention_layernorm.weight"],
                         d.rms_norm_eps, dtype)
            x = x + ffn(W, p + "mlp.", y, d, layer.dense).float()
        return x, caches

    def decode(self, W: Weights, x: torch.Tensor, position: int,
               prefixes: List[torch.Tensor], generated: List[torch.Tensor],
               step: int, dtype: torch.dtype, prefix: str = ""
               ) -> torch.Tensor:
        """x (R, H) fp32, one token a row at ``position``, through every
        layer: per layer its per-image prefix latents and its per-row
        generated latents (this step's written at ``step``)."""
        d = self.dims
        angles = rope_angles(torch.full((1,), position, device=x.device), d)
        for i, layer in enumerate(self.layers):
            p = f"{prefix}layers.{i}."
            y = rms_norm(x, W[p + "input_layernorm.weight"], d.rms_norm_eps,
                         dtype)
            x = x + attention_decode(W, p + "self_attn.", y, angles,
                                     prefixes[i], generated[i], step,
                                     d).float()
            y = rms_norm(x, W[p + "post_attention_layernorm.weight"],
                         d.rms_norm_eps, dtype)
            x = x + ffn(W, p + "mlp.", y, d, layer.dense).float()
        return x
