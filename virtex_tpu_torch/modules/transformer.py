r"""
Transformer decoder (self-attention, cross-attention to the visual tokens,
gelu FFN) with a KV-cache decode path.

Counterpart of ``virtex_tpu/modules/transformer.py``. The full-sequence
attention goes through :func:`virtex_tpu_torch.ops.attention.fused_attention`
(kernel K1 on CUDA); the single-token decode path goes through
:func:`virtex_tpu_torch.ops.decode_attention.decode_attention` (its kernel
on CUDA in bf16, the JAX package's plain einsum attention on the CPU and in
fp32), which reads the caches where they lie: the self cache's valid
positions only, and cross K/V held once per image for all of its beams. Module and parameter names are those of torch's
``nn.TransformerDecoderLayer`` (``self_attn``/``multihead_attn`` with a
packed ``in_proj_weight``, ``linear1``/``linear2``, ``norm1..3``), so the
reference's state dicts load unchanged.

Numerics follow the JAX package: fp32 parameters, dense layers computed in
``dtype``, LayerNorm in fp32 and cast back, fp32 softmax, masked logits at
−1e9. The decode caches are written in place.

Dropout in training draws every bit from the :class:`torch.Generator` the
caller passes down (``generator=``): the sublayer and FFN masks, and the
seed of the attention kernel's in-kernel dropout. Training with dropout
and no generator raises, so a step is reproducible from its seed.

Tensor parallelism (``parallel/mesh.py shard_module_``): a layer whose
``shards`` is ``model`` > 1 holds its rank's N / model heads of both
attentions and F / model columns of the FFN, and runs inside a step that
publishes the model group (``ops/_mesh.py``). The input of each
column-split block (the self-attention's x, the cross-attention's x and
visual tokens, the FFN's x) goes through ``copy_to_model_group``; each
row-split product (``out_proj``, ``linear2``) is a partial sum, summed
over the group in fp32 by ``reduce_from_model_group``, and its bias is
added once, after the sum. Dropout stays in lockstep over the group: the
generator draws the same shapes in the same order on every rank, so the
masks of the replicated activations are equal; the FFN's mask is drawn at
the full (B, T, F) and each rank takes its columns; the attention kernel's
seed is offset by ``model_rank · 1000003`` (the JAX package's per-shard
offset), so the shards' keep masks differ. The decode path refuses a
sharded layer.

With ``remat`` each decoder layer runs through
:func:`virtex_tpu_torch.utils.remat.remat` in training (``nn.remat`` of the
layer in the JAX package): the backward recomputes it from the generator's
state before the layer, so the attention kernel runs twice on one seed.
The decode path is never rematerialised.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from virtex_tpu_torch.ops._mesh import (
    active_model_group,
    copy_to_model_group,
    rank_of,
    reduce_from_model_group,
    world_of,
)
from virtex_tpu_torch.ops.attention import fused_attention
from virtex_tpu_torch.ops.decode_attention import decode_attention
from virtex_tpu_torch.utils.remat import remat as remat_call

Cache = Dict[str, torch.Tensor]
# The attention kernel's seed offset per model rank (the JAX package's
# per-shard stride, ``virtex_tpu/ops/attention.py``).
SHARD_SEED_STRIDE = 1000003


class Linear(nn.Linear):
    """Dense layer with fp32 parameters, computed in ``dtype``; weights
    N(0, 0.02), bias zero (the JAX package's ``_dense_init``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        nn.init.normal_(self.weight, std=0.02)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Inverted dropout, as flax's: keep where u >= ``rate`` with u drawn
    from ``generator`` (on x's device), kept values scaled by 1/(1 − rate).
    The identity at rate 0. ``shard`` (rank, parts): ``x`` is part
    ``rank`` of ``parts`` equal column blocks of its last dim; u is drawn
    at the full width and the block's columns are taken."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator "
                         "(generator=)")
    rank, parts = shard
    width = x.shape[-1]
    u = torch.rand(tuple(x.shape[:-1]) + (width * parts,),
                   generator=generator, device=x.device)
    keep = u.narrow(-1, rank * width, width) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def model_group_of(module: nn.Module):
    """The published model group of a layer sharded ``module.shards`` ways
    (None when it is whole); raises when the step published none of that
    size."""
    if module.shards == 1:
        return None
    group = active_model_group()
    if world_of(group) != module.shards:
        raise ValueError(f"{type(module).__name__} holds 1/{module.shards} "
                         f"of its heads: run it in a step that publishes "
                         f"its model group of {module.shards} ranks "
                         f"(ops/_mesh.py kernel_group)")
    return group


def _refuse_sharded(module: nn.Module) -> None:
    if module.shards != 1:
        raise ValueError("the decode path runs on a whole layer; this one "
                         f"is sharded {module.shards} ways")


def sum_shards(partial: torch.Tensor, bias: torch.Tensor, group,
               dtype: torch.dtype) -> torch.Tensor:
    """A row-split product's partial sums summed over ``group`` in fp32,
    then its bias (in ``dtype``, as the layer's) added once."""
    total = reduce_from_model_group(partial, group)
    return (total + bias.to(dtype).float()).to(dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32 (the caller casts back)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


class MultiHeadAttention(nn.Module):
    """q/k/v projections (packed in ``in_proj_weight`` as torch packs them)
    + scaled dot-product attention + output projection.

    ``attention_fn`` is the attention core, :func:`fused_attention`, and
    ``decode_attention_fn`` the decode path's, :func:`decode_attention`; a
    comparison against the plain versions swaps them by name. ``shards`` > 1:
    the packed projection holds this rank's heads of q, k and v, and
    ``out_proj.weight`` their input columns (see the module docstring)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.dropout, self.dtype = dropout, dtype
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * hidden_size, hidden_size).normal_(std=0.02))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_size))
        self.out_proj = Linear(hidden_size, hidden_size, dtype)
        self.attention_fn = fused_attention
        self.decode_attention_fn = decode_attention
        self.shards = 1

    def _project(self, x, part: slice):
        w = self.in_proj_weight[part].to(self.dtype)
        return F.linear(x.to(self.dtype), w, self.in_proj_bias[part].to(
            self.dtype))

    def _split(self, x, n: int):
        """(B, T, n·W) → n tensors (B, T, N, D), views into ``x``; W and N
        are this shard's width and heads."""
        B, T, _ = x.shape
        heads = self.num_heads // self.shards
        D = self.hidden_size // self.num_heads
        return [t.view(B, T, heads, D)
                for t in x.split(heads * D, dim=-1)][:n]

    def _qkv(self, q_in, kv_in):
        W = self.hidden_size // self.shards
        if kv_in is q_in:
            return self._split(self._project(q_in, slice(0, 3 * W)), 3)
        (q,) = self._split(self._project(q_in, slice(0, W)), 1)
        k, v = self._split(self._project(kv_in, slice(W, 3 * W)), 2)
        return q, k, v

    def _out(self, ctx, group=None):
        B, T, N, D = ctx.shape
        ctx = ctx.reshape(B, T, N * D)
        if group is None:
            return self.out_proj(ctx)
        partial = F.linear(ctx.to(self.dtype),
                           self.out_proj.weight.to(self.dtype))
        return sum_shards(partial, self.out_proj.bias, group, self.dtype)

    def forward(self, q_in, kv_in, mask=None,
                generator: Optional[torch.Generator] = None):
        group = model_group_of(self)
        if group is not None:
            same = kv_in is q_in
            q_in = copy_to_model_group(q_in, group)
            kv_in = q_in if same else copy_to_model_group(kv_in, group)
            if mask is not None and mask.shape[1] == self.num_heads > 1:
                n = self.num_heads // self.shards
                mask = mask.narrow(1, rank_of(group) * n, n)
        q, k, v = self._qkv(q_in, kv_in)
        rate = self.dropout if self.training else 0.0
        seed = None
        if rate > 0.0:
            if generator is None:
                raise ValueError("attention dropout in training needs a "
                                 "torch.Generator (generator=)")
            seed = torch.randint(2**31 - 1, (), generator=generator,
                                 device=generator.device)
            if group is not None:
                seed = seed + rank_of(group) * SHARD_SEED_STRIDE
        ctx = self.attention_fn(q, k, v, mask, dropout_rate=rate,
                                dropout_seed=seed)
        return self._out(ctx.to(self.dtype), group)

    # -- KV-cache decode path ------------------------------------------------
    def project_kv(self, kv_in):
        """K/V of the visual tokens, computed once for cross-attention."""
        _refuse_sharded(self)
        k, v = self._split(self._project(kv_in, slice(self.hidden_size,
                                                      None)), 2)
        return k.contiguous(), v.contiguous()

    def decode_self(self, q_in, k_cache, v_cache, position: int):
        """One token against a running cache. q_in (B, 1, H); caches
        (B, Tmax, N, D), written in place at ``position``."""
        _refuse_sharded(self)
        q, k_new, v_new = self._qkv(q_in, q_in)
        k_cache[:, position] = k_new[:, 0]
        v_cache[:, position] = v_new[:, 0]
        ctx = self.decode_attention_fn(q, k_cache, v_cache, position + 1)
        return self._out(ctx), k_cache, v_cache

    def attend_kv(self, q_in, k, v):
        """Attention with precomputed K/V (cross-attention at decode). q_in
        (R, 1, H); k, v (R / n, Tk, N, D): the K/V of row b serve query
        rows [b·n, (b + 1)·n), an image's beams."""
        _refuse_sharded(self)
        (q,) = self._split(self._project(q_in, slice(0, self.hidden_size)), 1)
        ctx = self.decode_attention_fn(q, k, v, k.shape[1],
                                       q.shape[0] // k.shape[0])
        return self._out(ctx)


class DecoderLayer(nn.Module):
    """self-attn → cross-attn(visual) → gelu FFN, post- or pre-norm."""

    def __init__(self, hidden_size: int, num_heads: int,
                 feedforward_size: int, dropout: float = 0.1,
                 norm_type: str = "post", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if norm_type not in ("post", "pre"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.num_heads, self.dropout = num_heads, dropout
        self.feedforward_size = feedforward_size
        self.norm_type, self.dtype = norm_type, dtype
        self.shards = 1
        self.self_attn = MultiHeadAttention(hidden_size, num_heads, dropout,
                                            dtype)
        self.multihead_attn = MultiHeadAttention(hidden_size, num_heads,
                                                 dropout, dtype)
        self.linear1 = Linear(hidden_size, feedforward_size, dtype)
        self.linear2 = Linear(feedforward_size, hidden_size, dtype)
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.norm3 = nn.LayerNorm(hidden_size, eps=1e-5)

    def _drop(self, x, generator):
        return dropout(x, self.dropout if self.training else 0.0, generator)

    def ffn(self, x, generator: Optional[torch.Generator] = None):
        group = model_group_of(self)
        if group is None:
            return self.linear2(self._drop(F.gelu(self.linear1(x)),
                                           generator))
        h = F.gelu(self.linear1(copy_to_model_group(x, group)))
        h = dropout(h, self.dropout if self.training else 0.0, generator,
                    (rank_of(group), self.shards))
        partial = F.linear(h.to(self.dtype), self.linear2.weight.to(
            self.dtype))
        return sum_shards(partial, self.linear2.bias, group, self.dtype)

    def _sub(self, norm, x, fn, generator):
        """A sublayer with its residual, in pre- or post-norm order."""
        if self.norm_type == "pre":
            return x + self._drop(fn(layer_norm(norm, x).to(self.dtype)),
                                  generator)
        return layer_norm(norm, x + self._drop(fn(x), generator)).to(
            self.dtype)

    def forward(self, x, visual, self_mask=None,
                generator: Optional[torch.Generator] = None):
        x = self._sub(self.norm1, x,
                      lambda h: self.self_attn(h, h, self_mask, generator),
                      generator)
        x = self._sub(self.norm2, x,
                      lambda h: self.multihead_attn(h, visual, None,
                                                    generator), generator)
        return self._sub(self.norm3, x, lambda h: self.ffn(h, generator),
                         generator)

    def init_cache(self, visual, batch: int, max_length: int) -> Cache:
        """Empty self-attention K/V plus the visual tokens' cross K/V."""
        _refuse_sharded(self)
        depth = visual.shape[-1] // self.num_heads
        shape = (batch, max_length, self.num_heads, depth)
        ck, cv = self.multihead_attn.project_kv(visual)
        return {"k": visual.new_zeros(shape, dtype=self.dtype),
                "v": visual.new_zeros(shape, dtype=self.dtype),
                "ck": ck, "cv": cv}

    def decode(self, x, cache: Cache, position: int) -> Tuple[torch.Tensor,
                                                                Cache]:
        """One-token step. x: (B, 1, H); the self cache holds B rows, the
        cross K/V B / n rows, each serving n consecutive rows of x."""
        dt = self.dtype
        if self.norm_type == "pre":
            y, k, v = self.self_attn.decode_self(
                layer_norm(self.norm1, x).to(dt), cache["k"], cache["v"],
                position)
            x = x + y
            x = x + self.multihead_attn.attend_kv(
                layer_norm(self.norm2, x).to(dt), cache["ck"], cache["cv"])
            x = x + self.ffn(layer_norm(self.norm3, x).to(dt))
        else:
            y, k, v = self.self_attn.decode_self(x, cache["k"], cache["v"],
                                                 position)
            x = layer_norm(self.norm1, x + y).to(dt)
            x = layer_norm(self.norm2, x + self.multihead_attn.attend_kv(
                x, cache["ck"], cache["cv"])).to(dt)
            x = layer_norm(self.norm3, x + self.ffn(x)).to(dt)
        return x, {"k": k, "v": v, "ck": cache["ck"], "cv": cache["cv"]}


class TransformerDecoder(nn.Module):
    """A stack of :class:`DecoderLayer`, with a final LayerNorm (``norm``)
    for pre-norm only."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 feedforward_size: int, dropout: float = 0.1,
                 norm_type: str = "post", dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.layers = nn.ModuleList([
            DecoderLayer(hidden_size, num_heads, feedforward_size, dropout,
                         norm_type, dtype) for _ in range(num_layers)])
        self.norm = (nn.LayerNorm(hidden_size, eps=1e-5)
                     if norm_type == "pre" else None)

    def _final(self, x):
        return x if self.norm is None else layer_norm(self.norm, x).to(
            self.dtype)

    def forward(self, x, visual, self_mask=None,
                generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = (remat_call(layer, x, visual, self_mask, generator=generator)
                 if self.remat else layer(x, visual, self_mask, generator))
        return self._final(x)

    def init_cache(self, visual, batch: int, max_length: int) -> List[Cache]:
        return [l.init_cache(visual, batch, max_length) for l in self.layers]

    def decode(self, x, caches: List[Cache], position: int):
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode(x, cache, position)
            new_caches.append(cache)
        return self._final(x), new_caches


def make_self_attention_mask(tokens: torch.Tensor, lengths: torch.Tensor,
                             causal: bool,
                             ) -> torch.Tensor:
    """Boolean mask, True = attend: key padding (positions ≥ length
    masked) and, if ``causal``, the future, (B, 1, T, T); without
    ``causal`` the key padding alone, (B, 1, 1, T), which the attention
    broadcasts over the queries."""
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    return mask
