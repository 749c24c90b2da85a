r"""
Plain PyTorch reference of a captioning head built on Kimi-VL-A3B's
language model (the DeepSeek-V3 decoder design; huggingface.co/moonshotai/
Kimi-VL-A3B-Instruct config.json), on a flat dict of fp32 tensors named
as the program's state dict names them under ``textual.``.

- Prefix: the ResNet's (B, 7, 7, 2048) grid through LayerNorm (ε 1e-5),
  Linear, GELU, Linear: 49 tokens at positions 0..48 of the decoder's
  causal sequence; the caption follows (its start token at 49).
- Per layer, pre-norm (RMSNorm, ε ``rms_norm_eps``):
  h = x + MLA(RMSNorm(x)), out = h + FFN(RMSNorm(h)).
  MLA (``q_lora_rank`` null): q = W_q y, per head ``qk_nope_head_dim`` +
  ``qk_rope_head_dim``; [c; k_rope] = W_kva y, c through RMSNorm; [k_nope;
  v] = W_kvb c per head; RoPE (θ ``rope_theta``, interleaved pairs) on the
  rope parts, one key rope part for all heads; softmax of q·k / √(nope +
  rope) under a causal mask; W_o over the heads' contexts.
  FFN: SwiGLU; the first ``first_k_dense_replace`` layers dense (width
  ``intermediate_size``), the others the shared experts (one SwiGLU of
  ``n_shared_experts`` × ``moe_intermediate_size``) plus each token's
  ``num_experts_per_tok`` experts of ``n_routed_experts``, chosen by
  sigmoid score + correction bias, weighted by their scores renormalised
  and times ``routed_scaling_factor``.
- Logits: RMSNorm and the untied LM head.

Routing given from outside: where a caller passes, per routed layer, the
experts another computation (the program) chose at each row, the
reference takes that choice at a row if it is a near-tie under its own
scores: each expert the given choice leaves out of the reference's top k
scores (score + correction bias) less than ``tie`` above each expert it
takes in. Elsewhere the reference keeps its own choice. Near-uniform
routing puts many rows within rounding of a top-k boundary, and there
any rounding swaps an expert, which moves the row's output by a whole
expert's share; the given choice removes that from the comparison and
nothing else.

Every product takes its operands through ``cast`` and its result through
``cast.out`` (``reference/model.py``: the identity for fp32, e4m3 operands
for the control). The sizes come from the configuration file's own
top-level keys (the model's ``config.json`` keys), not from the program.
Nothing here imports the program under test. Departures from the
published model: the vision tower (MoonViT) is the ResNet-50 and the
projector the two-layer MLP above.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.model import Precision

Weights = Dict[str, torch.Tensor]
P = "textual."


def _mm(x, w, cast: Precision):
    """x (..., in) times w (out, in) transposed."""
    return cast.out(cast(x) @ cast(w).t())


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """x (B, S, [N,] d): pair (2i, 2i + 1) turned by pos · θ^(−2i/d)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float64) / d)
    angle = (positions.double()[:, None] * inv).float()     # (S, d/2)
    if x.dim() == 4:
        angle = angle[:, None]
    cos, sin = angle.cos(), angle.sin()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack((a * cos - b * sin, a * sin + b * cos),
                       -1).flatten(-2)


def _swiglu(w, p, y, cast):
    width = w[p + "down_proj"].shape[1]
    gu = _mm(y, w[p + "gate_up_proj"], cast)
    return _mm(F.silu(gu[..., :width]) * gu[..., width:], w[p + "down_proj"],
               cast)


def near_ties(biased: torch.Tensor, own: torch.Tensor,
              given: torch.Tensor, tie: float):
    """(choice, cost) (N, k), (N,) of rows with scores ``biased`` (N, E)
    and own top k ``own``: the ``given`` choice (N, k; a row of −1 gives
    none) where its cost lies under ``tie``, else ``own``. The cost is how
    far the best expert that ``given`` leaves out of ``own`` scores above
    the worst it takes in; −inf where the two sets agree, nan where none
    is given."""
    known = (given >= 0).all(-1)
    g = given.clamp_min(0)
    mine = torch.zeros_like(biased, dtype=torch.bool).scatter_(1, own, True)
    theirs = torch.zeros_like(mine).scatter_(1, g, True)
    left_out = biased.masked_fill(~(mine & ~theirs), float("-inf")).amax(1)
    taken_in = biased.masked_fill(~(theirs & ~mine), float("inf")).amin(1)
    cost = torch.where(known, left_out - taken_in, float("nan"))
    return torch.where((known & (cost < tie))[:, None], g, own), cost


def _routed(w, p, y, c: dict, cast, given=None, tie=0.0, log=None):
    rows = y.reshape(-1, y.shape[-1])
    scores = torch.sigmoid(_mm(rows, w[p + "gate.weight"], cast))
    biased = scores + w[p + "gate.e_score_correction_bias"]
    choice = torch.topk(biased, c["num_experts_per_tok"], dim=-1).indices
    cost = None
    if given is not None:
        choice, cost = near_ties(biased, choice,
                                 given.reshape(choice.shape), tie)
    if log is not None:
        log.append((choice.view(*y.shape[:-1], -1), cost))
    weights = scores.gather(1, choice)
    weights = weights / weights.sum(-1, keepdim=True) \
        * c["routed_scaling_factor"]
    width = c["moe_intermediate_size"]
    out = torch.zeros_like(rows)
    for e in range(c["n_routed_experts"]):
        token, slot = (choice == e).nonzero(as_tuple=True)
        if token.numel() == 0:
            continue
        x = rows[token]
        gu = _mm(x, w[p + "experts.gate_up_proj"][e], cast)
        h = F.silu(gu[:, :width]) * gu[:, width:]
        y_e = _mm(h, w[p + "experts.down_proj"][e], cast)
        out.index_add_(0, token, weights[token, slot][:, None] * y_e)
    return out.view(y.shape)


def _attention(w, p, y, positions, c: dict, cast):
    B, S, _ = y.shape
    N, nope = c["num_attention_heads"], c["qk_nope_head_dim"]
    rd, vd, lora = c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    theta = c["rope_theta"]
    q = _mm(y, w[p + "q_proj"], cast).view(B, S, N, nope + rd)
    q = torch.cat((q[..., :nope], _rope(q[..., nope:], positions, theta)),
                  -1)
    ckv = _mm(y, w[p + "kv_a_proj_with_mqa"], cast)
    latent = _rms(ckv[..., :lora], w[p + "kv_a_layernorm.weight"],
                  c["rms_norm_eps"])
    k_rope = _rope(ckv[..., lora:], positions, theta)
    kv = _mm(latent, w[p + "kv_b_proj"], cast).view(B, S, N, nope + vd)
    k = torch.cat((kv[..., :nope], k_rope[:, :, None].expand(B, S, N, rd)),
                  -1)
    scores = cast.out(torch.einsum("bqnd,bknd->bnqk", cast(q), cast(k)))
    scores = scores / math.sqrt(nope + rd)
    causal = torch.ones(S, S, dtype=torch.bool, device=y.device).tril()
    probs = scores.masked_fill(~causal, float("-inf")).softmax(-1)
    ctx = cast.out(torch.einsum("bnqk,bknd->bqnd", cast(probs),
                                cast(kv[..., nope:])))
    return _mm(ctx.reshape(B, S, N * vd), w[p + "o_proj"], cast)


def sizes(config_file: dict) -> dict:
    """The decoder's sizes from a configuration file's top-level keys."""
    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads",
            "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
            "v_head_dim", "rope_theta", "moe_intermediate_size",
            "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
            "first_k_dense_replace", "routed_scaling_factor", "rms_norm_eps",
            "vocab_size")
    return {k: config_file[k] for k in keys}


def prefix(w: Weights, grid: torch.Tensor, cast=Precision()) -> torch.Tensor:
    """(B, Hg, Wg, C) grid → (B, Hg·Wg, H) prefix tokens."""
    p = P + "visual_projection."
    x = grid.flatten(1, 2)
    x = F.layer_norm(x, (x.shape[-1],), w[p + "norm.weight"],
                     w[p + "norm.bias"])
    x = F.gelu(_mm(x, w[p + "fc1.weight"], cast) + w[p + "fc1.bias"])
    return _mm(x, w[p + "fc2.weight"], cast) + w[p + "fc2.bias"]


def caption_logits(w: Weights, c: dict, grid: torch.Tensor,
                   tokens: torch.Tensor, cast=Precision(), routing=None,
                   tie: float = 0.0, log=None) -> torch.Tensor:
    """(B, T, vocab) fp32 logits, one causal pass over the prefix then
    ``tokens`` (B, T) (the start token first), at the tokens' positions.

    ``routing``: per layer, None or the given choice (B, S, k) at each of
    the S positions (−1 rows give none), taken at near-ties within
    ``tie``; ``log``: a list to which each routed layer appends its
    (choice (B, S, k), cost (B·S,) or None)."""
    x = torch.cat((prefix(w, grid, cast),
                   w[P + "embed_tokens.weight"][tokens.long()]), 1)
    positions = torch.arange(x.shape[1], device=x.device)
    eps = c["rms_norm_eps"]
    for i in range(c["num_hidden_layers"]):
        p = f"{P}decoder.layers.{i}."
        x = x + _attention(w, p + "self_attn.",
                           _rms(x, w[p + "input_layernorm.weight"], eps),
                           positions, c, cast)
        y = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < c["first_k_dense_replace"]:
            x = x + _swiglu(w, p + "mlp.", y, cast)
        else:
            x = x + _swiglu(w, p + "mlp.shared_experts.", y, cast) \
                + _routed(w, p + "mlp.", y, c, cast,
                          None if routing is None else routing[i], tie, log)
    x = _rms(x[:, -tokens.shape[1]:], w[P + "norm.weight"], eps)
    return _mm(x, w[P + "lm_head.weight"], cast)
