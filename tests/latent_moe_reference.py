r"""
A plain fp32 reference of the latent-attention, routed-expert captioning
head (``virtex_tpu_torch/modules/textual_heads.py LatentMoETextualHead``)
for the CPU tests: the DeepSeek-V3 layer equations written out over the
head's state dict, with no cache, no absorption and no dispatch. Imports
nothing of the port or of JAX.

- Prefix: the (B, Hg, Wg, C) grid through LayerNorm, Linear, GELU, Linear.
- Per layer: h = x + MLA(RMSNorm(x)), out = h + FFN(RMSNorm(h)); MLA with
  keys [k_nope; k_rope] and values expanded per head, RoPE on interleaved
  pairs, scores over √(nope + rope), a causal mask; the first
  ``first_k_dense_replace`` FFNs dense SwiGLU, the rest the shared SwiGLU
  plus, per token, its top-k experts by sigmoid score + correction bias,
  weighted by their scores renormalised and scaled.
- Logits: a final RMSNorm and the untied LM head.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Sizes = Dict[str, float]


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x (B, S, [N,] d): pair i of each position turned by pos · θ^(−2i/d)."""
    d = x.shape[-1]
    shape = [1, -1, 1] if x.dim() == 4 else [1, -1]
    out = torch.empty_like(x)
    for i in range(d // 2):
        angle = positions.double() * theta ** (-2.0 * i / d)
        c = angle.cos().float().view(shape)
        s = angle.sin().float().view(shape)
        a, b = x[..., 2 * i], x[..., 2 * i + 1]
        out[..., 2 * i] = a * c - b * s
        out[..., 2 * i + 1] = a * s + b * c
    return out


def swiglu(w, p, y):
    width = w[p + "down_proj"].shape[1]
    gate = y @ w[p + "gate_up_proj"][:width].t()
    up = y @ w[p + "gate_up_proj"][width:].t()
    return (F.silu(gate) * up) @ w[p + "down_proj"].t()


def route(w, p, y, s: Sizes):
    """(choice, weights) per row of y (N, H)."""
    scores = torch.sigmoid(y @ w[p + "gate.weight"].t())
    choice = torch.topk(scores + w[p + "gate.e_score_correction_bias"],
                        int(s["num_experts_per_tok"]), dim=-1).indices
    weights = scores.gather(1, choice)
    weights = weights / weights.sum(-1, keepdim=True)
    return choice, weights * s["routed_scaling_factor"]


def routed(w, p, y, s: Sizes):
    """Σ over each token's chosen experts, token by token."""
    rows = y.reshape(-1, y.shape[-1])
    choice, weights = route(w, p, rows, s)
    width = int(s["moe_intermediate_size"])
    out = torch.zeros_like(rows)
    for n in range(rows.shape[0]):
        for e, g in zip(choice[n].tolist(), weights[n]):
            gu = w[p + "experts.gate_up_proj"][e] @ rows[n]
            h = F.silu(gu[:width]) * gu[width:]
            out[n] += g * (w[p + "experts.down_proj"][e] @ h)
    return out.view(y.shape)


def attention(w, p, y, s: Sizes):
    B, S, _ = y.shape
    N, nope = int(s["num_attention_heads"]), int(s["qk_nope_head_dim"])
    rd, vd = int(s["qk_rope_head_dim"]), int(s["v_head_dim"])
    lora, theta = int(s["kv_lora_rank"]), s["rope_theta"]
    pos = torch.arange(S)
    q = (y @ w[p + "q_proj"].t()).view(B, S, N, nope + rd)
    q = torch.cat((q[..., :nope], rope(q[..., nope:], pos, theta)), -1)
    ckv = y @ w[p + "kv_a_proj_with_mqa"].t()
    c = rms(ckv[..., :lora], w[p + "kv_a_layernorm.weight"],
            s["rms_norm_eps"])
    k_rope = rope(ckv[..., lora:], pos, theta)
    kv = (c @ w[p + "kv_b_proj"].t()).view(B, S, N, nope + vd)
    k = torch.cat((kv[..., :nope], k_rope[:, :, None].expand(B, S, N, rd)),
                  -1)
    v = kv[..., nope:]
    logits = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(nope + rd)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    ctx = torch.einsum("bnqk,bknd->bqnd", logits.softmax(-1), v)
    return ctx.reshape(B, S, N * vd) @ w[p + "o_proj"].t()


def hidden(w, s: Sizes, grid, tokens):
    """(B, P + T, H) after the last layer's residual, for inputs the
    projected grid then ``tokens`` (B, T)."""
    pre = "visual_projection."
    x = grid.flatten(1, 2)
    x = F.layer_norm(x, (x.shape[-1],), w[pre + "norm.weight"],
                     w[pre + "norm.bias"])
    x = F.gelu(x @ w[pre + "fc1.weight"].t() + w[pre + "fc1.bias"])
    x = x @ w[pre + "fc2.weight"].t() + w[pre + "fc2.bias"]
    x = torch.cat((x, w["embed_tokens.weight"][tokens]), 1)
    eps = s["rms_norm_eps"]
    for i in range(int(s["layers"])):
        p = f"decoder.layers.{i}."
        x = x + attention(w, p + "self_attn.",
                          rms(x, w[p + "input_layernorm.weight"], eps), s)
        y = rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < s["first_k_dense_replace"]:
            x = x + swiglu(w, p + "mlp.", y)
        else:
            x = x + swiglu(w, p + "mlp.shared_experts.", y) \
                + routed(w, p + "mlp.", y, s)
    return x


def logits(w, s: Sizes, grid, tokens):
    """(B, T, vocab) at the positions of ``tokens`` (B, T), which follow
    the grid's P prefix tokens."""
    x = hidden(w, s, grid, tokens)[:, -tokens.shape[1]:]
    return rms(x, w["norm.weight"], s["rms_norm_eps"]) @ \
        w["lm_head.weight"].t()
