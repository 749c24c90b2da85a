#!/usr/bin/env python3
r"""
Drives the PyTorch port (``virtex_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root, on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA. It exits non-zero, and
prints no result, when there is no card or when any phase fails:

1. device: the card's name and power limit; TF32 off for every comparison.
2. build: kernel K1 (``virtex_tpu_torch/csrc/attention_fwd.cu``) is built
   with ``nvcc`` for ``sm_90a``.
3. K1 against its plain PyTorch version on the card: the flagship's
   attention shapes (batch 128, 16 heads of 64; self 30×30 causal + pad,
   cross 30×49), a per-head mask, the wide gate shape (640, 30, 79, 32, 64),
   fp32 and bf16, and dropout's keep fraction and seeding.
4. eval step: the flagship ``bicaptioning_R_50_L1_H1024`` at full width in
   bf16 (weights from a numpy seed), batch 32 of captions of varied length.
   Finite losses, exactly 4 K1 launches, and the same losses from a copy
   of the model whose attention calls the plain version.
5. captioning: beam search (K = 5, 30 steps) on 32 images.
6. timings: K1 against the plain version at the eval step's two attention
   shapes and at batch 128 (device time from CUDA-graph replay, and
   back-to-back eager calls), the eval step, and beam captioning.

The line before the last is a JSON object on the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
EVAL_BATCH = 32
# K1 against the plain version, per element |a − b| / (|ref| + ATOL):
# q, k, v ~ N(0, 1), so outputs are O(1) and ATOL = 1 is their scale.
ATOL = 1.0
TOL = {"float32": 1e-5,   # two fp32 sums of ≤ 79 terms in other orders
       "bfloat16": 2e-2}  # a flipped bf16 rounding of P or O is 2^-8
# The eval step's losses, K1 model against the plain-attention model: the
# models differ only in where bf16 attention outputs round (one bf16 ulp,
# 2^-8, at most), and each loss averages ~900 tokens.
LOSS_RTOL = 1e-2
KEEP_RANGE = (0.89, 0.91)  # dropout rate 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(a, ref, atol: float) -> float:
    a, ref = a.double(), ref.double()
    return float(((a - ref).abs() / (ref.abs() + atol)).max())


# -- phase 3 -----------------------------------------------------------------
def attention_inputs(torch, B, Tq, Tk, N, D, dtype, device, seed,
                     packed=False):
    """q (B, Tq, N, D), k and v (B, Tk, N, D) ~ N(0, 1). ``packed``: views
    into one projection, as ``MultiHeadAttention`` passes them (q/k/v of
    (B, Tq, 3·N·D) for self-attention, k/v of (B, Tk, 2·N·D) for cross)."""
    rng = np.random.RandomState(seed)
    draw = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(device, dtype)
    if not packed:
        return [draw(B, T, N, D) for T in (Tq, Tk, Tk)]
    if Tq == Tk:
        return [t.view(B, Tq, N, D) for t in draw(B, Tq, 3 * N * D)
                .split(N * D, dim=-1)]
    k, v = (t.view(B, Tk, N, D) for t in draw(B, Tk, 2 * N * D)
            .split(N * D, dim=-1))
    return [draw(B, Tq, N * D).view(B, Tq, N, D), k, v]


def self_mask(torch, B, T, device, seed, lengths=None):
    """Causal + key padding, lengths drawn in [3, T] (row 0 full)."""
    if lengths is None:
        rng = np.random.RandomState(seed)
        lengths = rng.randint(3, T + 1, B)
        lengths[0] = T
    lengths = torch.as_tensor(lengths, device=device)
    pos = torch.arange(T, device=device)
    key_ok = (pos[None, :] < lengths[:, None])[:, None, None, :]
    return key_ok & (pos[None, :] <= pos[:, None])[None, None]


def check_k1(torch, A, device):
    """K1 against ``attention_reference`` on the card. Returns the largest
    absolute bf16 error at the eval step's shapes, the dropout keep
    fraction, and a summary of the per-case errors."""
    cases = [
        # name, (B, Tq, Tk, N, D), mask kind; "main" cases are the eval
        # step's launches: B=32, q/k/v strided views of one projection
        ("main self 32x30x30 causal+pad", (EVAL_BATCH, 30, 30, 16, 64),
         "causal_pad"),
        ("main cross 32x30x49", (EVAL_BATCH, 30, 49, 16, 64), "none"),
        ("self 128x30x30 causal+pad", (128, 30, 30, 16, 64), "causal_pad"),
        ("cross 128x30x49", (128, 30, 49, 16, 64), "none"),
        ("cross 128x30x49 per-head", (128, 30, 49, 16, 64), "per_head"),
        ("gate 640x30x79x32", (640, 30, 79, 32, 64), "none"),
        ("gate 640x30x30 causal", (640, 30, 30, 16, 64), "causal"),
    ]
    worst = {}
    main_path_err = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (name, (B, Tq, Tk, N, D), kind) in enumerate(cases):
            main = name.startswith("main")
            q, k, v = attention_inputs(torch, B, Tq, Tk, N, D, dtype, device,
                                       SEED + i, packed=main)
            if kind == "causal_pad":
                mask = self_mask(torch, B, Tq, device, SEED + i)
            elif kind == "causal":
                mask = self_mask(torch, B, Tq, device, SEED,
                                 lengths=np.full(B, Tq))
            elif kind == "per_head":
                rng = np.random.RandomState(SEED + i)
                m = rng.rand(B, N, Tq, Tk) > 0.4
                m[..., 0] = True
                mask = torch.from_numpy(m).to(device)
            else:
                mask = None
            before = A.launch_count
            out = A.fused_attention(q, k, v, mask)
            torch.cuda.synchronize()
            if A.launch_count != before + 1:
                fail(f"K1 {name}: fused_attention did not launch K1")
            ref = A.attention_reference(q, k, v, mask)
            if out.shape != ref.shape or out.dtype != ref.dtype:
                fail(f"K1 {name} {dtype_name}: {out.shape} {out.dtype} vs "
                     f"{ref.shape} {ref.dtype}")
            err = rel_err(out, ref, ATOL)
            worst[f"{name} {dtype_name}"] = err
            if not err <= TOL[dtype_name]:
                fail(f"K1 {name} {dtype_name}: error {err:.3e} > "
                     f"{TOL[dtype_name]:.0e}")
            if dtype_name == "bfloat16" and main:
                main_path_err = max(main_path_err,
                                    float((out.float() - ref.float())
                                          .abs().max()))

    # Dropout: q = k = 0 makes P uniform, so with v = 1 the mean output is
    # the kept fraction over (1 − rate) (tests/tpu_attention_parity.py).
    rate = 0.1
    z = torch.zeros(8, 128, 8, 32, device=device)
    ones = torch.ones_like(z)

    def drop(seed):
        return A.fused_attention(z, z, ones, None, rate, seed)

    first, again, other = drop(42), drop(42), drop(43)
    keep = float(first.mean()) * (1.0 - rate)
    if not KEEP_RANGE[0] <= keep <= KEEP_RANGE[1]:
        fail(f"K1 dropout keep fraction {keep:.4f} outside {KEEP_RANGE}")
    if not torch.equal(first, again):
        fail("K1 dropout: the same seed gave another output")
    if torch.equal(first, other):
        fail("K1 dropout: another seed gave the same output")
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return main_path_err, keep, summary


# -- phases 4 and 5 ----------------------------------------------------------
def randomize_(torch, model, seed: int) -> None:
    """Redraw every floating parameter and buffer from a numpy seed,
    keeping each tensor's init mean and spread (std 0.1 where the init is a
    constant: BN and LayerNorm scales and biases, BN statistics, the output
    bias). Tied tensors are drawn once."""
    rng = np.random.RandomState(seed)
    seen = set()
    with torch.no_grad():
        for _, t in sorted(model.state_dict(keep_vars=True).items()):
            if not t.is_floating_point() or t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            mean = float(t.mean())
            std = float(t.std()) if t.numel() > 1 else 0.0
            z = rng.standard_normal(tuple(t.shape)).astype(np.float32)
            t.copy_(torch.from_numpy(mean + (std or 0.1) * z))


def caption_batch(torch, B, image_size, T, vocab, seed, device):
    """``__graft_entry__._synthetic_batch`` with captions of varied length
    ([SOS] words [EOS], padded with 0; ``noitpac_tokens`` reversed)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(5, T + 1, B).astype(np.int32)
    lengths[0] = T
    tokens = np.zeros((B, T), np.int32)
    noitpac = np.zeros_like(tokens)
    for i, n in enumerate(lengths):
        row = np.concatenate([[1], rng.randint(4, vocab, n - 2), [2]])
        tokens[i, :n] = row
        noitpac[i, :n] = row[::-1]
    image = rng.rand(B, image_size, image_size, 3).astype(np.float32)
    batch = {"image": image, "caption_tokens": tokens,
             "noitpac_tokens": noitpac, "caption_lengths": lengths}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def plain_attention_copy(model, A, MultiHeadAttention):
    """A copy of ``model`` whose attention calls the plain version."""
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_fn = A.attention_reference
    return twin


# -- phase 6 -----------------------------------------------------------------
def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 50, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``calls`` back-to-back calls are
    captured in a CUDA graph and replayed, so the host's work between
    launches (which ``cuda_ms`` includes where it exceeds the kernel's
    time) is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean wall time of ``fn`` ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def time_k1(torch, A, device, B, Tq, Tk, causal):
    """K1 and the plain version in turns (plain, K1, K1, plain), bf16, at
    (B, Tq, Tk) with 16 heads of 64. Returns ms per call as
    ``(K1 device, plain device, K1 eager, plain eager)``: device time from
    CUDA-graph replay, and back-to-back eager calls, which include the
    host's launch work."""
    q, k, v = attention_inputs(torch, B, Tq, Tk, 16, 64, torch.bfloat16,
                               device, SEED)
    mask = self_mask(torch, B, Tq, device, SEED) if causal else None
    kernel = lambda: A.fused_attention(q, k, v, mask)  # noqa: E731
    plain = lambda: A.attention_reference(q, k, v, mask)  # noqa: E731
    order = (plain, kernel, kernel, plain)
    p1, k1, k2, p2 = (graph_ms(torch, f) for f in order)
    e1, e2, e3, e4 = (cuda_ms(torch, f, 200) for f in order)
    return (k1 + k2) / 2, (p1 + p2) / 2, (e2 + e3) / 2, (e1 + e4) / 2


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, REPO)
    try:
        from virtex_tpu_torch.config import ModelSpec
        from virtex_tpu_torch.engine.captioner import make_caption_fn
        from virtex_tpu_torch.engine.evaluation import make_eval_step
        from virtex_tpu_torch.models.captioning import CaptioningModel
        from virtex_tpu_torch.modules.transformer import MultiHeadAttention
        from virtex_tpu_torch.ops import _build
        from virtex_tpu_torch.ops import attention as A
        from virtex_tpu_torch.utils.beam_search import (
            AutoRegressiveBeamSearch,
        )
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)

    # 1. device
    card = card_line()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("1 device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | TF32 off for matmul and cuDNN")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "smem" in ln]
    say("2 build", f"K1 built from {os.path.relpath(_build.CSRC, REPO)} for "
        f"sm_90a in {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_build.build_seconds or 0.0:.1f} s); ptxas: {' | '.join(ptxas)}")

    # 3. K1 against the plain version
    k1_err, keep, summary = check_k1(torch, A, device)
    say("3 K1", f"matches the plain version (fp32 tol {TOL['float32']:.0e},"
        f" bf16 tol {TOL['bfloat16']:.0e}, atol {ATOL}): {summary}; "
        f"dropout keep {keep:.4f} at rate 0.1, seeded")

    # 4. eval step, flagship at full width
    spec = ModelSpec.flagship()
    torch.manual_seed(SEED)
    model = CaptioningModel.from_spec(spec)
    randomize_(torch, model, SEED)
    model = model.to(device).eval()
    plain_model = plain_attention_copy(model, A, MultiHeadAttention)
    batch = caption_batch(torch, EVAL_BATCH, spec.image_size,
                          spec.max_caption_length, spec.vocab_size, SEED,
                          device)
    eval_step = make_eval_step(model)
    decoder = AutoRegressiveBeamSearch(spec.eos_index,
                                       spec.max_decoding_steps,
                                       spec.beam_size)
    caption_fn = make_caption_fn(model, decoder, spec.sos_index,
                                 spec.prefix_mode)
    images = batch["image"]

    A.reset_launch_count()          # the main path starts here
    metrics = eval_step(batch)
    eval_launches = A.launch_count
    captions = caption_fn(images)
    torch.cuda.synchronize()
    launches = A.launch_count       # ... and ends here

    losses = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"eval step: non-finite losses {losses}")
    if eval_launches != 4:
        fail(f"eval step launched K1 {eval_launches} times, expected 4 "
             "(self + cross attention in both caption directions)")
    plain = {k: float(v) for k, v in make_eval_step(plain_model)(batch)
             .items()}
    worst = max(abs(losses[k] - plain[k]) / abs(plain[k]) for k in plain)
    if not worst <= LOSS_RTOL:
        fail(f"eval step: K1 losses {losses} vs plain {plain}, relative "
             f"{worst:.2e} > {LOSS_RTOL}")
    say("4 eval step", f"{spec.model_name} {spec.visual_name} "
        f"{spec.textual_name} {spec.dtype} B={EVAL_BATCH}: losses "
        f"{json.dumps(losses)}; plain attention {json.dumps(plain)} "
        f"(rel {worst:.2e} <= {LOSS_RTOL}); K1 launches {eval_launches}")

    # 5. captioning
    if tuple(captions.shape) != (EVAL_BATCH, spec.max_decoding_steps):
        fail(f"captions have shape {tuple(captions.shape)}")
    if captions.dtype not in (torch.int32, torch.int64):
        fail(f"captions have dtype {captions.dtype}")
    lo, hi = int(captions.min()), int(captions.max())
    if lo < 0 or hi >= spec.vocab_size:
        fail(f"caption ids outside [0, {spec.vocab_size}): {lo}..{hi}")
    if launches != eval_launches:
        fail(f"beam search launched K1 {launches - eval_launches} times; "
             "its decode path uses plain attention")
    say("5 captioning", f"beam K={spec.beam_size}, {spec.max_decoding_steps}"
        f" steps: tokens {tuple(captions.shape)} {captions.dtype}, ids in "
        f"[{lo}, {hi}]; first caption {captions[0, :10].tolist()}")

    # 6. timings
    shapes = {"self B32": (EVAL_BATCH, 30, 30, True),
              "cross B32": (EVAL_BATCH, 30, 49, False),
              "self B128": (128, 30, 30, True),
              "cross B128": (128, 30, 49, False)}
    k1_times = {name: time_k1(torch, A, device, *shape)
                for name, shape in shapes.items()}
    eval_ms = host_ms(torch, lambda: eval_step(batch), 20)
    caption_ms = host_ms(torch, lambda: caption_fn(images), 3, warmup=1)
    card = card_line()
    k1_text = "; ".join(
        f"{name} {t[0]:.4f} vs {t[1]:.4f} (eager {t[2]:.4f} vs {t[3]:.4f})"
        for name, t in k1_times.items())
    say("6 timings", f"{card} | K1 vs plain, bf16, device ms per call: "
        f"{k1_text} | eval step B{EVAL_BATCH} {eval_ms:.2f} ms = "
        f"{EVAL_BATCH / eval_ms * 1e3:.1f} img/s | beam captioning "
        f"B{EVAL_BATCH} {caption_ms:.1f} ms per batch")

    # ms: K1's device time per call, the mean over the eval step's
    # launches (one self- and one cross-attention per direction, B=32).
    main = [k1_times["self B32"], k1_times["cross B32"]]
    print(json.dumps({"kernels": [{
        "name": "K1 attention_fwd",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "virtex_tpu/ops/attention.py:87",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": sum(t[0] for t in main) / 2,
        "plain_ms": sum(t[1] for t in main) / 2,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
