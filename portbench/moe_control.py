r"""
The readings that the limit of ``caption.kimivl_a3b.beam`` is set from,
never run by the benchmark's own runs:

    python3 -m portbench.moe_control --seeds <n> [<n> ...] \
        [--control-images 16] [--ties <score> ...]

For each seed, one JSON line with the token gaps (``kinds/caption_moe.py
token_gaps``, the given routing taken at near-ties within ``NEAR_TIE``;
per reading the widest, which ``caption_gap`` is, the mean of each
caption's widest and the share of tokens outside the bound) and the
routing's near-ties (the share of rows whose given choice differs from the
reference's own, the largest cost taken, the rows refused) of

- ``program``: the program's third call on the seed's first pool batch (a
  replay of the decode graphs), as the timed path serves it, its routing
  from ``caption_moe.program_routing`` (``own``: the replay's gap against
  its own log-probabilities, 0 where it recomputed what was served);
- each fault of ``FAULTS`` planted in the program's new code, on the same
  batch through a fresh caption function (its first call eager, so the
  fault reaches every step), its routing replayed with the fault planted:
  the routing weights left unscaled (``routed_scaling_factor`` dropped)
  and the rope half of the latent key dropped (``k_rope`` zero in the
  cache and in the prefill);
- ``control_fp8``: the reference's own beam search with fp8 products
  (``reference/model.py FP8``: e4m3 operands), one precision below the
  configuration's bf16, on the batch's first ``--control-images`` images,
  its routing the fp8 reference's own in one causal pass over its
  captions;
- ``reference_fp32``: the same in fp32, which reads 0 by the rule's
  construction where the given routing takes out the near-ties (a check
  of the check).

Each ``--ties`` value besides ``NEAR_TIE`` adds every reading again under
``<name>@<tie>`` (``inf``: the given choice taken at every row).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from portbench import checks, harness
from portbench.kinds import caption_moe, common
from portbench.reference import latent_moe as ref
from portbench.reference.model import FP8, Precision

WORKLOAD = "caption.kimivl_a3b.beam"


def unscaled_routing(M):
    route = M.route

    def patched(W, p, y, d):
        choice, weights = route(W, p, y, d)
        return choice, weights / d.routed_scaling_factor
    return "route", patched


def no_rope_key(M):
    latent = M.latent

    def patched(W, p, y, angles, d):
        out = latent(W, p, y, angles, d).clone()
        out[..., d.kv_lora_rank:] = 0
        return out
    return "latent", patched


FAULTS = {"unscaled_routing": unscaled_routing, "no_rope_key": no_rope_key}


@contextlib.contextmanager
def planted(fault):
    from virtex_tpu_torch.modules import latent_moe as M
    name, patched = fault(M)
    kept = getattr(M, name)
    setattr(M, name, patched)
    try:
        yield
    finally:
        setattr(M, name, kept)


def readings(run, control_images: int, ties=()) -> dict:
    from virtex_tpu_torch.engine.captioner import make_caption_fn
    from virtex_tpu_torch.factories import CaptionDecoderFactory
    s = caption_moe.Session(run)
    images = s.pool[0]
    for _ in range(2):
        s.caption_fn(images)
    caps = s.caption_fn(images).cpu()
    routing, own = caption_moe.program_routing(s, images, caps)
    given = {"program": (caps, routing)}
    line = {"own": own}
    for name, fault in FAULTS.items():
        with planted(fault):
            fn = make_caption_fn(s.model,
                                 CaptionDecoderFactory.from_spec(s.spec),
                                 s.spec.sos_index, s.spec.prefix_mode)
            caps = fn(images).cpu()
            del fn
            given[name] = (caps, caption_moe.program_routing(
                s, images, caps)[0])
    shapes, device = s.shapes, s.device
    del s
    common.free(device)
    w = caption_moe.reference_weights(run, shapes, device)
    few = images[:control_images]
    for name, cast in (("control_fp8", FP8()),
                       ("reference_fp32", Precision())):
        caps = caption_moe.reference_captions(run, w, few, device, cast)
        given[name] = (caps, reference_routing(run, w, few, caps, device,
                                               cast))
    for tie in (caption_moe.NEAR_TIE, *ties):
        at = "" if tie == caption_moe.NEAR_TIE else f"@{tie}"
        for name, (caps, routing) in given.items():
            line[name + at] = summary(w, run, images[:caps.shape[0]], caps,
                                      routing, device, tie)
    return line


def reference_routing(run, w, images, captions, device, cast) -> list:
    """Per decoder layer None or the experts (B, P + steps, k) that the
    reference through ``cast`` chooses at each position, in one causal
    pass over the prefix, the start token and the captions."""
    cfg = run.config_file["config"]
    c = ref.sizes(run.config_file)
    log = []
    with checks.fp32_reference(), torch.no_grad():
        grid = checks.ref.resnet50(w, images, train=False, cast=cast)
        caps = captions.to(device).long()
        tokens = torch.cat((torch.full_like(caps[:, :1], cfg["DATA"][
            "SOS_INDEX"]), caps[:, :-1]), 1)
        ref.caption_logits(w, c, grid, tokens, cast, log=log)
    dense = c["first_k_dense_replace"]
    return [None] * dense + [choice.cpu() for choice, _ in log]


def summary(w, run, images, captions, routing, device,
            tie: float) -> dict:
    """The widest token gap (``caption_gap``), the mean of each caption's
    widest and the share of tokens outside the bound; the share of rows
    whose given choice differs from the reference's, the largest cost
    taken, the rows whose given choice was refused and the least cost
    refused."""
    log = []
    gaps = caption_moe.token_gaps(run, w, images, captions, device, routing,
                                  log=log, tie=tie)
    cost = torch.cat([c.flatten() for _, c in log])
    known = cost[~cost.isnan()]
    differ = known[known > float("-inf")]
    taken = differ[differ < tie]
    widest = gaps.max(dim=1).values
    return {"max": float(widest.max()), "mean": float(widest.mean()),
            "outside": float((gaps > 0).double().mean()),
            "rows_differ": float(differ.numel() / max(known.numel(), 1)),
            "cost_taken_max": float(taken.max()) if taken.numel() else 0.0,
            "refused": int(differ.numel() - taken.numel()),
            "cost_refused_min": (float(differ[differ >= tie].min())
                                 if differ.numel() > taken.numel() else None)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.moe_control")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-images", type=int, default=16)
    parser.add_argument("--ties", type=float, nargs="*", default=[])
    args = parser.parse_args(argv)
    root = os.getcwd()
    harness.set_cache_dirs(root)
    device = harness.require_cards(1)
    print(f"card: {harness.card_line()}", flush=True)
    for seed in args.seeds:
        a = harness.parse(["--workload", WORKLOAD, "--seed", str(seed),
                           "--seconds", "1"])
        run = harness.resolve(a, root, device, time.time())
        t0 = time.perf_counter()
        line = {"seed": seed, **readings(run, args.control_images,
                                         args.ties),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        common.free(torch.device(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
