r"""
The ``caption_moe`` traffic kind: the program's caption call
(``engine/captioner.py make_caption_fn`` with the decoder of
``factories.CaptionDecoderFactory``) over a captioning model whose textual
head is the latent-attention, routed-expert decoder
(``MODEL.TEXTUAL.NAME: moe_mla::…``), built by ``PretrainingModelFactory``
and run in eval mode, in a closed loop, one batch at a time, as
``scripts/eval_captioning.py`` runs it.

Weights: the ResNet's as ``inputs.draw_weights`` draws them (its
BatchNorm statistics calibrated as ``kinds/caption.py`` does, the
calibration left out of ``setup_s``); the head's drawn here (:func:
`draw_textual`), since ``inputs.init_rule`` has no rule for a 3-D expert
tensor: every matrix and stacked expert N(0, 0.02), the router's
correction bias N(0, 0.02), norm scales 1 and biases 0.

Set-up captions two batches (the first eager, the second captures each
decode step's CUDA graph). In the window each batch is timed from the
start of its caption call to its tokens on the host. After the window the
reference (``reference/latent_moe.py``) reads a sample of the served
batches drawn from the seed: one causal pass per block of images over the
prefix and each served caption, whose logits are read by
``reference/beam.py token_gaps``' rule. The compared number is
``caption_gap``, the widest token gap, as in the H2048 cell.

At drawn weights the router is near-uniform: many rows lie within
rounding of the top-6 boundary, and there any rounding (bf16, or fp32 in
another order of sums) swaps an expert and moves the row by a whole
expert's share, far more than the rounding itself. So before the program
is freed it prepares data for the check (:func:`program_routing`): it
replays each checked batch's captions through its own prefill and decode
steps at the served shape (every step eager, the same kernels at the same
shapes as the served replays) and hands over the experts it chose at each
position. The reference takes that choice where it is a near-tie under
its own scores, within ``NEAR_TIE``, and its own everywhere else
(``reference/latent_moe.py near_ties``). The replay's own log-probabilities
read every served token inside the bound (its gap, printed, is 0), which
shows that it recomputed what was served.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import checks, inputs
from portbench.kinds import caption, common
from portbench.reference import beam
from portbench.reference import latent_moe as ref
from portbench.reference.model import Precision

WARMUP_BATCHES = 2
CHECK_BLOCK = 32  # images a reference pass holds
# Score (sigmoid + correction bias) by which an expert the program left
# out may lie above one it took in, for the reference to take the
# program's choice at that row: 1.6 times the most that bf16 rounding
# was seen to cost (0.091; PERF.md §2 gives the readings).
NEAR_TIE = 0.15


def _is_norm(name: str) -> bool:
    return "norm" in name and name.endswith("weight")


def textual_rule(name: str, shape) -> tuple:
    """(mean, std) of a head parameter's draw."""
    if len(shape) >= 2 or name.endswith("e_score_correction_bias"):
        return 0.0, 0.02
    return (1.0 if _is_norm(name) else 0.0), 0.0


@torch.no_grad()
def draw_textual(shapes, seed: int, device, out: Dict = None) -> Dict:
    """The head's parameters (names under ``textual.``) drawn one after
    another from one generator of the seed; into ``out``'s tensors where
    given."""
    gen = inputs.generator(seed, "weights", 1, device)
    drawn = {}
    for name, shape in shapes:
        mean, std = textual_rule(name, shape)
        t = out[name] if out is not None else torch.empty(
            shape, device=device)
        if std:
            t.normal_(mean, std, generator=gen)
        else:
            t.fill_(mean)
        drawn[name] = t
    return drawn


def split_shapes(shapes):
    visual = [(n, s) for n, s in shapes if not n.startswith("textual.")]
    textual = [(n, s) for n, s in shapes if n.startswith("textual.")]
    return visual, textual


class Session(caption.Session):
    def __init__(self, run):
        from virtex_tpu_torch.config import ModelSpec
        from virtex_tpu_torch.engine.captioner import make_caption_fn
        from virtex_tpu_torch.factories import CaptionDecoderFactory
        self.run = run
        cfg = run.config
        spec = ModelSpec.from_config(cfg)
        self.device = torch.device(run.device)
        common.set_backend_flags(cfg)
        self.model = common.build_model(cfg, self.device)
        self.shapes = common.parameter_shapes(self.model)
        visual, textual = split_shapes(self.shapes)
        params = dict(self.model.named_parameters())
        draw_textual(textual, run.seed, self.device, out=params)
        weights = inputs.draw_weights(visual, run.seed, self.device)
        t_cal = time.perf_counter()
        weights.update(checks.calibration(weights, run, self.device))
        common.sync(self.device)
        self.calibration_s = time.perf_counter() - t_cal
        common.load_weights(self.model, weights)
        del weights
        self.model.eval()
        self.spec = spec
        self.caption_fn = make_caption_fn(
            self.model, CaptionDecoderFactory.from_spec(spec),
            spec.sos_index, spec.prefix_mode)
        t = run.traffic
        self.batch = int(t["batch"])
        self.pool = [caption.pool_images(run, i, self.device)
                     for i in range(int(t["pool_batches"]))]
        self.k = 0
        self.served = {}


def run(run) -> dict:
    t = run.traffic
    s = Session(run)
    for _ in range(WARMUP_BATCHES):
        s.unit()
    common.sync(s.device)
    setup_s = time.time() - run.t_start - s.calibration_s
    print(f"set-up {setup_s:.3f} s, of it building kernels "
          f"{common.build_seconds():.3f} s; the reference's calibration "
          f"{s.calibration_s:.3f} s left out", flush=True)
    times, n, window, traced = common.window(run, s, int(t["trace_units"]))
    device = common.device_info(s.device)
    served = s.served
    eos = run.config_file["config"]["DATA"]["EOS_INDEX"]
    ended = sum(int((c == eos).any(dim=1).sum()) for c in served.values())
    times_ms = sorted(1e3 * x for x in times)
    print(f"window {window:.3f} s, {n} batches, batch ms median "
          f"{times_ms[len(times_ms) // 2]:.3f}; of the last captions of "
          f"each pool batch, {ended} of {len(served) * s.batch} hold EOS",
          flush=True)
    t_check = time.perf_counter()
    routing = {}
    for i in checked(run, served, int(t["check_batches"])):
        routing[i], own = program_routing(s, caption.pool_images(
            run, i, s.device), served[i])
        print(f"batch {i}: the program's replay of its captions reads "
              f"{own:.4f} nats against its own log-probabilities", flush=True)
    shapes, dev = s.shapes, s.device
    del s
    common.free(dev)
    gap = check(run, served, routing, shapes, dev)
    print(f"check {time.perf_counter() - t_check:.3f} s", flush=True)
    return {"end_to_end": {
                "caption_images_per_s": n * int(t["batch"]) / window,
                "setup_s": setup_s},
            "trace": traced, "attempted": n * int(t["batch"]), "failed": 0,
            "device": device,
            "checks": [("caption_gap", gap, run.limits["caption_gap"])]}


@torch.no_grad()
def program_routing(s: Session, images: torch.Tensor,
                    captions: torch.Tensor) -> tuple:
    """The program's captions (B, steps) of ``images`` replayed through its
    own prefill and decode steps at the served shape (K rows an image, each
    the image's caption; the row's arithmetic does not depend on the other
    rows). Returns (routing, gap): per decoder layer None (dense) or the
    experts (B, P + steps, k) it chose at each prefix and caption position,
    −1 at the prefix in the last layer, whose FFN the prefill leaves out;
    and the widest token gap of the captions under the replay's own
    log-probabilities."""
    from virtex_tpu_torch.modules import latent_moe as M
    cfg = s.run.config_file["config"]
    sos, eos = cfg["DATA"]["SOS_INDEX"], cfg["DATA"]["EOS_INDEX"]
    K = cfg["MODEL"]["DECODER"]["BEAM_SIZE"]
    model, head = s.model, s.model.textual
    d, L = head.dims, head.decoder.num_layers
    B, steps = captions.shape
    caps = captions.to(s.device).long()
    with torch.inference_mode(), head.decoding(), \
            M.record_routing() as log:
        grid = model.encode_visual(images)
        per_beam, per_image = head.split_cache(
            model.init_decode(grid, cfg["MODEL"]["DECODER"][
                "MAX_DECODING_STEPS"]))
        caches = head.join_cache(
            [{k: v.repeat_interleave(K, 0) for k, v in c.items()}
             for c in per_beam], per_image)
        prefill = len(log)
        P = caches[0]["prefix"].shape[1]
        rows = caps.repeat_interleave(K, 0)

        def next_fn(_):  # token_gaps asks for steps 0, 1, … in turn
            t = next_fn.t
            next_fn.t += 1
            token = rows[:, t - 1] if t else torch.full_like(rows[:, 0], sos)
            logits, _ = model.decode_step(token, t, caches)
            return torch.log_softmax(logits[::K].float(), -1)
        next_fn.t = 0
        own = float(beam.token_gaps(next_fn, caps, sos, eos, K).max())
    routed = L - d.first_k_dense_replace
    out = [None] * L
    for j in range(routed):
        r = torch.full((B, P + steps, d.num_experts_per_tok), -1,
                       dtype=torch.long)
        if j < prefill:
            r[:, :P] = log[j].view(B, P, -1).cpu()
        for t in range(steps):
            r[:, P + t] = log[prefill + t * routed + j][::K].cpu()
        out[d.first_k_dense_replace + j] = r
    return out, own


def reference_weights(run, shapes, device) -> Dict:
    """Every parameter as the run drew it, the BatchNorm statistics as
    calibrated, fp32."""
    visual, textual = split_shapes(shapes)
    w = inputs.draw_weights(visual, run.seed, device)
    w.update(checks.calibration(w, run, device))
    w.update(draw_textual(textual, run.seed, device))
    return w


def token_gaps(run, w, images, captions, device, routing=None,
               block: int = CHECK_BLOCK, log=None,
               tie: float = NEAR_TIE) -> torch.Tensor:
    """(B, steps) token gaps of the captions (B, steps) under the fp32
    reference: per block of images one causal pass over the prefix, the
    start token and the caption but its last token, whose
    log-probabilities ``beam.token_gaps`` reads step by step; the given
    ``routing`` (:func:`program_routing`'s) taken at near-ties within
    ``tie``. ``log``
    collects each routed layer's (choice, cost) (``caption_logits``)."""
    cfg = run.config_file["config"]
    c = ref.sizes(run.config_file)
    sos, eos = cfg["DATA"]["SOS_INDEX"], cfg["DATA"]["EOS_INDEX"]
    K = cfg["MODEL"]["DECODER"]["BEAM_SIZE"]
    out = []
    with checks.fp32_reference(), torch.no_grad():
        for a in range(0, images.shape[0], block):
            caps = captions[a:a + block].to(device).long()
            grid = checks.ref.resnet50(w, images[a:a + block], train=False)
            tokens = torch.cat((torch.full_like(caps[:, :1], sos),
                                caps[:, :-1]), 1)
            given = None if routing is None else [
                None if r is None else r[a:a + block].to(device)
                for r in routing]
            lp = torch.log_softmax(ref.caption_logits(
                w, c, grid, tokens, routing=given, tie=tie, log=log),
                -1)
            steps = iter(lp.unbind(1))
            out.append(beam.token_gaps(lambda _: next(steps), caps, sos,
                                       eos, K))
            del lp, steps
    return torch.cat(out)


def reference_captions(run, w, images, device, cast=Precision()):
    """(B, steps) captions of the reference's own beam search through
    ``cast``: each step a causal pass over the prefix, the start token
    and the beam's tokens."""
    cfg = run.config_file["config"]
    c = ref.sizes(run.config_file)
    sos, eos = cfg["DATA"]["SOS_INDEX"], cfg["DATA"]["EOS_INDEX"]
    K = cfg["MODEL"]["DECODER"]["BEAM_SIZE"]
    steps = cfg["MODEL"]["DECODER"]["MAX_DECODING_STEPS"]
    calls = []
    with checks.fp32_reference(), torch.no_grad():
        grid = checks.ref.resnet50(w, images, train=False, cast=cast)
        grid = grid.repeat_interleave(K, 0)

        def next_fn(tokens):  # beam.py drops the start token after step 0
            start = torch.full_like(tokens[:, :1], sos)
            seq = start if not calls else torch.cat((start, tokens), 1)
            calls.append(1)
            return torch.log_softmax(
                ref.caption_logits(w, c, grid, seq, cast)[:, -1], -1)
        return beam.beam_search(next_fn, images.shape[0], K, steps, sos, eos,
                                device)


def checked(run, served: dict, batches: int) -> list:
    """``batches`` of the served batches' indices, drawn from the seed."""
    gen = inputs.generator(run.seed, "sample", 0, "cpu")
    indices = sorted(served)
    pick = torch.randperm(len(indices), generator=gen)[:batches].tolist()
    return sorted(indices[j] for j in pick)


def check(run, served: dict, routing: dict, shapes, device) -> float:
    """The widest token gap of the served batches of ``routing`` (index →
    :func:`program_routing`'s routing)."""
    w = reference_weights(run, shapes, device)
    widest = 0.0
    for i, given in routing.items():
        g = token_gaps(run, w, caption.pool_images(run, i, device),
                       served[i], device, given)
        widest = max(widest, float(g.max()))
        print(f"caption gap, batch {i}: widest {float(g.max()):.4f} nats; "
              f"{int((g > 0).any(1).sum())} of {g.shape[0]} captions hold "
              f"a token outside the bound", flush=True)
    return widest
