r"""
The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``portbench/reference``) on the same
inputs, which the benchmark makes from the seed and hands to both.

Training (``train_*``): the reference follows the run's first three
updates from the drawn weights, on the same batches and dropout seeds.
Per leaf, two norms are held against the reference's:

- ``grad``: of the first gradient as the optimizer took it (clipped,
  before decay), worked out from the program's momentum trace after one
  update (the trace minus the decay term);
- ``change``: of each parameter's change over the three updates.

A leaf's gap is |‖program‖ − ‖reference‖| over the larger of the
reference leaf's norm and its group's median leaf's. Leaves whose first
reference gradient is under a thousandth of the median leaf's are left
out (they move by round-off alone). The leaves are grouped by the
model's top-level module (``visual``, ``textual``, ``backward_textual``),
and each group gives its median and its worst leaf's gap
(``grad_median_gap.<group>``, ``grad_worst_gap.<group>``, and the same
for ``change``), so a fault that stays inside one head moves that head's
numbers. A cell compares the numbers its limits file names; the rest,
and the relative gaps of the first and the worst update's loss, are
printed beside them (``PERF.md`` gives why).

Captioning (``caption_*``): on a sample of the served batches, drawn from
the seed, the reference encodes the images and reads each served caption
token by token (``reference/beam.py token_gaps``): every token that beam
search returns lies within the top K of the first distribution or the
top 2 of its parent's. ``caption_gap`` is the widest amount, in nats, by
which a served token's reference log-probability lies below that bound:
the beam-search form of a greedy token's gap below the reference's best.
"""
from __future__ import annotations

import contextlib
import re
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from portbench import inputs
from portbench.reference import beam, model as ref
from portbench.reference.optim import Chain, Hyper, decays

TEXTUAL = re.compile(r"transdec_postnorm::L(\d+)_H(\d+)_A(\d+)_F(\d+)")
GRAD_FLOOR = 1e-3  # leaves below this share of the median gradient: out
CHECKED_STEPS = 3  # the updates the reference follows
CALIBRATION_IMAGES = 64


def dims_of(cfg: dict) -> ref.Dims:
    m = TEXTUAL.fullmatch(cfg["MODEL"]["TEXTUAL"]["NAME"])
    if m is None:
        raise ValueError("the reference runs post-norm transformer heads")
    L, H, A, F = (int(g) for g in m.groups())
    D = cfg["DATA"]
    return ref.Dims(hidden=H, heads=A, feedforward=F, layers=L,
                    vocab=D["VOCAB_SIZE"], max_length=D["MAX_CAPTION_LENGTH"],
                    dropout=cfg["MODEL"]["TEXTUAL"]["DROPOUT"],
                    pad=D["UNK_INDEX"], sos=D["SOS_INDEX"],
                    eos=D["EOS_INDEX"])


def hyper_of(cfg: dict) -> Hyper:
    O = cfg["OPTIM"]
    return Hyper(lr=O["LR"], cnn_lr=O["CNN_LR"], momentum=O["SGD_MOMENTUM"],
                 weight_decay=O["WEIGHT_DECAY"], no_decay=O["NO_DECAY"],
                 clip=O["CLIP_GRAD_NORM"], warmup=O["WARMUP_STEPS"],
                 total=O["NUM_ITERATIONS"],
                 lookahead_k=O["LOOKAHEAD"]["STEPS"],
                 lookahead_alpha=O["LOOKAHEAD"]["ALPHA"])


@contextlib.contextmanager
def fp32_reference():
    """TF32 off for the reference's fp32 products, and cuDNN's autotuning
    off (it would time every fp32 shape anew in each run); the program's
    flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags


# -- training -----------------------------------------------------------------
def train_batch(run, index: int, device):
    cfg = run.config_file["config"]
    t = run.traffic
    lengths = inputs.caption_lengths(t["caption_length_counts"])
    return inputs.train_batch(
        run.seed, index % t["pool_batches"], lengths,
        cfg["DATA"]["IMAGE_CROP_SIZE"], cfg["DATA"]["MAX_CAPTION_LENGTH"],
        cfg["DATA"]["VOCAB_SIZE"], device, sos=cfg["DATA"]["SOS_INDEX"],
        eos=cfg["DATA"]["EOS_INDEX"])


def train_reference(run, shapes, device, cast=ref.identity,
                    steps: int = CHECKED_STEPS, batch_fn=None) -> dict:
    """The reference's first ``steps`` updates: losses, each update's
    global gradient norm before the clip and whether it landed Lookahead,
    and per leaf the norm of the first clipped gradient and of the change
    over them.
    ``batch_fn(run, index, device)`` gives the batches (``train_batch``
    when None)."""
    with fp32_reference():
        return _train_reference(run, shapes, device, cast, steps,
                                batch_fn or train_batch)


def _train_reference(run, shapes, device, cast, steps, batch_fn) -> dict:
    cfg = run.config_file["config"]
    d, h = dims_of(cfg), hyper_of(cfg)
    w0 = inputs.draw_weights(shapes, run.seed, device)
    params = {n: w0[n].clone().requires_grad_(True) for n, _ in shapes}
    chain = Chain(params, h, start=run.traffic["start_iteration"])
    losses, norms, syncs, first = [], [], [], {}
    for k in range(steps):
        batch = batch_fn(run, k, device)
        gen = inputs.generator(run.seed, "dropout", k, device)
        loss = ref.bicaptioning_loss(params, d, batch, gen, cast,
                                     remat=True)[0]
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        clipped = chain.step(params, dict(zip(params, grads)))
        norms.append(chain.last_norm)
        syncs.append(chain.last_sync)
        if k == 0:
            first = {n: float(u.double().norm()) for n, u in clipped.items()}
        del loss, grads, clipped, batch
    change = {n: float((params[n].detach() - w0[n]).double().norm())
              for n in params}
    return {"losses": losses, "norms": norms, "syncs": syncs,
            "first": first, "change": change}


def program_norms(run, w0: Dict[str, torch.Tensor], trace1: Dict,
                  params3: Dict) -> Tuple[dict, dict]:
    """Per leaf, from the program's state: the first gradient as its
    optimizer took it (momentum trace after one update, less the coupled
    decay of the initial weights), and the change over three updates."""
    h = hyper_of(run.config_file["config"])
    first, change = {}, {}
    for n, p0 in w0.items():
        t = trace1[n].to(p0.device, torch.float64)
        if decays(n, h.no_decay):
            t = t - h.weight_decay * p0.double()
        first[n] = float(t.norm())
        change[n] = float((params3[n].to(p0.device).double()
                           - p0.double()).norm())
    return first, change


def leaf_gaps(prog: dict, refn: dict, keep: List[str]) -> Dict[str, float]:
    """Per leaf of ``keep``, |‖program‖ − ‖reference‖| over the larger of
    the reference leaf's norm and the median of ``keep``'s."""
    med = statistics.median(refn[n] for n in keep)
    return {n: abs(prog[n] - refn[n]) / max(refn[n], med) for n in keep}


def group_of(name: str) -> str:
    """A leaf's group: the model's top-level module that holds it."""
    return name.split(".")[0]


def train_readings(prog: dict, refr: dict) -> Dict[str, Tuple[float, str]]:
    """``prog`` and ``refr``: {"losses", "first", "change"}. Per group of
    leaves, the median and the worst leaf's gap of the first gradient and
    of the change; the loss gaps beside them."""
    med = statistics.median(refr["first"].values())
    keep = [n for n, v in refr["first"].items() if v >= GRAD_FLOOR * med]
    losses = [abs(a - b) / abs(b)
              for a, b in zip(prog["losses"], refr["losses"])]
    out = {"loss1_gap": (losses[0], "update 1"),
           "loss_worst_gap": max((g, f"update {i + 1}")
                                 for i, g in enumerate(losses))}
    groups = sorted({group_of(n) for n in keep})
    for key, name in (("first", "grad"), ("change", "change")):
        for g in groups:
            members = [n for n in keep if group_of(n) == g]
            gaps = leaf_gaps(prog[key], refr[key], members)
            out[f"{name}_median_gap.{g}"] = (
                statistics.median(gaps.values()),
                f"median of {len(members)} leaves")
            worst = max(gaps, key=gaps.get)
            out[f"{name}_worst_gap.{g}"] = (gaps[worst], worst)
    return out


def compared(readings: Dict[str, Tuple[float, str]], limits: dict
             ) -> List[Tuple[str, float, float]]:
    """(name, reading, limit) of every number the cell's limits name; a
    number the run could not read counts as infinite."""
    return [(name, readings.get(name, (float("inf"), ""))[0], limit)
            for name, limit in limits.items()]


# -- captioning ---------------------------------------------------------------
def calibration(w: Dict[str, torch.Tensor], run, device) -> dict:
    """BatchNorm running statistics for the drawn weights: each layer's
    batch statistics over calibration images drawn from the seed."""
    cfg = run.config_file["config"]
    imgs = inputs.images(run.seed, 0, CALIBRATION_IMAGES,
                         cfg["DATA"]["IMAGE_CROP_SIZE"], device,
                         stream="calibration")
    stats: dict = {}
    with fp32_reference(), torch.no_grad():
        ref.resnet50(w, imgs, train=False, calib=stats)
    return stats


def _next_fn(w, d, grid_rows, cast):
    def next_fn(tokens):
        with torch.no_grad():
            logits = ref.decoder(w, d, "textual", grid_rows, tokens, None,
                                 None, cast)[:, -1]
        return torch.log_softmax(logits.float(), dim=-1)
    return next_fn


def reference_captions(run, w: Dict[str, torch.Tensor],
                       images: torch.Tensor, device,
                       cast=ref.identity) -> torch.Tensor:
    """(B, steps) captions of the reference's own beam search, computed
    through ``cast``."""
    cfg = run.config_file["config"]
    d = dims_of(cfg)
    K = cfg["MODEL"]["DECODER"]["BEAM_SIZE"]
    steps = cfg["MODEL"]["DECODER"]["MAX_DECODING_STEPS"]
    with fp32_reference(), torch.no_grad():
        low = ref.resnet50(w, images, train=False, cast=cast)
        return beam.beam_search(
            _next_fn(w, d, low.repeat_interleave(K, dim=0), cast),
            images.shape[0], K, steps, d.sos, d.eos, device)


def caption_gaps(run, w: Dict[str, torch.Tensor], images: torch.Tensor,
                 served: Optional[torch.Tensor], device,
                 cast=ref.identity) -> torch.Tensor:
    """Per image of one batch, the widest token gap (``beam.token_gaps``)
    of the served caption under the fp32 reference; with ``served`` None,
    of the caption that the reference's own beam search gives when
    computed through ``cast`` (the control)."""
    if served is None:
        served = reference_captions(run, w, images, device, cast)
    cfg = run.config_file["config"]
    d = dims_of(cfg)
    K = cfg["MODEL"]["DECODER"]["BEAM_SIZE"]
    with fp32_reference(), torch.no_grad():
        grid = ref.resnet50(w, images, train=False)
        gaps = beam.token_gaps(_next_fn(w, d, grid, ref.identity),
                               served.to(device), d.sos, d.eos, K)
    return gaps.max(dim=1).values


def caption_scores(run, w: Dict[str, torch.Tensor], images: torch.Tensor,
                   captions: torch.Tensor, device) -> torch.Tensor:
    """(B,) each caption's score under the fp32 reference, as beam search
    sums it (``beam.scores``)."""
    d = dims_of(run.config_file["config"])
    with fp32_reference(), torch.no_grad():
        grid = ref.resnet50(w, images, train=False)
        return beam.scores(_next_fn(w, d, grid, ref.identity),
                           captions.to(device), d.sos, d.eos)
