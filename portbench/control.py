r"""
The readings that a cell's limits are set from, never run by the
benchmark's own runs:

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

For each seed, one JSON line with the readings of

- ``program``: the program's timed path at the cell's size against the
  fp32 reference (the lower readings come from these, over a dozen seeds
  or more);
- ``control``: the reference put in the program's place, computed one
  precision below the configuration's bf16 (``reference/model.py FP8``:
  e4m3 operands of every product, e5m2 gradients into them), against the
  fp32 reference (the upper readings);
- for training, ``half_batch``: the reference in the program's place on
  the first half of each batch, its losses the mean over that half; and
  two faults planted in the program that stay inside the textual heads
  (``FAULTS``);
- for captioning, two faults of the beam bookkeeping planted in the
  program (``CAPTION_FAULTS``), and beside the token gap each caption's
  score under the fp32 reference against the score of the reference's
  own beam search (``score_gap_mean``, ``score_gap_max``, in nats).

A fault that leaves the state unchanged reads 1 on the change gaps by
their definition and needs no run.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys
import time

import torch

from portbench import checks, harness, inputs
from portbench.kinds import caption, common, train
from portbench.reference import model as ref


# -- faults planted in the program --------------------------------------------
def textual_lr(s):
    """Every leaf stepped at the CNN's learning rate: the textual heads'
    updates 200 times too large."""
    opt = s.optimizer
    opt._lrs = [max(opt._lrs)] * len(opt._lrs)


def self_attention_grad(part: int):
    """A fault that leaves out one part (0 query, 1 key, 2 value) of every
    self-attention's packed projection gradient, as a zero from the
    attention's backward for that input would give."""
    def patch(s):
        for name, p in s.model.named_parameters():
            if ".self_attn.in_proj_" in name:
                H = p.shape[0] // 3

                def hook(g, H=H):
                    g = g.clone()
                    g[part * H:(part + 1) * H] = 0
                    return g
                p.register_hook(hook)
    return patch


FAULTS = {"textual_lr": textual_lr,
          "self_attention_dk": self_attention_grad(1),
          "self_attention_dv": self_attention_grad(2)}


def _train(run, device) -> dict:
    progs = {}
    for key, patch in (("program", None), *FAULTS.items()):
        s = train.Session(run)
        if patch is not None:
            patch(s)
        progs[key] = s.first_steps(checks.CHECKED_STEPS)
        shapes = s.shapes
        del s
        common.free(device)
    refr = checks.train_reference(run, shapes, device)
    w0 = inputs.draw_weights(shapes, run.seed, device)
    out = {}
    for key, prog in progs.items():
        first, change = checks.program_norms(run, w0, prog["trace1"],
                                             prog["params"])
        out[key] = checks.train_readings(
            {"losses": prog["losses"], "first": first, "change": change},
            refr)
    del w0
    out["norms"] = {"program": progs["program"]["norms"],
                    "reference": refr["norms"], "syncs": refr["syncs"]}
    out["control"] = checks.train_readings(
        checks.train_reference(run, shapes, device, cast=ref.FP8()), refr)
    out["half_batch"] = checks.train_readings(checks.train_reference(
        run, shapes, device, batch_fn=_first_half), refr)
    return out


def _first_half(run, index, device):
    """A batch with its second half left out."""
    b = checks.train_batch(run, index, device)
    return {k: v[:v.shape[0] // 2] for k, v in b.items()}


# -- faults of the beam bookkeeping -------------------------------------------
@contextlib.contextmanager
def last_beam(run):
    """The program's beam search returns the last of its K final beams,
    not the best."""
    from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch
    plain = AutoRegressiveBeamSearch.search

    def search(self, start, step_fn, state, only_return_best=True):
        preds, scores = plain(self, start, step_fn, state,
                              only_return_best=False)
        return preds[:, -1], scores[:, -1]
    AutoRegressiveBeamSearch.search = search
    try:
        yield run
    finally:
        AutoRegressiveBeamSearch.search = plain


@contextlib.contextmanager
def greedy(run):
    """The program decodes with one beam: greedy search."""
    file = copy.deepcopy(run.config_file)
    file["config"]["MODEL"]["DECODER"]["BEAM_SIZE"] = 1
    yield dataclasses.replace(run, config_file=file)


CAPTION_FAULTS = {"last_beam": last_beam, "greedy": greedy}


def _served(run, device) -> dict:
    s = caption.Session(run)
    for _ in range(caption.CHECK_BATCHES):
        s.unit()
    served, shapes = s.served, s.shapes
    del s
    common.free(device)
    return served, shapes


def _caption(run, device) -> dict:
    served = {}
    served["program"], shapes = _served(run, device)
    for key, fault in CAPTION_FAULTS.items():
        with fault(run) as broken:
            served[key] = _served(broken, device)[0]
    w = inputs.draw_weights(shapes, run.seed, device)
    w.update(checks.calibration(w, run, device))
    gaps = {k: 0.0 for k in (*served, "control")}
    score_gaps = {k: [] for k in gaps}
    for i in sorted(served["program"]):
        images = caption.pool_images(run, i, device)
        best = checks.caption_scores(run, w, images, checks.reference_captions(
            run, w, images, device), device)
        captions = {k: v[i] for k, v in served.items()}
        captions["control"] = checks.reference_captions(
            run, w, images, device, cast=ref.FP8())
        for key, c in captions.items():
            gaps[key] = max(gaps[key], float(checks.caption_gaps(
                run, w, images, c, device).max()))
            score_gaps[key] += (best - checks.caption_scores(
                run, w, images, c, device)).tolist()
    out = {}
    for key in gaps:
        sg = torch.tensor(score_gaps[key], dtype=torch.float64)
        out[key] = {"caption_gap": (gaps[key], ""),
                    "score_gap_mean": (float(sg.mean()), ""),
                    "score_gap_max": (float(sg.max()), "")}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    root = os.getcwd()
    harness.set_cache_dirs(root)
    for seed in args.seeds:
        a = harness.parse(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", "0"])
        run = harness.resolve(a, root, None, time.time())
        run.device = harness.require_cards(int(run.cell["chips"]))
        kind = run.traffic["kind"]
        t0 = time.time()
        out = _train(run, run.device) if kind == "train" else _caption(
            run, run.device)
        print(json.dumps({"seed": seed, "seconds": time.time() - t0,
                          **out}), flush=True)
        common.free(run.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
