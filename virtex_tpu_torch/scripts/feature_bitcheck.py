r"""
Feature bit-check: load one reference ``.pth`` into the port's model and
hold three results to a stored set of the same results:

  1. the eval-mode layer4 grid, ``(B, 7, 7, 2048)`` for ResNet-50 at 224²,
     taken before any train-mode forward (train-mode BatchNorm moves the
     running statistics);
  2. the train-mode loss and each of its components;
  3. d(loss)/d(image), into which the whole backward pass feeds.

Counterpart of ``scripts/feature_bitcheck.py``, the closure's gate before
any quality number is read. The JAX script holds two models in one
process; the port may not import the JAX package, so the comparison goes
through files: ``--write OUT.npz`` stores this run's results and
``--against REF.npz`` holds them to a stored set, written by this script
(on another device) or by the JAX package's side,
``tests/torch_bitcheck_jax.py``, on the same ``.pth``, config, seed and
batch size. All five pretext tasks are supported.

Both sides run in fp32 with dropout 0 (``FORCED_OVERRIDES``); on a card
TF32 is turned off for the run, since TF32 convolutions move a ResNet-50
grid by ~1e-3. The inputs come from :func:`bitcheck_inputs`, numpy only,
the JAX script's draws in its order. Images reach the model in the
port's NHWC layout, and ``dimage`` is stored NHWC.

The metric is per element: ``|a − ref| / (|ref| + s)``, where ``s`` is
the scale of the element's channel, max ``|ref|`` over that channel (the
last axis of the grid and of ``dimage``); a loss's is ``|a − ref| /
|ref|``. With one global scale, as the JAX script's ``_rel_diff`` has, a
drifting low-magnitude channel passes. The npz holds, per task (the
config's ``MODEL.NAME``), ``<task>/grid``, ``<task>/loss``,
``<task>/loss_component/<name>`` and ``<task>/dimage``, and the config,
overrides, seed and batch size they came from, so that the results of
several tasks can share one file.

A ReLU input within fp32 noise of zero may fall on the other side in the
stored run, and that moves every gradient below it well past the input
gradient's gate. So ``--write`` also stores the side of each train-mode
ReLU input near zero, and a run that fails only its train-mode checks
runs them again, at the same gates, on the stored sides, or, against a
set that stores none (the JAX package's), on each choice of sides of the
few inputs nearest zero. Its lines name what it took.

    python -m virtex_tpu_torch.scripts.feature_bitcheck \
        --config configs/task_ablations/bicaptioning_R_50_L1_H2048.yaml \
        --checkpoint-path bicaptioning_R_50_L1_H2048.pth --write card.npz
    python -m virtex_tpu_torch.scripts.feature_bitcheck --device cpu \
        --config configs/task_ablations/bicaptioning_R_50_L1_H2048.yaml \
        --checkpoint-path bicaptioning_R_50_L1_H2048.pth --against card.npz

Exit 0 when every check passes, 1 on any mismatch or a checkpoint that
does not fit the config, 2 on refused arguments.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from virtex_tpu_torch.engine.checkpointing import read_checkpoint
from virtex_tpu_torch.model_zoo import model_zoo

# Forced on every side: fp32 compute and no dropout.
FORCED_OVERRIDES = ["DTYPE", "float32", "MODEL.TEXTUAL.DROPOUT", "0.0"]
# Gates of the per-element metric, at the JAX script's own (1e-3 for the
# grid and losses, 5e-3 for the input gradient) or tighter. Largest
# measured: the grid 5.7e-4 (an H100 against the CPU, R-50 at 224²; a
# channel whose inputs to the last ReLU are far larger than its outputs),
# 2.0e-4 (an H100 against the JAX package, resnet18 at 64²); losses 3.8e-7;
# the input gradient 3.3e-3, and ≤ 2e-5 on one choice of ReLU sides.
GRID_TOL, LOSS_TOL, GRAD_TOL = 1e-3, 1e-5, 5e-3
GRID, LOSS, DIMAGE = "grid", "loss", "dimage"
COMPONENT = "loss_component/"
META = ("config", "overrides", "seed", "batch_size")
SIDES = "relu_sides/"
# A ReLU input within ~1e-6 of its tensor's max |x| of zero falls on
# either side by the last bits of fp32 sums, which two implementations (or
# devices) order differently, and its side moves every gradient below it:
# at 64² one such unit in layer3 moves d(loss)/d(image) by ~1.5e-2; at
# 224² the card and the CPU differ at hundreds. --write stores the side of
# every train-mode ReLU input within RELU_RECORD of zero. When only the
# train-mode checks fail, they run again at the same gates: with the
# stored sides taken where the stored set has them (the port's own), else
# with each choice of sides of at most MAX_SIDES inputs within
# RELU_MARGIN (the JAX package's set, which has none).
RELU_RECORD, RELU_MARGIN, MAX_SIDES = 1e-4, 1e-6, 4


def bitcheck_inputs(_C, batch_size: int, seed: int
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The fixed inputs of ``scripts/feature_bitcheck.py``, drawn in its
    order from ``RandomState(seed)``: images ``(B, S, S, 3)`` float32 (drawn
    as ``(B, 3, S, S)`` and moved to NHWC), and the task's int64 batch.
    Multilabel labels repeat one label in row 1 and pad row 0; masked LM
    masks two distinct positions per row. ``_C`` is either package's
    config: only ``MODEL.NAME`` and ``DATA.*`` are read."""
    D = _C.DATA
    task = _C.MODEL.NAME
    B, S, T = batch_size, D.IMAGE_CROP_SIZE, D.MAX_CAPTION_LENGTH
    rng = np.random.RandomState(seed)
    images = (rng.rand(B, 3, S, S).astype(np.float32) - 0.5) / 0.25
    low = max(D.SOS_INDEX, D.EOS_INDEX, D.UNK_INDEX, D.MASK_INDEX) + 1
    batch: Dict[str, np.ndarray] = {}
    if task == "multilabel_classification":
        labels = rng.randint(1, D.VOCAB_SIZE, (B, 5)).astype(np.int64)
        labels[0, 3:] = 0
        if B > 1:
            labels[1, 2] = labels[1, 1]
        batch["labels"] = labels
    elif task == "token_classification":
        labels = rng.randint(low, D.VOCAB_SIZE, (B, 5)).astype(np.int64)
        labels[0, 3:] = 0
        batch["labels"] = labels
    else:
        tokens = rng.randint(low, D.VOCAB_SIZE, (B, T)).astype(np.int64)
        tokens[:, 0] = D.SOS_INDEX
        lengths = np.full((B,), T, np.int64)
        if T > 3:
            tokens[0, T - 2:], lengths[0] = 0, T - 2
        if task == "masked_lm":
            masked_labels = np.zeros_like(tokens)
            for i in range(B):
                n_mask = min(2, lengths[i] - 1)
                for p in rng.choice(np.arange(1, lengths[i]), size=n_mask,
                                    replace=False):
                    masked_labels[i, p] = tokens[i, p]
                    tokens[i, p] = D.MASK_INDEX
            batch["masked_labels"] = masked_labels
        else:
            noitpac = np.zeros_like(tokens)
            for i in range(B):
                noitpac[i, :lengths[i]] = tokens[i, :lengths[i]][::-1]
            batch["noitpac_tokens"] = noitpac
        batch["caption_tokens"] = tokens
        batch["caption_lengths"] = lengths
    return np.ascontiguousarray(images.transpose(0, 2, 3, 1)), batch


def draw_checkpoint(model: torch.nn.Module, seed: int
                    ) -> Tuple[Dict[str, torch.Tensor], str]:
    """A reference state dict for ``model``'s names and shapes (it may live
    on the meta device), drawn from ``RandomState(seed)`` by name and shape
    only, in sorted name order, each tied tensor once: convolutions
    N(0, 2/fan_in), other matrices N(0, 1/fan_in) (so that attention
    scores are O(1), not a near-uniform softmax), 1-d weights (the norms'
    scales) 1 + 0.2·N(0, 1), 1-d biases and running means 0.1·N(0, 1),
    running variances U(0.5, 1.5), counts 0. Nothing of torch's generator
    is read, so every torch version draws the same file. Returns the state
    dict (CPU tensors) and a sha256 over its names and bytes."""
    rng = np.random.RandomState(seed)
    drawn: Dict[int, np.ndarray] = {}
    out: Dict[str, torch.Tensor] = {}
    digest = hashlib.sha256()
    for name, t in sorted(model.state_dict(keep_vars=True).items()):
        if not t.is_floating_point():
            value = np.zeros(tuple(t.shape), np.int64)
        elif id(t) in drawn:
            value = drawn[id(t)]
        else:
            shape = tuple(t.shape)
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "running_var":
                value = rng.uniform(0.5, 1.5, shape)
            elif leaf == "running_mean" or (leaf.endswith("bias")
                                            and len(shape) == 1):
                value = 0.1 * rng.standard_normal(shape)
            elif len(shape) == 1:
                value = 1.0 + 0.2 * rng.standard_normal(shape)
            elif len(shape) == 4:
                fan_in = int(np.prod(shape[1:]))
                value = np.sqrt(2.0 / fan_in) * rng.standard_normal(shape)
            else:
                value = rng.standard_normal(shape) / np.sqrt(shape[1])
            value = drawn[id(t)] = value.astype(np.float32)
        digest.update(name.encode())
        digest.update(np.ascontiguousarray(value).tobytes())
        out[name] = torch.from_numpy(np.array(value))
    return out, digest.hexdigest()


def write_checkpoint(config: str, overrides: List[str], seed: int,
                     path: str) -> str:
    """:func:`draw_checkpoint` for the model of ``config`` (built on the
    meta device) saved as ``{"model": state_dict}`` at ``path``. Returns
    the sha256 of the drawn arrays."""
    with torch.device("meta"):
        model, _ = model_zoo.get(os.path.abspath(config),
                                 overrides=list(overrides) + FORCED_OVERRIDES,
                                 device="meta")
    state, sha = draw_checkpoint(model, seed)
    torch.save({"model": state}, path)
    return sha


def channel_error(ours, ref) -> float:
    """Max over elements of ``|a − ref| / (|ref| + s)``, ``s`` the max
    ``|ref|`` over the element's channel (the last axis); for a scalar,
    ``|a − ref| / |ref|``. An element whose denominator is 0 counts 0 if
    equal, else infinity."""
    a, r = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if a.shape != r.shape:
        return float("inf")
    if r.ndim == 0:
        denom = np.abs(r)
    else:
        denom = np.abs(r) + np.abs(r).max(axis=tuple(range(r.ndim - 1)),
                                          keepdims=True)
    diff = np.abs(a - r)
    with np.errstate(divide="ignore", invalid="ignore"):
        err = np.where(denom > 0, diff / np.where(denom > 0, denom, 1.0),
                       np.where(diff > 0, np.inf, 0.0))
    return float(err.max()) if err.size else 0.0


@contextlib.contextmanager
def true_fp32():
    """TF32 off for cuDNN and matmuls inside, the caller's flags after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def checkpoint_mismatch(path: str, model: torch.nn.Module) -> List[str]:
    """What keeps ``path`` from loading into ``model`` in full: names the
    model has and the file lacks (``num_batches_tracked`` may be absent),
    names the file has and the model lacks, and shapes that differ."""
    saved = read_checkpoint(path)
    saved = saved.get("model", saved)
    own = model.state_dict()
    problems = [f"missing {k}" for k in own
                if k not in saved and not k.endswith("num_batches_tracked")]
    problems += [f"unexpected {k}" for k in saved if k not in own]
    problems += [f"shape {k}: {tuple(saved[k].shape)} in the file, "
                 f"{tuple(v.shape)} in the model"
                 for k, v in own.items()
                 if k in saved and tuple(saved[k].shape) != tuple(v.shape)]
    return problems


class ReluSides:
    """Swaps ``modules/resnet.py``'s ``F`` for this object inside a
    ``with``. Each ReLU call, in order, records the units whose input lies
    within ``RELU_RECORD`` of that input's max ``|x|`` of zero: the call,
    the flat (logical NCHW) index, the input over that max, and the side
    taken.
    ``replay`` ({call: (indices, sides)}) takes those units on the given
    sides; ``flips`` ((call, index) pairs) takes those on their other side.
    ``changed`` counts the units taken on a side their input does not
    give. Every other ``F.<fn>`` is torch's."""

    def __init__(self, flips=(), replay=None):
        self.flips = set(flips)
        self.replay = replay or {}
        self.recorded: List[Tuple[int, np.ndarray, np.ndarray,
                                  np.ndarray]] = []
        self.calls = self.changed = 0

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def __enter__(self):
        from virtex_tpu_torch.modules import resnet
        self.module, self.plain = resnet, resnet.F
        resnet.F = self
        return self

    def __exit__(self, *exc):
        self.module.F = self.plain

    def near_zero(self, margin: float) -> List[Tuple[int, int, float]]:
        """(call, index, input over its max) of the recorded units within
        ``margin``."""
        return [(call, int(i), float(r))
                for call, index, ratio, _ in self.recorded
                for i, r in zip(index, ratio) if abs(r) <= margin]

    def sides(self) -> Dict[str, np.ndarray]:
        """The recorded units as flat arrays, for an npz."""
        calls = [np.full(len(index), call, np.int32)
                 for call, index, _, _ in self.recorded]
        return {"call": np.concatenate(calls or [np.zeros(0, np.int32)]),
                "unit": np.concatenate([r[1] for r in self.recorded]
                                       or [np.zeros(0, np.int64)]),
                "on": np.concatenate([r[3] for r in self.recorded]
                                     or [np.zeros(0, bool)])}

    def relu(self, x):
        call, self.calls = self.calls, self.calls + 1
        flat = x.detach().flatten()
        scale = flat.abs().max().clamp_min(torch.finfo(flat.dtype).tiny)
        index = torch.nonzero(flat.abs() <= RELU_RECORD * scale).flatten()
        natural = flat > 0
        keep = natural.clone()
        if call in self.replay:
            units, on = (torch.as_tensor(v, device=x.device)
                         for v in self.replay[call])
            keep[units] = on
        mine = [i for c, i in self.flips if c == call]
        if mine:
            units = torch.tensor(mine, device=x.device)
            keep[units] = ~keep[units]
        self.recorded.append((call, index.cpu().numpy(),
                              (flat[index] / scale).cpu().numpy(),
                              keep[index].cpu().numpy()))
        changed = int((keep != natural).sum())
        self.changed += changed
        if not changed:
            return torch.relu(x)
        return torch.where(keep.view(x.shape), x, torch.zeros_like(x))


def compute(model: torch.nn.Module, _C, batch_size: int, seed: int,
            device: torch.device, sides: Optional[ReluSides] = None
            ) -> Dict[str, np.ndarray]:
    """The three results of ``model`` on :func:`bitcheck_inputs`: the eval
    grid first, then one train-mode forward and backward (inside
    ``sides`` if given)."""
    images, batch = bitcheck_inputs(_C, batch_size, seed)
    image = torch.from_numpy(images).to(device)
    model.eval()
    with torch.no_grad():
        grid = model.visual(image)
    model.train()
    image = image.clone().requires_grad_(True)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with sides or contextlib.nullcontext():
        out = model({**inputs, "image": image}, generator=generator)
        out["loss"].backward()
    results = {GRID: grid, LOSS: out["loss"], DIMAGE: image.grad}
    for name, value in out["loss_components"].items():
        results[COMPONENT + name] = value
    return {k: v.detach().float().cpu().numpy() for k, v in results.items()}


def gate(key: str, args) -> Tuple[str, float]:
    """A result key's printed name and tolerance."""
    if key == GRID:
        return "layer4 grid (eval BN)", args.tolerance
    if key == DIMAGE:
        return "d(loss)/d(image)", args.grad_tolerance
    if key == LOSS:
        return "training loss", LOSS_TOL
    return f"loss component {key[len(COMPONENT):]}", LOSS_TOL


def load_reference(path: str, task: str
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``path``'s results and metadata of ``task``, by key."""
    with np.load(path) as f:
        entries = {k[len(task) + 1:]: f[k] for k in f.files
                   if k.startswith(task + "/")}
    results = {k: v for k, v in entries.items()
               if k in (GRID, LOSS, DIMAGE) or k.startswith(COMPONENT)}
    return results, {k: v for k, v in entries.items() if k not in results}


def meta_failures(meta: Dict[str, np.ndarray],
                  ref_meta: Dict[str, np.ndarray], path: str) -> List[str]:
    """The seed, batch size and overrides must be those of the stored
    results; print and return those that are not."""
    failures = []
    for key in ("seed", "batch_size", "overrides"):
        want = ref_meta.get(key)
        if want is None or [str(v) for v in np.ravel(want)] != [
                str(v) for v in np.ravel(meta[key])]:
            print(f"feature_bitcheck: [FAIL] {key}: {path} holds "
                  f"{None if want is None else want.tolist()}, this run "
                  f"{meta[key].tolist()}")
            failures.append(key)
    return failures


def compare(results: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
            args) -> List[Tuple[str, str, float, float]]:
    """``(key, name, error, tolerance)`` of every result either side has,
    in the grid, loss, components, dimage order; a key one side lacks has
    an infinite error."""
    order = {GRID: 0, LOSS: 1, DIMAGE: 3}
    rows = []
    for key in sorted(set(results) | set(ref),
                      key=lambda k: (order.get(k, 2), k)):
        name, tol = gate(key, args)
        err = (channel_error(results[key], ref[key])
               if key in results and key in ref else float("inf"))
        rows.append((key, name, err, tol))
    return rows


def print_rows(rows, note: str = "") -> List[str]:
    """Print one PASS/FAIL line per row; returns the failed names."""
    for _, name, err, tol in rows:
        status = "PASS" if err <= tol else "FAIL"
        print(f"feature_bitcheck: [{status}] {name}{note}: err={err:.3e} "
              f"(tol {tol:.0e})")
    return [name for _, name, err, tol in rows if not err <= tol]


def replayed_sides(model, _C, args, device, ref, stored) -> bool:
    """The train-mode checks again with the stored set's recorded ReLU
    sides taken; prints their lines. True when they all pass."""
    replay = {}
    for call in np.unique(stored["call"]):
        at = stored["call"] == call
        replay[int(call)] = (stored["unit"][at], stored["on"][at])
    sides = ReluSides(replay=replay)
    results = compute(model, _C, args.batch_size, args.seed, device, sides)
    rows = compare({k: v for k, v in results.items() if k != GRID},
                   {k: v for k, v in ref.items() if k != GRID}, args)
    return not print_rows(rows, f" (the stored sides of "
                          f"{len(stored['call'])} ReLU inputs within "
                          f"{RELU_RECORD:.0e} of their scale of zero taken,"
                          f" {sides.changed} of them against this run's)")


def other_sides(model, _C, args, device, ref, near_zero) -> bool:
    """The train-mode checks again with each nonempty subset of the ReLU
    units ``near_zero`` on its other side; the subset with the smallest
    largest error must pass them all, and its lines are printed. False
    when it does not, or when there are more than MAX_SIDES units."""
    if not near_zero or len(near_zero) > MAX_SIDES:
        print(f"feature_bitcheck: {len(near_zero)} ReLU input(s) within "
              f"{RELU_MARGIN:.0e} of their scale of zero in the train-mode "
              f"forward; sides are tried for 1 to {MAX_SIDES}")
        return False
    train_ref = {k: v for k, v in ref.items() if k != GRID}
    best = None
    for n in range(1, 2 ** len(near_zero)):
        flips = [unit for i, unit in enumerate(near_zero) if n >> i & 1]
        results = compute(model, _C, args.batch_size, args.seed, device,
                          ReluSides([(c, i) for c, i, _ in flips]))
        rows = compare({k: v for k, v in results.items() if k != GRID},
                       train_ref, args)
        worst = max(err / tol for _, _, err, tol in rows)
        if best is None or worst < best[0]:
            best = (worst, flips, rows)
    worst, flips, rows = best
    where = ", ".join(f"call {c} unit {i} at {x:.2e} of its scale"
                      for c, i, x in flips)
    return not print_rows(rows, f" ({len(flips)} of {len(near_zero)} ReLU "
                          f"input(s) within {RELU_MARGIN:.0e} of their scale "
                          f"of zero on the other side: {where})")


def write(path: str, task: str, results: Dict[str, np.ndarray],
          meta: Dict[str, np.ndarray]) -> None:
    entries = {f"{task}/{k}": v for k, v in {**results, **meta}.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **entries)
    print(f"feature_bitcheck: wrote {len(results)} results of {task} to "
          f"{path}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Hold the port's layer4 grid, "
                                 "loss and input gradient on a .pth to a "
                                 "stored set.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--config-override", nargs="*", default=[])
    ap.add_argument("--checkpoint-path", required=True,
                    help="reference torch .pth checkpoint")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=GRID_TOL,
                    help="per-element tolerance of the grid (the losses "
                         f"are held to {LOSS_TOL:.0e})")
    ap.add_argument("--grad-tolerance", type=float, default=GRAD_TOL,
                    help="per-element tolerance of d(loss)/d(image)")
    ap.add_argument("--write", metavar="OUT.npz", default=None,
                    help="store this run's results")
    ap.add_argument("--against", metavar="REF.npz", default=None,
                    help="hold this run's results to a stored set")
    ap.add_argument("--device", default="cuda",
                    help="Device to run on (default: the card); 'cpu' runs "
                         "on the CPU.")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not (args.write or args.against):
        ap.error("nothing to do: pass --write, --against or both")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    overrides = [str(v) for v in args.config_override]
    with true_fp32():
        model, _C = model_zoo.get(
            os.path.abspath(args.config), pretrained=True,
            checkpoint_path=args.checkpoint_path,
            overrides=overrides + FORCED_OVERRIDES, device=device)
        task = _C.MODEL.NAME
        problems = checkpoint_mismatch(args.checkpoint_path, model)
        if problems:
            print(f"feature_bitcheck: FAIL — {args.checkpoint_path} does not "
                  f"fit the model of {args.config}: {problems[:10]}")
            return 1
        sides = ReluSides()
        results = compute(model, _C, args.batch_size, args.seed, device,
                          sides)
        print(f"feature_bitcheck: {task} on {device}: visual grid shape "
              f"{results[GRID].shape}, loss {float(results[LOSS]):.6f}")
        meta = {"config": np.array(args.config),
                "overrides": np.array(overrides, dtype=str),
                "seed": np.array(args.seed),
                "batch_size": np.array(args.batch_size)}
        if args.write:
            write(args.write, task, results, {
                **meta, **{SIDES + k: v for k, v in sides.sides().items()}})
        if not args.against:
            return 0
        ref, ref_meta = load_reference(args.against, task)
        failures = meta_failures(meta, ref_meta, args.against)
        failed = print_rows(compare(results, ref, args))
        grid_name = gate(GRID, args)[0]
        stored = {k[len(SIDES):]: v for k, v in ref_meta.items()
                  if k.startswith(SIDES)}
        resolved = (failed and not failures and grid_name not in failed
                    and set(results) == set(ref)
                    and (replayed_sides(model, _C, args, device, ref, stored)
                         if stored else
                         other_sides(model, _C, args, device, ref,
                                     sides.near_zero(RELU_MARGIN))))
    failures += [] if resolved else failed
    if failures:
        print(f"feature_bitcheck: FAIL — {len(failures)} check(s) diverged: "
              f"{failures}")
        return 1
    print(f"feature_bitcheck: PASS — {task} on {device} matches "
          f"{args.against} on {args.checkpoint_path} (grid + loss + input "
          f"gradient, B={args.batch_size}, {_C.DATA.IMAGE_CROP_SIZE}px, "
          f"T={_C.DATA.MAX_CAPTION_LENGTH})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
