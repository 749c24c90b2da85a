r"""
One-vs-all linear SVMs for VOC07 transfer, solved in torch on the card.

Counterpart of ``train_test_single_svm`` in the JAX package's
``scripts/clf_voc07.py``, which fits sklearn's ``LinearSVC(C,
class_weight={1: 2, -1: 1}, penalty="l2", loss="squared_hinge")`` with
3-fold cross-validation of the cost. This module solves the same
problems without sklearn:

- the problem is liblinear's for that ``LinearSVC``: the bias is a
  constant-1 feature (``intercept_scaling`` 1), so it is regularised,

      min ½‖w̃‖² + Σᵢ Cᵢ max(0, 1 − yᵢ w̃·x̃ᵢ)²,   x̃ = [x, 1], w̃ = [w, b],

  with Cᵢ = 2C for positives and C for the rest. It is strictly convex
  and piecewise quadratic, so its minimiser is unique;
- :func:`solve` minimises a batch of such problems over one feature
  matrix by Newton's method on the active set (rows with a positive
  slack; the Hessian is I + 2·X̃ᵀ diag(Cᵢ over the active set) X̃, one
  Cholesky solve per step) with a backtracking line search, in fp64, on
  the matrix's device. A row outside a problem's training set has Cᵢ = 0;
- :func:`stratified_kfold` is ``StratifiedKFold(3, shuffle=False)``, which
  ``cross_val_score(cv=3)`` uses for a classifier, index for index;
- :func:`train_test_svms` keeps the JAX script's rules: training labels 0
  and −1 are both negative; test rows labelled −1 (difficult) are dropped
  and 0 is negative; the cost is the first with the largest mean CV
  average precision; a fold whose training rows hold one class scores NaN,
  as ``cross_val_score`` scores a failed fit; a class whose training labels
  hold one class raises, as ``LinearSVC.fit`` does. A fit that stops short
  of the gradient tolerance (at MAX_NEWTON_STEPS, or where the line search
  runs out of halvings) is logged as a warning naming its class, cost and
  fold.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from virtex_tpu_torch.utils.metrics import average_precision

logger = logging.getLogger("virtex_tpu_torch")

SVM_COSTS = (0.01, 0.1, 1.0, 10.0)
POSITIVE_WEIGHT = 2.0   # class_weight {1: 2, −1: 1}
NUM_FOLDS = 3
# Newton's method stops where ‖∇f‖ ≤ GRAD_RTOL · ‖∇f(0)‖.
GRAD_RTOL = 1e-10
MAX_NEWTON_STEPS = 50
ARMIJO, MAX_HALVINGS = 1e-4, 40
# Problems sharing one batched Hessian and Cholesky factorisation: at
# VOC07's 5011 × 2049, 16 take ~3 GB of fp64 temporaries.
HESSIAN_CHUNK = 16


def stratified_kfold(y: Sequence, n_splits: int = NUM_FOLDS
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) index arrays of ``StratifiedKFold(n_splits,
    shuffle=False).split(X, y)``: classes numbered by first appearance,
    each class's samples dealt to the test folds in order, fold i taking
    as many as ``bincount(sorted_labels[i::n_splits])`` gives it."""
    y = np.asarray(y).ravel()
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    encoded = np.argsort(np.argsort(first))[inverse.ravel()]
    counts = np.bincount(encoded)
    if np.all(counts < n_splits):
        raise ValueError(f"n_splits={n_splits} is more than the members of "
                         f"every class ({counts.tolist()})")
    ordered = np.sort(encoded)
    allocation = np.stack([np.bincount(ordered[i::n_splits],
                                       minlength=counts.size)
                           for i in range(n_splits)])
    test_fold = np.empty(y.size, np.int64)
    for k in range(counts.size):
        test_fold[encoded == k] = np.repeat(np.arange(n_splits),
                                            allocation[:, k])
    return [(np.flatnonzero(test_fold != i), np.flatnonzero(test_fold == i))
            for i in range(n_splits)]


@dataclasses.dataclass
class Solution:
    """``w`` (P, d) and ``b`` (P,) in fp64; the gradient norm at the start
    (w̃ = 0) and at the end, and the Newton steps taken, per problem."""
    w: torch.Tensor
    b: torch.Tensor
    grad_norm0: torch.Tensor
    grad_norm: torch.Tensor
    steps: torch.Tensor


def _augmented(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float64)
    return torch.cat([x, x.new_ones(x.shape[0], 1)], dim=1)


def solve(x: torch.Tensor, y: torch.Tensor, cost: torch.Tensor
          ) -> Solution:
    """Minimise P problems over one matrix ``x`` (n, d): labels ``y`` (P, n)
    in {−1, +1} and per-row costs ``cost`` (P, n), 0 for rows outside a
    problem. Everything runs in fp64 on ``x``'s device."""
    xa = _augmented(x)
    y = y.to(xa)
    cost = cost.to(xa)
    P, D = y.shape[0], xa.shape[1]
    w = xa.new_zeros(P, D)
    steps = torch.zeros(P, dtype=torch.long)
    eye = torch.eye(D, dtype=xa.dtype, device=xa.device)
    grad_norm0 = None
    for step in range(MAX_NEWTON_STEPS + 1):
        slack = 1.0 - y * (w @ xa.T)
        active = cost * (slack > 0)
        grad = w - 2.0 * (active * slack * y) @ xa
        grad_norm = grad.norm(dim=1)
        if grad_norm0 is None:
            grad_norm0 = grad_norm
        todo = torch.nonzero(grad_norm > GRAD_RTOL * grad_norm0).ravel().cpu()
        if todo.numel() == 0 or step == MAX_NEWTON_STEPS:
            break
        for part in todo.split(HESSIAN_CHUNK):
            part_d = part.to(xa.device)
            a = active[part_d]
            hess = torch.matmul(xa.T * a[:, None, :], xa)
            hess.mul_(2.0).add_(eye)
            chol, _ = torch.linalg.cholesky_ex(hess)
            d = -torch.cholesky_solve(grad[part_d, :, None], chol)[..., 0]
            t = _line_search(w[part_d], d, grad[part_d], slack[part_d],
                             y[part_d] * (d @ xa.T), cost[part_d])
            w[part_d] += t[:, None] * d
            steps[part] += 1
    return Solution(w=w[:, :-1], b=w[:, -1], grad_norm0=grad_norm0,
                    grad_norm=grad_norm, steps=steps)


def _line_search(w, d, grad, slack, s, cost) -> torch.Tensor:
    """Step lengths t ∈ {1, ½, ¼, …} meeting Armijo's condition
    f(w̃ + t·d) − f(w̃) ≤ ARMIJO·t·∇f·d, per problem. The change in f is
    summed term by term (a² − b² as (a − b)(a + b)), so it stays exact to
    rounding near the minimum, where f itself would cancel."""
    wd, dd = (w * d).sum(1), (d * d).sum(1)
    slope = (grad * d).sum(1)
    old = slack.clamp(min=0.0)
    t = torch.ones_like(wd)
    for _ in range(MAX_HALVINGS):
        new = (slack - t[:, None] * s).clamp(min=0.0)
        change = (t * wd + 0.5 * t * t * dd
                  + (cost * (new - old) * (new + old)).sum(1))
        ok = change <= ARMIJO * t * slope
        if bool(ok.all()):
            break
        t = torch.where(ok, t, 0.5 * t)
    return t


def _warn_unconverged(sol: Solution, fits: Sequence[str]) -> None:
    """A warning for each fit of ``sol`` (named by ``fits``) whose gradient
    norm is still above GRAD_RTOL of its start."""
    short = sol.grad_norm > GRAD_RTOL * sol.grad_norm0
    for p in torch.nonzero(short).ravel().tolist():
        logger.warning(
            f"SVM {fits[p]}: Newton's method stopped after "
            f"{int(sol.steps[p])} steps at a gradient norm "
            f"{float(sol.grad_norm[p] / sol.grad_norm0[p]):.1e} of its start "
            f"(tolerance {GRAD_RTOL:.0e}); its scores are not the "
            "minimiser's")


def binary_labels(targets: np.ndarray) -> np.ndarray:
    """Training labels: +1 stays, 0 (negative) and −1 (ignored) are −1."""
    return np.where(np.asarray(targets) == 1, 1.0, -1.0)


def row_costs(y: np.ndarray, cost: float, rows: np.ndarray) -> np.ndarray:
    """Per-row costs of one problem: 2·``cost`` for the positives and
    ``cost`` for the negatives among ``rows``, 0 elsewhere."""
    c = np.zeros(y.size)
    c[rows] = cost * np.where(y[rows] > 0, POSITIVE_WEIGHT, 1.0)
    return c


@dataclasses.dataclass
class ClassResult:
    name: str
    ap: float                 # test average precision
    cost: float               # the chosen cost
    cv_ap: List[float]        # mean CV average precision per cost
    w: np.ndarray
    b: float


def train_test_svms(feats_train: torch.Tensor, targets_train: np.ndarray,
                    feats_test: torch.Tensor, targets_test: np.ndarray,
                    class_names: Sequence[str]
                    ) -> Tuple[List[ClassResult], Dict[str, torch.Tensor]]:
    """Every class's SVM as ``train_test_single_svm`` fits and scores it:
    the costs cross-validated over 3 stratified folds (all classes' CV
    problems in one :func:`solve`), then one fit per class at its cost
    (a second :func:`solve`), scored on the test rows. Features are
    (n, d) tensors on the device that solves; targets (n, classes) in
    {1, 0, −1}. Returns the per-class results and, over all fits, the
    start and end gradient norms and Newton steps."""
    labels = [binary_labels(targets_train[:, c])
              for c in range(len(class_names))]
    for name, y in zip(class_names, labels):
        if np.unique(y).size < 2:
            raise ValueError(f"class {name!r}: its training labels hold one "
                             "class only; an SVM needs both")
    n = feats_train.shape[0]
    all_rows = np.arange(n)
    folds = [stratified_kfold(y) for y in labels]
    ys, cs, where = [], [], []
    for c, y in enumerate(labels):
        for k, cost in enumerate(SVM_COSTS):
            for f, (train, _) in enumerate(folds[c]):
                ys.append(y)
                cs.append(row_costs(y, cost, train))
                where.append((c, k, f))

    def fit(ys, cs) -> Solution:
        return solve(feats_train, torch.from_numpy(np.stack(ys)),
                     torch.from_numpy(np.stack(cs)))

    cv = fit(ys, cs)
    _warn_unconverged(cv, [f"class {class_names[c]!r}, cost {SVM_COSTS[k]}, "
                           f"CV fold {f}" for c, k, f in where])
    scores = (feats_train.to(torch.float64) @ cv.w.T + cv.b).T.cpu().numpy()
    fold_ap = np.full((len(labels), len(SVM_COSTS), NUM_FOLDS), np.nan)
    for p, (c, k, f) in enumerate(where):
        train, test = folds[c][f]
        if np.unique(labels[c][train]).size == 2:
            fold_ap[c, k, f] = average_precision(labels[c][test],
                                                 scores[p, test])
    chosen = []
    for c in range(len(labels)):
        best_ap, best = -1.0, SVM_COSTS[0]
        for k, cost in enumerate(SVM_COSTS):
            if fold_ap[c, k].mean() > best_ap:
                best_ap, best = fold_ap[c, k].mean(), cost
        chosen.append(best)

    final = fit(labels, [row_costs(y, cost, all_rows)
                         for y, cost in zip(labels, chosen)])
    _warn_unconverged(final, [f"class {name!r}, cost {cost}" for name, cost
                              in zip(class_names, chosen)])
    test_scores = (feats_test.to(torch.float64) @ final.w.T
                   + final.b).T.cpu().numpy()
    results = []
    for c, name in enumerate(class_names):
        keep = targets_test[:, c] != -1
        y_test = np.where(targets_test[keep, c] == 1, 1, -1)
        results.append(ClassResult(
            name=name, ap=average_precision(y_test, test_scores[c, keep]),
            cost=chosen[c], cv_ap=fold_ap[c].mean(1).tolist(),
            w=final.w[c].cpu().numpy(), b=float(final.b[c])))
    stats = {key: torch.cat([getattr(cv, key).cpu(),
                             getattr(final, key).cpu()])
             for key in ("grad_norm0", "grad_norm", "steps")}
    return results, stats
