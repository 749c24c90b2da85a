r"""
Evaluation metrics: running top-k accuracy, average precision, and the
COCO caption metrics (CIDEr-D, SPICE).

Counterpart of ``virtex_tpu/utils/metrics.py``, in numpy and plain Python:

- :class:`TopkAccuracy` accumulates over batches of (B, C) or (B, T, C)
  logits and reports a percentage;
- :func:`average_precision` is the binary average precision that VOC07's
  SVMs are scored by, with sklearn's ``average_precision_score``
  semantics;
- :func:`ptb_tokenize` is the JAX package's pure-Python Penn-Treebank
  tokenizer (lowercased, punctuation dropped), rule for rule;
- :func:`cider` is CIDEr-D: tf-idf weighted 1- to 4-gram cosines against
  each reference with clipped candidate counts, a gaussian length penalty
  of σ 6, ×10, averaged over references and n-gram orders. Its sums run in
  the JAX function's order (images in ground-truth order, n-grams in
  first-seen order), so both give the same float;
- :func:`spice` runs the SPICE-1.0 JAR (``$VIRTEX_TPU_SPICE_JAR``, and
  ``java`` on the path) in a subprocess and raises without them;
- :class:`CocoCaptionsEvaluator` scores predictions ×100, with SPICE 0.0
  when the JAR cannot run.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np


class TopkAccuracy:
    """``__call__(logits, targets)`` adds a batch: logits (B, C) or
    (B, T, C), targets (B,) or (B, T). :meth:`get_metric` returns the
    percentage of targets among their row's ``top_k`` logits."""

    def __init__(self, top_k: int = 1):
        self._top_k = top_k
        self.reset()

    def reset(self) -> None:
        self.num_total = 0.0
        self.num_correct = 0.0

    def __call__(self, predictions, ground_truth) -> None:
        predictions = np.asarray(predictions)
        ground_truth = np.asarray(ground_truth)
        if self._top_k == 1:
            top = predictions.argmax(-1)[..., None]
        else:
            top = np.argsort(-predictions, axis=-1)[..., :self._top_k]
        hit = (top == ground_truth[..., None]).any(-1)
        self.num_correct += float(hit.sum())
        self.num_total += float(hit.size)

    def get_metric(self, reset: bool = False) -> float:
        accuracy = 100.0 * self.num_correct / max(self.num_total, 1e-12)
        if reset:
            self.reset()
        return accuracy


def average_precision(y_true, y_score) -> float:
    """AP = Σₙ (Rₙ − Rₙ₋₁)·Pₙ over the distinct scores from the highest
    down, with R₋₁ = 0: tied scores form one step. Label 1 is positive,
    anything else negative. With no positive the recall is taken as 1 at
    every threshold, as sklearn takes it, so AP is the precision at the
    highest score: 0."""
    positive = np.asarray(y_true).ravel() == 1
    score = np.asarray(y_score, np.float64).ravel()
    order = np.argsort(score, kind="mergesort")[::-1]
    score, positive = score[order], positive[order]
    last = np.r_[np.flatnonzero(np.diff(score)), score.size - 1]
    tps = np.cumsum(positive)[last].astype(np.float64)
    precision = tps / (last + 1)
    recall = tps / tps[-1] if tps[-1] else np.ones_like(tps)
    return float(np.sum(np.diff(recall, prepend=0.0) * precision))


# -- PTB tokenization ----------------------------------------------------------
# Dropped after tokenization. The filter is case-sensitive and runs on
# lowercased tokens, so the bracket tokens ("-lrb-") survive it, as in the
# JAX package and the reference's CoreNLP filter.
_PUNCT = frozenset({"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                    ".", "?", "!", ",", ":", "-", "--", "...", ";"})
_BRACKETS = (("(", "-LRB-"), (")", "-RRB-"), ("[", "-LSB-"), ("]", "-RSB-"),
             ("{", "-LCB-"), ("}", "-RCB-"))
# Unicode punctuation as CoreNLP's ptb3Escaping maps it, in order.
_UNICODE = (("\u00a0", " "), ("\u2018", "`"), ("\u2019", "'"),
            ("\u201c", " `` "), ("\u201d", " '' "), ("\u201e", " `` "),
            ("\u201f", " '' "), ("\u2013", " -- "), ("\u2014", " -- "),
            ("\u2015", " -- "), ("\u2026", " ... "))
# Assimilated forms that PTBTokenizer splits.
_ASSIMILATIONS = [re.compile(rf"\b({a})({b})\b", re.I) for a, b in (
    ("can", "not"), ("d", "'ye"), ("gim", "me"), ("gon", "na"),
    ("got", "ta"), ("lem", "me"), ("wan", "na"), ("more", "'n"))]
_ACRONYM = re.compile(r"\b(?:[A-Za-z]\.){2,}[A-Za-z]?(?!\w)")
_HIDDEN_DOT = "\x00"


def _neighbours(m: "re.Match") -> tuple:
    i, s = m.start(), m.string
    return (s[i - 1] if i > 0 else " ", s[i + 1] if i + 1 < len(s) else " ")


def _split_dot_comma(m: "re.Match") -> str:
    """Keep ``.`` and ``,`` between digits (3.5, 1,000) and a leading
    decimal point (.22); set any other apart."""
    ch = m.group(1)
    prev, nxt = _neighbours(m)
    if prev.isdigit() and nxt.isdigit():
        return ch
    if ch == "." and not prev.isalnum() and nxt.isdigit():
        return ch
    return f" {ch} "


def _split_colon(m: "re.Match") -> str:
    """Keep ``:`` between digits (7:30); set any other apart."""
    prev, nxt = _neighbours(m)
    return ":" if prev.isdigit() and nxt.isdigit() else " : "


def ptb_tokenize(caption: str) -> List[str]:
    """A caption's Penn-Treebank tokens, lowercased, punctuation dropped:
    brackets become ``-lrb-``-style tokens, number-internal ``.``, ``,``
    and ``:`` stay, dotted acronyms stay whole, contractions and
    assimilations split (``do n't``, ``gon na``), ``$ % & @ …`` stand
    alone, quotes and ellipses go."""
    s = caption.strip().replace("\n", " ")
    for raw, cooked in _UNICODE:
        s = s.replace(raw, cooked)
    s = re.sub(r"``", " `` ", s)
    s = re.sub(r"`(?!`)", " ` ", s)
    s = re.sub(r"([¢£¥€])", r" \1 ", s)
    s = re.sub(r"\.\.\.+", " ... ", s)
    for raw, token in _BRACKETS:
        s = s.replace(raw, f" {token} ")
    s = s.replace('"', " '' ")
    s = _ACRONYM.sub(lambda m: m.group(0).replace(".", _HIDDEN_DOT), s)
    s = re.sub(r"([.,])", _split_dot_comma, s)
    s = re.sub(r":", _split_colon, s)
    s = re.sub(r"([;!?$%&@#*+=<>/\\|~^])", r" \1 ", s)
    s = s.replace(_HIDDEN_DOT, ".")
    s = re.sub(r"\b(\w+)(n't)\b", r"\1 \2", s, flags=re.I)
    s = re.sub(r"(\w)('s|'re|'ve|'ll|'d|'m)\b", r"\1 \2", s, flags=re.I)
    for pattern in _ASSIMILATIONS:
        s = pattern.sub(r"\1 \2", s)
    s = re.sub(r"'(?!\w)", " ' ", s)
    return [t for t in s.lower().split() if t not in _PUNCT]


# -- CIDEr-D -------------------------------------------------------------------
def _ngrams(tokens: Sequence[str], max_n: int = 4
            ) -> Dict[int, Dict[tuple, int]]:
    """n → {n-gram: count} for n in 1..max_n, n-grams in first-seen
    order."""
    out: Dict[int, Dict[tuple, int]] = {n: defaultdict(int)
                                        for n in range(1, max_n + 1)}
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            out[n][tuple(tokens[i:i + n])] += 1
    return out


def cider(predictions: Dict[Any, List[str]],
          ground_truth: Dict[Any, List[List[str]]],
          n: int = 4, sigma: float = 6.0) -> float:
    r"""CIDEr-D of tokenized captions, the mean over the images of
    ``ground_truth`` (an image without a prediction scores its empty
    candidate).

    Args:
        predictions: image_id → candidate tokens.
        ground_truth: image_id → a list of reference token lists.
    """
    ids = list(ground_truth)
    # Document frequency: in how many images' reference sets each n-gram
    # appears.
    df: Dict[int, Dict[tuple, float]] = {k: defaultdict(float)
                                         for k in range(1, n + 1)}
    for img in ids:
        seen = set()
        for ref in ground_truth[img]:
            for k, grams in _ngrams(ref, n).items():
                seen.update((k, g) for g in grams)
        for k, g in seen:
            df[k][g] += 1.0
    log_docs = math.log(max(len(ids), 1))

    def tfidf(tokens):
        grams = _ngrams(tokens, n)
        vectors, norms = {}, {}
        for k in range(1, n + 1):
            vk = {g: count * (log_docs - math.log(max(df[k][g], 1.0)))
                  for g, count in grams[k].items()}
            vectors[k] = vk
            norms[k] = math.sqrt(sum(x * x for x in vk.values()))
        return vectors, norms

    scores = []
    for img in ids:
        candidate = predictions.get(img, [])
        cvec, cnorm = tfidf(candidate)
        total = 0.0
        for ref in ground_truth[img]:
            rvec, rnorm = tfidf(ref)
            sim = 0.0
            for k in range(1, n + 1):
                dot = 0.0
                for g, value in cvec[k].items():
                    r = rvec[k].get(g, 0.0)
                    dot += min(value, r) * r  # CIDEr-D's clipped counts
                denom = cnorm[k] * rnorm[k]
                if denom > 0:
                    sim += dot / denom
            gap = len(candidate) - len(ref)
            sim *= math.exp(-(gap ** 2) / (2 * sigma ** 2))
            total += sim
        scores.append(10.0 * total / max(len(ground_truth[img]), 1) / n)
    return float(np.mean(scores)) if scores else 0.0


# -- SPICE ---------------------------------------------------------------------
SPICE_JAR_ENV = "VIRTEX_TPU_SPICE_JAR"


def spice(predictions: Dict[Any, List[str]],
          ground_truth: Dict[Any, List[List[str]]]) -> float:
    """SPICE F-score from the SPICE-1.0 JAR at ``$VIRTEX_TPU_SPICE_JAR``,
    run with ``java``; raises RuntimeError when either is missing."""
    jar = os.environ.get(SPICE_JAR_ENV)
    if not jar or not os.path.exists(jar) or shutil.which("java") is None:
        raise RuntimeError(
            "SPICE needs java and the SPICE-1.0 jar; set "
            f"${SPICE_JAR_ENV} to the jar's path")
    payload = [{"image_id": img,
                "test": " ".join(predictions.get(img, [])),
                "refs": [" ".join(r) for r in refs]}
               for img, refs in ground_truth.items()]
    with tempfile.TemporaryDirectory() as tmp:
        in_file = os.path.join(tmp, "input.json")
        out_file = os.path.join(tmp, "output.json")
        with open(in_file, "w") as f:
            json.dump(payload, f)
        subprocess.check_call(
            ["java", "-jar", "-Xmx8G", jar, in_file, "-cache",
             os.path.join(tmp, "cache"), "-out", out_file, "-subset",
             "-silent"])
        with open(out_file) as f:
            results = json.load(f)
    return float(np.mean([item["scores"]["All"]["f"] for item in results]))


class CocoCaptionsEvaluator:
    r"""Scores predicted captions against COCO's references.

    Args:
        gt_annotations: the path of a ``captions_*.json``, or
            ``{image_id: [caption, ...]}``.
    """

    def __init__(self, gt_annotations):
        if isinstance(gt_annotations, str):
            with open(gt_annotations) as f:
                raw = json.load(f)
            grouped: Dict[Any, List[str]] = defaultdict(list)
            for ann in raw["annotations"]:
                grouped[ann["image_id"]].append(ann["caption"])
            gt_annotations = dict(grouped)
        self.ground_truth = {img: [ptb_tokenize(c) for c in caps]
                             for img, caps in gt_annotations.items()}

    def evaluate(self, preds) -> Dict[str, float]:
        """``preds``: a list of ``{"image_id", "caption"}`` or
        ``{image_id: caption}`` → ``{"CIDEr", "SPICE"}``, each ×100 (SPICE
        0.0 when the JAR cannot run)."""
        if isinstance(preds, list):
            preds = {p["image_id"]: p["caption"] for p in preds}
        tokens = {img: ptb_tokenize(c) for img, c in preds.items()}
        out = {"CIDEr": 100.0 * cider(tokens, self.ground_truth)}
        try:
            out["SPICE"] = 100.0 * spice(tokens, self.ground_truth)
        except RuntimeError:
            out["SPICE"] = 0.0
        return out
