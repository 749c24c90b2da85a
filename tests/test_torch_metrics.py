"""The port's caption and classification metrics
(virtex_tpu_torch.utils.metrics) against the JAX package's
(virtex_tpu.utils.metrics) on the CPU.

- ``ptb_tokenize`` equals the JAX function on the committed golden cases
  and on random captions full of punctuation, digits and unicode quotes.
- ``cider`` equals it to 1e-12 (relative, and 1e-12 absolute for zeros) on
  random candidate and reference sets, empty candidates and missing
  predictions included: both sum in one order.
- ``TopkAccuracy`` (k 1 and 5, 2-D and 3-D logits) and
  ``CocoCaptionsEvaluator`` on a dict and on an annotation file give the
  JAX package's floats exactly.
- ``spice`` keeps the subprocess contract (a stub ``java``) and raises
  without the jar; the evaluator then reports SPICE 0.0.
"""
import json
import os

import numpy as np
import pytest

from virtex_tpu.utils import metrics as jax_metrics
from virtex_tpu_torch.utils import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
CIDER_TOL = 1e-12
WORDS = ["a", "man", "dog", "red", "bus", "on", "the", "street", "two",
         "cats", "play", "grass", "with", "ball", "near", "tree", "is",
         "sitting", "of", "top"]
PIECES = WORDS + [".", ",", "!", "?", "'s", "n't", "(", ")", "[", "]", '"',
                  "3.5", "1,000", "7:30", "u.s.", "$", "%", "&", "...",
                  "’s", "“quote”", "—", "…",
                  "gonna", "cannot", "dogs'", "-", "--", ";", ":", " ",
                  "€5", ".22", "e-mail", "#1", "A", "The", "MAN"]


def _caption(rng, lo=0, hi=14, pieces=PIECES) -> str:
    words = rng.choice(pieces, rng.randint(lo, hi))
    glue = rng.choice([" ", "", "  "], len(words))
    return "".join(w + g for w, g in zip(words, glue))


def test_ptb_tokenize_golden_cases_equal_the_jax_function():
    with open(os.path.join(HERE, "fixtures",
                           "ptb_tokenizer_golden.json")) as f:
        cases = json.load(f)["cases"]
    assert len(cases) >= 150
    for c in cases:
        assert metrics.ptb_tokenize(c["in"]) == c["out"], c
        assert metrics.ptb_tokenize(c["in"]) == jax_metrics.ptb_tokenize(
            c["in"])


def test_ptb_tokenize_random_captions_equal_the_jax_function():
    rng = np.random.RandomState(0)
    for _ in range(2000):
        text = _caption(rng)
        assert metrics.ptb_tokenize(text) == jax_metrics.ptb_tokenize(text), \
            text


def _random_sets(rng, n_images, n_refs):
    ids = [int(i) for i in rng.permutation(10 * n_images)[:n_images]]
    gts = {i: [metrics.ptb_tokenize(_caption(rng, 1, 14, WORDS))
               for _ in range(rng.randint(1, n_refs + 1))] for i in ids}
    preds = {}
    for i in ids:
        r = rng.uniform()
        if r < 0.1:
            continue  # no prediction: scored as an empty candidate
        preds[i] = ([] if r < 0.2 else
                    metrics.ptb_tokenize(_caption(rng, 1, 14, WORDS)))
    return preds, gts


@pytest.mark.parametrize("seed,n_images,n_refs", [(0, 1, 1), (1, 5, 3),
                                                  (2, 40, 5), (3, 200, 5)])
def test_cider_equals_the_jax_function(seed, n_images, n_refs):
    preds, gts = _random_sets(np.random.RandomState(seed), n_images, n_refs)
    got = metrics.cider(preds, gts)
    want = jax_metrics.cider(preds, gts)
    assert abs(got - want) <= CIDER_TOL * max(abs(want), 1.0), (got, want)
    # a perfect candidate scores higher than none
    perfect = {i: refs[0] for i, refs in gts.items()}
    assert metrics.cider(perfect, gts) >= got


def test_cider_of_empty_candidates_and_sets():
    gts = {1: [["a", "dog"]], 2: [["two", "cats"]]}
    for preds in ({}, {1: [], 2: []}, {1: ["a", "dog"]}):
        assert metrics.cider(preds, gts) == jax_metrics.cider(preds, gts)
    assert metrics.cider({}, {}) == jax_metrics.cider({}, {}) == 0.0


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("shape", [(16, 10), (4, 6, 10)])
def test_topk_accuracy_equals_the_jax_class(k, shape):
    rng = np.random.RandomState(k)
    port, ref = metrics.TopkAccuracy(k), jax_metrics.TopkAccuracy(k)
    for _ in range(3):
        logits = rng.randn(*shape).astype(np.float32)
        labels = rng.randint(0, shape[-1], shape[:-1])
        port(logits, labels)
        ref(logits, labels)
    assert port.get_metric() == ref.get_metric()
    assert 0.0 < port.get_metric(reset=True) <= 100.0
    assert port.num_total == 0.0


@pytest.fixture
def no_spice(monkeypatch):
    monkeypatch.delenv(metrics.SPICE_JAR_ENV, raising=False)


def test_evaluator_on_a_dict_and_on_a_file_equals_the_jax_class(
        tmp_path, no_spice):
    rng = np.random.RandomState(5)
    ids = list(range(1, 13))
    raw = {i: [_caption(rng, 3, 12) for _ in range(5)] for i in ids}
    preds = [{"image_id": i, "caption": _caption(rng, 2, 12)} for i in ids]
    path = tmp_path / "captions_val2017.json"
    with open(path, "w") as f:
        json.dump({"annotations": [{"image_id": i, "caption": c}
                                   for i, caps in raw.items() for c in caps]},
                  f)
    for gt in (raw, str(path)):
        got = metrics.CocoCaptionsEvaluator(gt).evaluate(preds)
        want = jax_metrics.CocoCaptionsEvaluator(gt).evaluate(preds)
        assert set(got) == set(want) == {"CIDEr", "SPICE"}
        assert abs(got["CIDEr"] - want["CIDEr"]) <= \
            CIDER_TOL * max(abs(want["CIDEr"]), 1.0)
        assert got["SPICE"] == want["SPICE"] == 0.0
    as_dict = {p["image_id"]: p["caption"] for p in preds}
    assert metrics.CocoCaptionsEvaluator(raw).evaluate(as_dict) == got


def test_spice_raises_without_the_jar(no_spice):
    with pytest.raises(RuntimeError, match=metrics.SPICE_JAR_ENV):
        metrics.spice({1: ["a"]}, {1: [["a"]]})


def test_spice_subprocess_contract_with_a_stub_java(tmp_path, monkeypatch):
    """The argv, the input payload and the mean of the "All" F-scores, with
    a stub ``java`` that scores the share of candidate words found in the
    references."""
    jar = tmp_path / "spice-1.0.jar"
    jar.write_bytes(b"stub")
    stub = tmp_path / "bin" / "java"
    stub.parent.mkdir()
    stub.write_text(
        "#!/usr/bin/env python3\n"
        "import json, sys\n"
        "argv = sys.argv[1:]\n"
        "assert argv[:2] == ['-jar', '-Xmx8G'] and argv[-2:] == "
        "['-subset', '-silent'], argv\n"
        "opts = dict(zip(argv[4::2], argv[5::2]))\n"
        "out = []\n"
        "for item in json.load(open(argv[3])):\n"
        "    assert set(item) == {'image_id', 'test', 'refs'}, item\n"
        "    refs = set(' '.join(item['refs']).split())\n"
        "    test = item['test'].split()\n"
        "    f = sum(w in refs for w in test) / max(len(test), 1)\n"
        "    out.append({'image_id': item['image_id'],\n"
        "                'scores': {'All': {'f': f}}})\n"
        "json.dump(out, open(opts['-out'], 'w'))\n")
    stub.chmod(0o755)
    monkeypatch.setenv(metrics.SPICE_JAR_ENV, str(jar))
    monkeypatch.setenv("PATH", f"{stub.parent}:{os.environ['PATH']}")
    preds = {1: ["a", "red", "bus"], 2: ["two", "dogs", "play"]}
    gts = {1: [["a", "red", "bus", "parked"]],
           2: [["two", "cats", "play"], ["dogs", "play", "outside"]]}
    assert metrics.spice(preds, gts) == jax_metrics.spice(preds, gts) == 1.0
    out = metrics.CocoCaptionsEvaluator({1: ["a red bus parked"]}).evaluate(
        [{"image_id": 1, "caption": "a red car"}])
    assert out["SPICE"] == pytest.approx(100.0 * 2 / 3)
