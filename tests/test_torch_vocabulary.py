"""The port's vocabulary trainer (virtex_tpu_torch.data.tokenizers
train_tokenizer, export_sentencepiece_model, and
virtex_tpu_torch.scripts.build_vocabulary) against the JAX package's,
which trains with the HF ``tokenizers`` BpeTrainer and writes the
SentencePiece proto with the ``transformers`` schema.

The gate is exact: the same vocabulary and the same merges in the same
order (the tokenizer JSON byte for byte), on corpora with many tied pair
counts; the same ``.sp.model`` bytes; each package's reader encodes the
other's files as its own."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.utils_fixtures import CAPTIONS, make_fake_coco
from virtex_tpu_torch.data import tokenizers as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "man", "woman", "riding", "horse", "the", "on", "of", "in",
         "red", "bus", "street", "dog", "cat", "table", "plate", "with",
         "two", "people", "standing", "next", "to", "ab", "abc", "bc",
         "aab", "abab", "ba", "cab", "café", "Naïve", "ÉCOLE"]


def word_corpus(n, seed):
    """Captions of 1-11 words from a small lexicon: few distinct words, so
    pair counts tie often."""
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(1, 12)))
            for _ in range(n)]


def char_corpus(n, seed, alphabet="abcde  "):
    """Captions of random characters from a skewed draw over a small
    alphabet: long words, runs of one character, many ties."""
    rng = np.random.RandomState(seed)
    chars = list(alphabet)
    p = rng.dirichlet(np.full(len(chars), 0.5))
    return ["".join(rng.choice(chars, rng.randint(0, 40), p=p))
            for _ in range(n)]


CORPORA = {
    "fixture captions": lambda: CAPTIONS * 40,
    "words": lambda: word_corpus(2000, 0),
    "characters": lambda: char_corpus(600, 1),
    "characters with accents": lambda: char_corpus(400, 2, "abcéüñ x"),
}
CASES = [(name, size) for name in CORPORA for size in (60, 120, 300)] + [
    ("words", 1000), ("characters", 3000)]


def train_both(tmp_path, captions, vocab_size):
    from virtex_tpu.data.tokenizers import train_tokenizer as jax_train
    ref, ours = tmp_path / "jax.json", tmp_path / "port.json"
    jax_train(captions, str(ref), vocab_size=vocab_size)
    port.train_tokenizer(captions, str(ours), vocab_size=vocab_size)
    return ref, ours


@pytest.mark.parametrize("corpus,vocab_size", CASES)
def test_vocabulary_and_merges_equal_the_jax_trainer(tmp_path, corpus,
                                                     vocab_size):
    ref, ours = train_both(tmp_path, CORPORA[corpus](), vocab_size)
    want, got = json.loads(ref.read_text()), json.loads(ours.read_text())
    assert got["model"]["vocab"] == want["model"]["vocab"]
    assert got["model"]["merges"] == want["model"]["merges"]
    assert len(got["model"]["merges"]) > 20
    # and the layout: the file byte for byte
    assert ours.read_bytes() == ref.read_bytes()


def test_pre_tokenizer_words_equal_the_hf_metaspace():
    from tokenizers import pre_tokenizers
    hf = pre_tokenizers.Metaspace(replacement="▁")
    for text in ["", " ", "a", " a", "a ", "a  b", "▁a b", "two dogs ",
                 "  x  y  "]:
        want = [w for w, _ in hf.pre_tokenize_str(text)]
        assert port.metaspace_words(text) == want, text


def test_the_specials_then_the_alphabet_in_code_point_order():
    pieces, merges = port.train_bpe({"▁ba": 2, "▁éa": 1, "▁b": 1}, 9)
    assert pieces[:4] == port.SPECIAL_TOKENS
    assert pieces[4:8] == ["a", "b", "é", "▁"]
    # ("▁", "b") counts 3: it is the first merge and fills the vocabulary
    assert merges == [("▁", "b")] and pieces[8] == "▁b"


def test_jax_reader_loads_the_port_json(tmp_path):
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    captions = word_corpus(500, 3)
    _, ours = train_both(tmp_path, captions, 200)
    jax_tok, port_tok = Jax(str(ours)), port.SentencePieceBPETokenizer(
        str(ours))
    assert jax_tok.get_vocab_size() == port_tok.get_vocab_size()
    for text in captions[:100] + ["zzz unseen q", "", "A Café"]:
        assert port_tok.encode(text) == jax_tok.encode(text), text


def test_sp_model_equals_the_jax_export(tmp_path):
    """The port's .sp.model is the JAX export's bytes; the JAX reader
    (transformers' proto schema) encodes it as the JAX export, and the
    port's reader reads it back to the JSON's encodes."""
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    from virtex_tpu.data.tokenizers import export_sentencepiece_model
    captions = word_corpus(800, 4)
    ref, ours = train_both(tmp_path, captions, 250)
    ref_sp, our_sp = tmp_path / "jax.sp.model", tmp_path / "port.sp.model"
    export_sentencepiece_model(str(ref), str(ref_sp))
    port.export_sentencepiece_model(str(ours), str(our_sp))
    assert our_sp.read_bytes() == ref_sp.read_bytes()
    jax_ours, jax_ref = Jax(str(our_sp)), Jax(str(ref_sp))
    from_sp = port.SentencePieceBPETokenizer(str(our_sp))
    from_json = port.SentencePieceBPETokenizer(str(ours))
    for text in captions[:100] + ["zzz unseen q", "  two  spaces "]:
        ids = jax_ref.encode(text)
        assert jax_ours.encode(text) == ids, text
        assert from_sp.encode(text) == from_json.encode(text) == ids, text


def test_export_refuses_what_is_not_a_contiguous_bpe(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"model": {"type": "Unigram"}}))
    with pytest.raises(ValueError, match="not a BPE"):
        port.export_sentencepiece_model(str(bad), str(tmp_path / "x"))
    bad.write_text(json.dumps({"model": {"type": "BPE", "merges": [],
                                         "vocab": {"a": 0, "b": 2}}}))
    with pytest.raises(ValueError, match="not contiguous"):
        port.export_sentencepiece_model(str(bad), str(tmp_path / "x"))


@pytest.mark.parametrize("keep_accents", [False, True])
def test_build_vocabulary_writes_what_the_jax_cli_writes(tmp_path,
                                                         keep_accents):
    from virtex_tpu_torch.scripts import build_vocabulary
    root = make_fake_coco(str(tmp_path / "coco"), n_images=8)
    captions = os.path.join(root, "annotations", "captions_train2017.json")
    with open(captions) as f:
        blob = json.load(f)
    for i, ann in enumerate(blob["annotations"]):  # accents and capitals
        ann["caption"] = ann["caption"] + [" Café", " NAÏVE", ""][i % 3]
    with open(captions, "w") as f:
        json.dump(blob, f)
    argv = ["-c", captions, "-s", "120"] + (["-a"] if keep_accents else [])
    parser = build_vocabulary.build_parser()
    out = build_vocabulary.main(parser.parse_args(
        argv + ["-o", str(tmp_path / "port" / "vocab")]))
    done = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "build_vocabulary.py")]
        + argv + ["-o", str(tmp_path / "jax" / "vocab")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert out == {"model": str(tmp_path / "port" / "vocab.model"),
                   "sp_model": str(tmp_path / "port" / "vocab.sp.model")}
    for suffix in (".model", ".sp.model"):
        ours = (tmp_path / "port" / f"vocab{suffix}").read_bytes()
        assert ours == (tmp_path / "jax" / f"vocab{suffix}").read_bytes()
