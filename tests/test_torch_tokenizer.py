"""The port's pure-Python tokenizer (virtex_tpu_torch.data.tokenizers)
against the JAX package's SentencePieceBPETokenizer (the HF ``tokenizers``
package) on a vocabulary that train_tokenizer trains: ids and decodes must
be equal, token for token.

Binary SentencePiece ``.model`` files, written with the ``transformers``
proto schema (the port's own reader needs neither it nor ``protobuf``):
the hand-built proto of ``tests/test_sentencepiece_load.py``, a trained
vocabulary exported by ``export_sentencepiece_model``, and the committed
fixture that ``chip_smoke.py`` checks on the GPU machine. Ids and decodes
equal the JAX reader's; uniform scores take the piece-id order; a Unigram,
a byte-fallback and a truncated proto raise."""
import json
import os

import numpy as np
import pytest

from tests.utils_fixtures import CAPTIONS, make_tokenizer
from virtex_tpu_torch.data.tokenizers import (
    SentencePieceBPETokenizer,
    preprocess_caption,
)

TEXTS = CAPTIONS + [
    "", " ", "A Man Riding A WAVE", "Café déjà vu à Noël", "naïve façade",
    "42 zebras xq", "zzz qqq 123 !!", "  two  spaces ", "tabs\tand\nlines",
    "▁leading marker", "a<unk>b", "<unk>", "[MASK] the [SOS]",
    "left-hand bright right", "ÀÉÎÕÜ ß œ", "日本語 text",
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    ref = make_tokenizer(tmp_path_factory.mktemp("tok"))
    return ref, SentencePieceBPETokenizer(ref.model_path)


@pytest.mark.parametrize("text", TEXTS)
def test_ids_equal_the_jax_tokenizer(tokenizers, text):
    ref, port = tokenizers
    assert port.encode(text) == ref.encode(text)


def test_random_strings_encode_and_decode_equal(tokenizers):
    ref, port = tokenizers
    rng = np.random.RandomState(0)
    alphabet = list("abcdefghijklmnopqrstuvwxyz   ▁éüñ42!?<>[]") + [
        "<unk>", "[SOS]", "left", "right"]
    for _ in range(500):
        text = "".join(rng.choice(alphabet, rng.randint(0, 30)))
        ids = ref.encode(text)
        assert port.encode(text) == ids, text
        noisy = ids + [int(i) for i in rng.randint(0, ref.get_vocab_size(),
                                                   3)]
        assert port.decode(noisy) == ref.decode(noisy), noisy


@pytest.mark.parametrize("text", TEXTS)
def test_decode_equals_the_jax_tokenizer(tokenizers, text):
    ref, port = tokenizers
    ids = ref.encode(text)
    # with the special and padding ids that decode drops
    for seq in (ids, [1, *ids, 2, 0, 0], [3, 0] + ids):
        assert port.decode(seq) == ref.decode(seq)


def test_vocabulary_lookups(tokenizers):
    ref, port = tokenizers
    assert port.get_vocab_size() == ref.get_vocab_size()
    for token in ("<unk>", "[SOS]", "[EOS]", "[MASK]", "▁a", "▁man", "zz"):
        assert port.token_to_id(token) == ref.token_to_id(token)
    for i in range(ref.get_vocab_size() + 2):
        assert port.id_to_token(i) == ref.id_to_token(i)
    assert [port.token_to_id(t) for t in ("<unk>", "[SOS]", "[EOS]",
                                          "[MASK]")] == [0, 1, 2, 3]


def test_fuse_unk_makes_one_unk_of_a_run(tokenizers):
    _, port = tokenizers
    ids = port.encode("q9 9q")  # '9' is not in the fixture's vocabulary
    assert ids.count(0) == 2 and 0 not in (ids[0],)


def test_preprocess_caption_matches(tokenizers):
    from virtex_tpu.data.tokenizers import preprocess_caption as ref
    for text in TEXTS:
        assert preprocess_caption(text) == ref(text)


def test_binary_sentencepiece_model_is_refused(tmp_path):
    """A proto without a trainer_spec is a Unigram model (the proto's
    default model_type), which the port refuses; one whose piece runs past
    the end is refused as truncated."""
    path = tmp_path / "coco_10k.model"
    path.write_bytes(b"\x0a\x0c\x0a\x05<unk>\x15\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="Unigram SentencePiece"):
        SentencePieceBPETokenizer(str(path))
    path.write_bytes(b"\x0a\x0b\x0a\x05<unk>\x15\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="SentencePiece.*truncated"):
        SentencePieceBPETokenizer(str(path))


# -- binary SentencePiece .model files ------------------------------------------
SP_TEXTS = TEXTS + ["cats", "cat", "a cat sat", "catsss zz", "scat at cats",
                    "▁▁cat", "Çàt çats"]


def _sp_pair(path):
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    return Jax(str(path)), SentencePieceBPETokenizer(str(path))


def _assert_same(ref, port, texts, seed=0):
    assert port.get_vocab_size() == ref.get_vocab_size()
    rng = np.random.RandomState(seed)
    for text in texts:
        ids = ref.encode(text)
        assert port.encode(text) == ids, text
        noisy = [1, *ids, 2, 0] + [int(i) for i in rng.randint(
            0, ref.get_vocab_size() + 2, 3)]
        assert port.decode(ids) == ref.decode(ids), ids
        assert port.decode(noisy) == ref.decode(noisy), noisy
    for i in range(ref.get_vocab_size() + 2):
        assert port.id_to_token(i) == ref.id_to_token(i)
        assert port.token_to_id(ref.id_to_token(i)) == ref.token_to_id(
            ref.id_to_token(i))


def test_hand_built_sentencepiece_model_equals_the_jax_reader(tmp_path):
    from tests.test_sentencepiece_load import build_sp_model
    path = tmp_path / "toy.model"
    vocab = build_sp_model(str(path))
    ref, port = _sp_pair(path)
    _assert_same(ref, port, SP_TEXTS)
    assert port.encode("cats") == [vocab["▁cats"]]
    assert port.decode([vocab["▁cats"]]) == "cats"


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    from virtex_tpu.data.tokenizers import export_sentencepiece_model
    tmp = tmp_path_factory.mktemp("sp")
    path = tmp / "exported.model"
    export_sentencepiece_model(make_tokenizer(tmp).model_path, str(path))
    return path


def test_exported_vocabulary_equals_the_jax_reader(exported):
    ref, port = _sp_pair(exported)
    rng = np.random.RandomState(3)
    alphabet = list("abcdefghijklmnopqrstuvwxyz   ▁éüñ42!?<>[]") + [
        "<unk>", "[SOS]", "left", "right"]
    randoms = ["".join(rng.choice(alphabet, rng.randint(0, 30)))
               for _ in range(300)]
    _assert_same(ref, port, SP_TEXTS + randoms)


def test_exported_vocabulary_encodes_as_its_json(exported, tokenizers):
    """The export keeps the merge order, so the .model and the JSON it came
    from give the same ids in the port, but for the special tokens: the
    JSON matches them in the text, a .model has no added tokens."""
    _, from_json = tokenizers
    from_model = SentencePieceBPETokenizer(str(exported))
    plain = [t for t in TEXTS if not any(s in t for s in ("<unk>", "[SOS]",
                                                          "[EOS]", "[MASK]"))]
    assert len(plain) > 15
    for text in plain:
        assert from_model.encode(text) == from_json.encode(text), text


def _proto(path, pieces, model_type=2, byte_fallback=False):
    from tests.test_sentencepiece_load import _write_proto
    return _write_proto(str(path), pieces, model_type, byte_fallback)


def test_uniform_scores_take_the_piece_id_order(tmp_path):
    """Every merge candidate scores 0: the merges rank by piece id, so
    "ab" (id 8) merges before "bc" (id 9) in "abc"."""
    from tests.test_sentencepiece_load import SPECIALS
    pieces = SPECIALS + [(c, 0.0, 1) for c in ("▁", "a", "b", "c")] + [
        ("ab", 0.0, 1), ("bc", 0.0, 1), ("▁ab", 0.0, 1), ("▁a", 0.0, 1)]
    vocab = _proto(tmp_path / "uniform.model", pieces)
    ref, port = _sp_pair(tmp_path / "uniform.model")
    assert port.encode("abc") == ref.encode("abc") == [vocab["▁ab"],
                                                        vocab["c"]]
    _assert_same(ref, port, ["abc", "bca", "cab ab", "a b c", ""])


def test_scores_rank_the_merges(tmp_path):
    """The same pieces with scores that rank "bc" first and "▁a" last:
    "▁abc" becomes ▁ a bc, then ▁a bc."""
    from tests.test_sentencepiece_load import SPECIALS
    pieces = SPECIALS + [(c, 0.0, 1) for c in ("▁", "a", "b", "c")] + [
        ("ab", -2.0, 1), ("bc", -1.0, 1), ("▁ab", -3.0, 1), ("▁a", -4.0, 1)]
    vocab = _proto(tmp_path / "scored.model", pieces)
    ref, port = _sp_pair(tmp_path / "scored.model")
    assert port.encode("abc") == ref.encode("abc") == [vocab["▁a"],
                                                        vocab["bc"]]


@pytest.mark.parametrize("model_type,byte_fallback,match", [
    (1, False, "Unigram"), (2, True, "byte_fallback")])
def test_unigram_and_byte_fallback_models_raise(tmp_path, model_type,
                                                byte_fallback, match):
    from tests.test_sentencepiece_load import SPECIALS
    path = tmp_path / "refused.model"
    _proto(path, SPECIALS + [("a", -1.0, 1)], model_type, byte_fallback)
    with pytest.raises(ValueError, match=match):
        SentencePieceBPETokenizer(str(path))


@pytest.mark.parametrize("cut", [1, 7, 300, 2000])
def test_truncated_proto_raises(exported, tmp_path, cut):
    data = exported.read_bytes()
    path = tmp_path / "truncated.model"
    path.write_bytes(data[:-cut])
    with pytest.raises(ValueError, match="truncated"):
        SentencePieceBPETokenizer(str(path))


def test_the_committed_sentencepiece_fixture_is_current(tmp_path):
    """tests/make_torch_sp_reference.py writes the same .model and golden
    again; the JAX reader gives the golden, and so does the port."""
    from tests import make_torch_sp_reference as ref_maker
    model, golden = tmp_path / "sp.model", tmp_path / "golden.json"
    ref_maker.write(str(model), str(golden))
    assert model.read_bytes() == open(ref_maker.MODEL, "rb").read()
    assert golden.read_bytes() == open(ref_maker.GOLDEN, "rb").read()
    with open(ref_maker.GOLDEN, encoding="utf-8") as f:
        blob = json.load(f)
    port = SentencePieceBPETokenizer(ref_maker.MODEL)
    assert port.get_vocab_size() == blob["vocab_size"] >= 1000
    assert len(blob["cases"]) >= 150
    for case in blob["cases"]:
        assert port.encode(case["text"]) == case["ids"], case["text"]
        assert port.decode(case["ids"]) == case["decoded"]
    assert os.path.basename(ref_maker.MODEL) == blob["model"]
