"""The port's pure-Python tokenizer (virtex_tpu_torch.data.tokenizers)
against the JAX package's SentencePieceBPETokenizer (the HF ``tokenizers``
package) on a vocabulary that train_tokenizer trains: ids and decodes must
be equal, token for token.

Binary SentencePiece ``.model`` files, written with the ``transformers``
proto schema (the port's own reader needs neither it nor ``protobuf``):
the hand-built proto of ``tests/test_sentencepiece_load.py``, a trained
vocabulary exported by ``export_sentencepiece_model``, and the committed
fixture that ``chip_smoke.py`` checks on the GPU machine. Ids and decodes
equal the JAX reader's; uniform scores take the piece-id order; a
truncated proto raises.

Unigram and byte fallback: pieces and scores that HF's ``UnigramTrainer``
trains on synthetic captions, as a Unigram ``.model`` and JSON, with all
256 byte pieces, a few of them, or none; a BPE vocabulary with byte
pieces added, as a ``.model`` and JSON. Ids and decodes equal the JAX
reader's. ``tests/fixtures/torch_sp_unigram.model`` (Unigram with byte
fallback) and its golden, the JAX reader's encodings of
``scripts/tokenizer_selfcheck.py``'s pinned captions, are written by

    python -m tests.test_torch_tokenizer

and the port's ``tokenizer_selfcheck`` passes on them."""
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
    default model_type), read as the JAX reader reads it; one whose piece
    runs past the end is refused as truncated."""
    path = tmp_path / "coco_10k.model"
    path.write_bytes(b"\x0a\x0c\x0a\x05<unk>\x15\x00\x00\x00\x00")
    ref, port = _sp_pair(path)
    _assert_same(ref, port, ["", "a", "ab c", "<unk>"])
    assert port.encode("ab c") == [0, 0]
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


@pytest.mark.parametrize("model_type,byte_fallback,what", [
    (1, False, "Unigram"), (2, True, "byte_fallback")])
def test_unigram_and_byte_fallback_models_raise(tmp_path, model_type,
                                                byte_fallback, what):
    """The smallest Unigram model and BPE model with byte fallback, which
    the port once refused, read as the JAX reader reads them: "é" has the
    byte pieces of its first UTF-8 byte only, so it is <unk>."""
    from tests.test_sentencepiece_load import SPECIALS
    path = tmp_path / f"{what}.model"
    vocab = _proto(path, SPECIALS + [("▁", -0.5, 1), ("a", -1.0, 1),
                                     ("<0x62>", 0.0, 6), ("<0xC3>", 0.0, 6)],
                   model_type, byte_fallback)
    ref, port = _sp_pair(path)
    _assert_same(ref, port, ["", "a", "aa ab", "é b", "<unk>", "cab"])
    want = vocab["<0x62>"] if byte_fallback else 0
    assert port.encode("b") == ref.encode("b") == [vocab["▁"], want]


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


# -- Unigram and byte fallback ---------------------------------------------------
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
UNIGRAM_MODEL = os.path.join(FIXTURES, "torch_sp_unigram.model")
UNIGRAM_GOLDEN = os.path.join(FIXTURES, "torch_sp_unigram_golden.json")
UNIGRAM_VOCAB, FIXTURE_VOCAB = 300, 1000
SP_UNKNOWN, SP_CONTROL, SP_NORMAL, SP_BYTE = 2, 3, 1, 6
BYTES = [f"<0x{b:02X}>" for b in range(256)]
# the bytes of "é" and "!" (accents are stripped before encoding), and
# none of "日" or "ß"
SOME_BYTES = ["<0xC3>", "<0xA9>", "<0xBC>", "<0x21>"]
ALPHABET = list("abcdefghijklmnopqrstuvwxyz   ▁éüñ42!?<>[]日本ßα€") + [
    "<unk>", "[SOS]", "left", "right", "<0x41>"]


def _randoms(seed, n=300):
    rng = np.random.RandomState(seed)
    return ["".join(rng.choice(ALPHABET, rng.randint(0, 30)))
            for _ in range(n)]


def _corpus(n):
    from tests.make_torch_sp_reference import captions
    return CAPTIONS + captions(np.random.RandomState(5), n)


def train_unigram(corpus, vocab_size, path=None):
    """HF's UnigramTrainer on ``corpus`` (lowercased, accent-stripped),
    with the special tokens: its (piece, score, type) table, and its
    tokenizer JSON at ``path``."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
    tok.decoder = decoders.Metaspace(replacement="▁")
    tok.train_from_iterator(
        [preprocess_caption(c) for c in corpus],
        trainer=trainers.UnigramTrainer(
            vocab_size=vocab_size, special_tokens=["<unk>", "[SOS]", "[EOS]",
                                                   "[MASK]"],
            unk_token="<unk>", show_progress=False))
    if path is not None:
        tok.save(str(path))
    vocab = json.loads(tok.to_str())["model"]["vocab"]
    kinds = {"<unk>": SP_UNKNOWN, "[SOS]": SP_CONTROL, "[EOS]": SP_CONTROL,
             "[MASK]": SP_CONTROL}
    return [(p, float(sc), kinds.get(p, SP_NORMAL)) for p, sc in vocab]


@pytest.fixture(scope="module")
def unigram(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unigram")
    pieces = train_unigram(_corpus(600), UNIGRAM_VOCAB, tmp / "unigram.json")
    assert len(pieces) > 200
    return tmp, pieces


def _byte_pieces(names):
    return [(b, 0.0, SP_BYTE) for b in names]


@pytest.mark.parametrize("byte_pieces", ["none", "all", "some"])
def test_unigram_model_equals_the_jax_reader(unigram, byte_pieces):
    tmp, pieces = unigram
    extra = {"none": [], "all": BYTES, "some": SOME_BYTES}[byte_pieces]
    path = tmp / f"unigram_{byte_pieces}.model"
    _proto(path, pieces + _byte_pieces(extra), 1, byte_pieces != "none")
    ref, port = _sp_pair(path)
    _assert_same(ref, port, SP_TEXTS + _randoms(11))


@pytest.mark.parametrize("byte_fallback", [False, True])
def test_unigram_json_equals_the_jax_reader(unigram, byte_fallback):
    """The JSON the HF trainer writes, and the same with byte pieces and
    byte fallback."""
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    tmp, _ = unigram
    blob = json.loads((tmp / "unigram.json").read_text())
    if byte_fallback:
        blob["model"]["vocab"] += [[b, 0.0] for b in BYTES]
        blob["model"]["byte_fallback"] = True
    path = tmp / f"unigram_{byte_fallback}.json"
    path.write_text(json.dumps(blob))
    ref, port = Jax(str(path)), SentencePieceBPETokenizer(str(path))
    _assert_same(ref, port, TEXTS + SP_TEXTS + _randoms(12))


@pytest.mark.parametrize("byte_pieces", ["all", "some"])
def test_byte_fallback_bpe_model_equals_the_jax_reader(exported, tmp_path,
                                                       byte_pieces):
    """The exported BPE vocabulary with byte pieces appended and
    ``byte_fallback`` on. With some byte pieces, a character whose bytes
    are not all pieces is <unk>, emitted after later byte pieces."""
    from virtex_tpu_torch.data.tokenizers import read_sentencepiece_model
    pieces = read_sentencepiece_model(exported.read_bytes())["pieces"]
    extra = BYTES if byte_pieces == "all" else SOME_BYTES
    path = tmp_path / "bpe_bytes.model"
    _proto(path, pieces + _byte_pieces(extra), 2, True)
    ref, port = _sp_pair(path)
    _assert_same(ref, port, SP_TEXTS + _randoms(13) + ["日!", "日!日a"])
    if byte_pieces == "some":   # "日" waits for the next known character
        assert [port.id_to_token(i) for i in port.encode("日!")] == [
            "▁", "<0x21>", "<unk>"]


def test_byte_fallback_bpe_json_equals_the_jax_reader(tokenizers, tmp_path):
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    ref_json, _ = tokenizers
    blob = json.loads(open(ref_json.model_path, encoding="utf-8").read())
    vocab = blob["model"]["vocab"]
    for b in BYTES:
        vocab[b] = len(vocab)
    blob["model"]["byte_fallback"] = True
    path = tmp_path / "bpe_bytes.json"
    path.write_text(json.dumps(blob))
    ref, port = Jax(str(path)), SentencePieceBPETokenizer(str(path))
    _assert_same(ref, port, TEXTS + SP_TEXTS + _randoms(14))


def test_a_json_without_the_metaspace_decoder_is_refused(tokenizers,
                                                         tmp_path):
    ref_json, _ = tokenizers
    blob = json.loads(open(ref_json.model_path, encoding="utf-8").read())
    blob["decoder"] = {"type": "ByteFallback"}
    path = tmp_path / "decoder.json"
    path.write_text(json.dumps(blob))
    with pytest.raises(ValueError, match="Metaspace as the decoder"):
        SentencePieceBPETokenizer(str(path))


# -- the committed Unigram fixture and tokenizer_selfcheck ------------------------
def _jax_selfcheck():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_tokenizer_selfcheck", os.path.join(
            os.path.dirname(FIXTURES), "..", "scripts",
            "tokenizer_selfcheck.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_unigram_fixture(model=UNIGRAM_MODEL, golden=UNIGRAM_GOLDEN):
    """A Unigram ``.model`` with byte fallback (HF's UnigramTrainer on
    synthetic captions, and all 256 byte pieces), and the golden of
    ``scripts/tokenizer_selfcheck.py``: the JAX reader's encodings of its
    pinned captions."""
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    pieces = train_unigram(_corpus(3000), FIXTURE_VOCAB)
    _proto(model, pieces + _byte_pieces(BYTES), 1, True)
    jax_check = _jax_selfcheck()
    jax_check._write_golden(golden, model, jax_check.encode_all(Jax(model)))


def test_the_committed_unigram_fixture_is_what_the_jax_reader_reads():
    from virtex_tpu.data.tokenizers import SentencePieceBPETokenizer as Jax
    from virtex_tpu_torch.scripts import tokenizer_selfcheck
    jax_check = _jax_selfcheck()
    assert tokenizer_selfcheck.PINNED_CAPTIONS == jax_check.PINNED_CAPTIONS
    with open(UNIGRAM_GOLDEN) as f:
        golden = json.load(f)
    assert golden["model"] == os.path.basename(UNIGRAM_MODEL)
    assert golden["encodings"] == jax_check.encode_all(Jax(UNIGRAM_MODEL))
    port = SentencePieceBPETokenizer(UNIGRAM_MODEL)
    assert port.get_vocab_size() >= FIXTURE_VOCAB
    # byte pieces are on the golden's path: "αβγ" has no piece
    assert any(port.id_to_token(i).startswith("<0x")
               for ids in golden["encodings"] for i in ids)
    assert tokenizer_selfcheck.main(["--model", UNIGRAM_MODEL, "--golden",
                                     UNIGRAM_GOLDEN]) == 0


def test_tokenizer_selfcheck_without_a_golden_writes_a_candidate(
        tmp_path, tokenizers, capsys):
    from virtex_tpu_torch.scripts import tokenizer_selfcheck as check
    golden = str(tmp_path / "golden.json")
    for extra in ([], ["--write-golden"]):   # refused for a binary model
        assert check.main(["--model", UNIGRAM_MODEL, "--golden", golden,
                           *extra]) == 1
        assert not os.path.exists(golden)
        with open(golden + ".candidate") as f:
            candidate = json.load(f)
        with open(UNIGRAM_GOLDEN) as f:
            assert candidate == json.load(f)
        os.remove(golden + ".candidate")
    assert "UNVERIFIED" in capsys.readouterr().out
    # a JSON's golden may be written, and then passes
    _, port = tokenizers
    assert check.main(["--model", port.model_path, "--golden", golden,
                       "--write-golden"]) == 0
    assert check.main(["--model", port.model_path, "--golden", golden]) == 0
    # another model's golden, or other encodings, fail
    assert check.main(["--model", UNIGRAM_MODEL, "--golden", golden]) == 1
    with open(golden) as f:
        blob = json.load(f)
    blob["encodings"][0] = blob["encodings"][0][:-1]
    with open(golden, "w") as f:
        json.dump(blob, f)
    assert check.main(["--model", port.model_path, "--golden", golden]) == 1


if __name__ == "__main__":
    write_unigram_fixture()
    print(f"wrote {UNIGRAM_MODEL} and {UNIGRAM_GOLDEN}")
