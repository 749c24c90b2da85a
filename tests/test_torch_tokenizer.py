"""The port's pure-Python tokenizer (virtex_tpu_torch.data.tokenizers)
against the JAX package's SentencePieceBPETokenizer (the HF ``tokenizers``
package) on a vocabulary that train_tokenizer trains: ids and decodes must
be equal, token for token."""
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
    path = tmp_path / "coco_10k.model"
    path.write_bytes(b"\x0a\x0b\x0a\x05<unk>\x15\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="SentencePiece"):
        SentencePieceBPETokenizer(str(path))
