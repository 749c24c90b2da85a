"""Write tests/fixtures/torch_sp_bpe.model and torch_sp_bpe_golden.json: a
binary SentencePiece BPE vocabulary, and the ids and decodes that the JAX
package's reader gives on it for a set of captions.

The vocabulary is trained by ``virtex_tpu.data.tokenizers.train_tokenizer``
on synthetic captions (words from a numpy seed) and exported by
``export_sentencepiece_model``, so it is a ``.model`` as the reference's
toolchain writes one, with merge ranks in the piece scores. The golden
captions are synthetic ones, accented text, runs of characters outside the
vocabulary and empty strings. ``chip_smoke.py`` holds the port's reader to
the golden on the GPU machine, which has no ``transformers``;
``tests/test_torch_tokenizer.py`` checks here that the golden is what the
JAX reader gives.

    python -m tests.make_torch_sp_reference
"""
import json
import os
import tempfile

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
MODEL = os.path.join(FIXTURES, "torch_sp_bpe.model")
GOLDEN = os.path.join(FIXTURES, "torch_sp_bpe_golden.json")
SEED = 0
VOCAB_SIZE = 1200
CORPUS, GOLDEN_CAPTIONS = 3000, 160
SYLLABLES = ["ba", "ko", "ri", "tes", "mon", "da", "le", "sun", "pra",
             "chi", "vo", "nel", "gar", "ti", "pu", "fe", "lo", "mar",
             "zen", "qui", "do", "ra", "shi", "wen", "ka", "bel", "tor",
             "an", "es", "ol"]
COMMON = ["a", "the", "of", "on", "in", "with", "and", "two", "man",
          "woman", "dog", "cat", "red", "blue", "left", "right", "sitting",
          "standing", "next", "to", "street", "table", "small", "large"]
EXTRA = ["", " ", "A Man Riding A WAVE", "Café déjà vu à Noël",
         "naïve façade", "ÀÉÎÕÜ ß œ", "日本語 text", "42 zebras xq 99",
         "zzz qqq 123 !!", "  two  spaces ", "tabs\tand\nlines",
         "▁leading marker", "a<unk>b", "[MASK] the [SOS]",
         "left-hand bright right", "§§ ¶¶ a dog ¤"]


def captions(rng, n: int):
    """``n`` captions of 5-12 words, each a common word or one of 3000
    pseudo-words of 1-4 syllables, by halves."""
    words = ["".join(rng.choice(SYLLABLES, rng.randint(1, 5)))
             for _ in range(3000)]
    out = []
    for _ in range(n):
        k = rng.randint(5, 13)
        out.append(" ".join(
            COMMON[rng.randint(len(COMMON))] if rng.rand() < 0.5
            else words[rng.randint(len(words))] for _ in range(k)))
    return out


def golden_texts():
    rng = np.random.RandomState(SEED + 1)
    return captions(rng, GOLDEN_CAPTIONS) + EXTRA + [
        "".join(rng.choice(list("abcdefghij ▁éü42!?<>[]"),
                           rng.randint(0, 25)))
        for _ in range(24)]


def write(model_path: str = MODEL, golden_path: str = GOLDEN) -> None:
    from virtex_tpu.data.tokenizers import (
        SentencePieceBPETokenizer,
        export_sentencepiece_model,
        train_tokenizer,
    )
    rng = np.random.RandomState(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_tokenizer(captions(rng, CORPUS),
                                  os.path.join(tmp, "vocab.json"),
                                  vocab_size=VOCAB_SIZE)
        os.makedirs(os.path.dirname(model_path), exist_ok=True)
        export_sentencepiece_model(trained.model_path, model_path)
    reader = SentencePieceBPETokenizer(model_path)
    cases = []
    for text in golden_texts():
        ids = reader.encode(text)
        cases.append({"text": text, "ids": ids, "decoded": reader.decode(ids)})
    with open(golden_path, "w", encoding="utf-8") as f:
        json.dump({"model": os.path.basename(MODEL),
                   "vocab_size": reader.get_vocab_size(), "cases": cases},
                  f, ensure_ascii=False, indent=0)
        f.write("\n")
    print(f"wrote {model_path} ({reader.get_vocab_size()} pieces) and "
          f"{golden_path} ({len(cases)} captions)")


if __name__ == "__main__":
    write()
