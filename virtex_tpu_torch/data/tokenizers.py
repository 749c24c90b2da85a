r"""
The caption tokenizer, read from the JSON vocabulary file that
``virtex_tpu.data.tokenizers.train_tokenizer`` writes, in pure Python.

Counterpart of ``virtex_tpu/data/tokenizers.py``
:class:`SentencePieceBPETokenizer`, without the HF ``tokenizers`` package.
It reads the file's BPE model and runs it as that package does:

- the special tokens (``<unk>`` 0, which doubles as padding, ``[SOS]`` 1,
  ``[EOS]`` 2, ``[MASK]`` 3) are matched in the text first, leftmost and
  longest, and the text between them is tokenized on its own;
- the Metaspace pre-tokenizer replaces spaces with ``▁``, prepends one
  ``▁`` to a piece that does not start with it (``prepend_scheme``
  ``always``), and splits before every ``▁``;
- each word is split into characters (a character outside the vocabulary
  is ``<unk>``, and with ``fuse_unk`` a run of them is one ``<unk>``), then
  the adjacent pair of lowest merge rank is merged, leftmost first, until
  no pair has a merge;
- :meth:`decode` drops ids ≤ 3, turns ``▁`` into spaces (none in the first
  token) and strips the result.

Binary SentencePiece ``.model`` files (the reference's ``coco_10k.model``)
are not read yet; loading one raises.
"""
from __future__ import annotations

import json
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

SPECIAL_TOKENS = ["<unk>", "[SOS]", "[EOS]", "[MASK]"]
UNK_INDEX, SOS_INDEX, EOS_INDEX, MASK_INDEX = 0, 1, 2, 3


def preprocess_caption(text: str, lower: bool = True,
                       strip_accents: bool = True) -> str:
    """Lowercase and NFKD accent-strip, as the JAX package's
    ``preprocess_caption`` does."""
    if lower:
        text = text.lower()
    if strip_accents:
        text = unicodedata.normalize("NFKD", text)
        text = "".join(c for c in text if not unicodedata.combining(c))
    return text


class SentencePieceBPETokenizer:
    """``get_vocab_size`` / ``token_to_id`` / ``id_to_token`` / ``encode``
    / ``decode`` over a BPE vocabulary JSON (see the module docstring).

    Args:
        model_path: the tokenizer JSON that ``train_tokenizer`` writes.
    """

    def __init__(self, model_path: str):
        self.model_path = model_path
        with open(model_path, "rb") as f:
            head = f.read(64)
        if head.lstrip()[:1] != b"{":
            raise ValueError(
                f"{model_path}: not a tokenizer JSON. Binary SentencePiece "
                ".model files are not read by the port yet; convert the "
                "vocabulary with the JAX package's tools")
        with open(model_path, encoding="utf-8") as f:
            blob = json.load(f)
        model = blob["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"{model_path}: model type "
                             f"{model.get('type')!r}, expected BPE")
        for key in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if model.get(key) is not None:
                raise ValueError(f"{model_path}: BPE {key} is not supported")
        if model.get("byte_fallback"):
            raise ValueError(f"{model_path}: byte_fallback is not supported")
        if blob.get("normalizer") is not None:
            raise ValueError(f"{model_path}: a normalizer is not supported")
        self._replacement, self._prepend = _metaspace(
            blob.get("pre_tokenizer"), model_path)
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._unk = model.get("unk_token")
        self._fuse_unk = bool(model.get("fuse_unk", False))
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._ranks: Dict[Tuple[str, str], int] = {}
        for rank, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self._ranks.setdefault((a, b), rank)
        added = {t["content"]: t["id"] for t in blob.get("added_tokens", [])}
        self._special = {t["id"] for t in blob.get("added_tokens", [])
                         if t.get("special")}
        self._added = sorted(added, key=len, reverse=True)
        self._token_to_id = {**self._vocab, **added}
        self._id_to_token = {i: t for t, i in self._token_to_id.items()}
        self._cache: Dict[str, List[int]] = {}

    # -- vocabulary ------------------------------------------------------------
    def get_vocab_size(self) -> int:
        return len(self._token_to_id)

    def token_to_id(self, token: str) -> int:
        return self._token_to_id.get(token, UNK_INDEX)

    def id_to_token(self, token_id: int) -> str:
        return self._id_to_token.get(int(token_id), "<unk>")

    # -- encode ----------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        """A raw caption → token ids (no [SOS]/[EOS])."""
        ids: List[int] = []
        for piece, is_added in self._split_added(preprocess_caption(text)):
            if is_added:
                ids.append(self._token_to_id[piece])
                continue
            for word in self._pre_tokenize(piece):
                ids.extend(self._bpe(word))
        return ids

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """Leftmost-longest matches of the added tokens, and the non-empty
        text between them."""
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in self._added if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if start < i:
                out.append((text[start:i], False))
            out.append((hit, True))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _pre_tokenize(self, text: str) -> List[str]:
        r = self._replacement
        text = text.replace(" ", r)
        if self._prepend and not text.startswith(r):
            text = r + text
        words, cur = [], ""
        for c in text:
            if c == r and cur:
                words.append(cur)
                cur = ""
            cur += c
        if cur:
            words.append(cur)
        return words

    def _bpe(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            symbols: List[Optional[str]] = []  # None: an unknown character
            for c in word:
                if c in self._vocab:
                    symbols.append(c)
                elif not (self._fuse_unk and symbols and symbols[-1] is None):
                    symbols.append(None)
            while len(symbols) > 1:
                best = None
                for i in range(len(symbols) - 1):
                    rank = self._ranks.get((symbols[i], symbols[i + 1]))
                    if rank is not None and (best is None or rank < best[0]):
                        best = (rank, i)
                if best is None:
                    break
                i = best[1]
                symbols[i:i + 2] = [symbols[i] + symbols[i + 1]]
            if None in symbols and self._unk not in self._vocab:
                raise ValueError(f"{self.model_path}: unknown character in "
                                 f"{word!r} and no unk token")
            ids = [self._vocab[s] if s is not None else self._vocab[self._unk]
                   for s in symbols]
        self._cache[word] = ids
        return ids

    # -- decode ----------------------------------------------------------------
    def decode(self, token_ids: Iterable[int]) -> str:
        """Token ids → a caption. Ids ≤ 3 (the special tokens, with
        ``<unk>`` as padding) are dropped, as the JAX package drops them."""
        tokens = [self._id_to_token[i] for i in (int(t) for t in token_ids)
                  if i > MASK_INDEX and i in self._id_to_token
                  and i not in self._special]
        r = self._replacement
        return "".join(
            (t.replace(r, "") if i == 0 and self._prepend else
             t.replace(r, " ")) for i, t in enumerate(tokens)).strip()


def _metaspace(pre_tokenizer, path: str) -> Tuple[str, bool]:
    """(replacement, prepend) of a Metaspace pre-tokenizer that splits."""
    if not pre_tokenizer or pre_tokenizer.get("type") != "Metaspace":
        raise ValueError(f"{path}: expected a Metaspace pre-tokenizer")
    if not pre_tokenizer.get("split", True):
        raise ValueError(f"{path}: Metaspace without split is not supported")
    scheme = pre_tokenizer.get("prepend_scheme")
    if scheme is None:  # files of older tokenizers releases
        scheme = "always" if pre_tokenizer.get("add_prefix_space",
                                               True) else "never"
    if scheme not in ("always", "never"):
        raise ValueError(f"{path}: prepend_scheme {scheme!r} is not "
                         "supported")
    return pre_tokenizer.get("replacement", "▁"), scheme == "always"
