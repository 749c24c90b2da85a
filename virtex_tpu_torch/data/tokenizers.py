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

A binary SentencePiece BPE ``.model`` (the reference's ``coco_10k.model``)
is read too, without the sentencepiece or protobuf packages: the
``ModelProto`` is parsed from the protobuf wire format here
(:func:`read_sentencepiece_model`), and the merges are rebuilt from the
piece table as the JAX package rebuilds them: every split of a NORMAL or
USER_DEFINED piece whose halves are both pieces is a merge, ranked by
−score (SentencePiece's BPE trainer scores each merged piece with its
negated merge rank), then by (piece id, left id, right id); by piece id
alone when every score is equal. Such a model has no added tokens; it
runs the BPE above with ``fuse_unk`` and the ``▁`` Metaspace. A Unigram
model, or a BPE model with ``byte_fallback``, raises.
"""
from __future__ import annotations

import json
import struct
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
    / ``decode`` over a BPE vocabulary (see the module docstring).

    Args:
        model_path: the tokenizer JSON that ``train_tokenizer`` writes, or
            a binary SentencePiece BPE ``.model``; the first byte tells
            them apart.
    """

    def __init__(self, model_path: str):
        self.model_path = model_path
        with open(model_path, "rb") as f:
            data = f.read()
        # A proto's first byte is a field tag (pieces: 0x0a), never "{".
        if data[:64].lstrip()[:1] == b"{":
            self._load_json(json.loads(data.decode("utf-8")))
        else:
            self._load_sentencepiece(data)
        self._id_to_token = {i: t for t, i in self._token_to_id.items()}
        self._cache: Dict[str, List[int]] = {}

    def _load_json(self, blob) -> None:
        model_path = self.model_path
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

    def _load_sentencepiece(self, data: bytes) -> None:
        proto = read_sentencepiece_model(
            data, f"{self.model_path} (a binary SentencePiece model)")
        if proto["model_type"] == SP_UNIGRAM:
            raise ValueError(
                f"{self.model_path}: a Unigram SentencePiece model; the "
                "port reads BPE models only (a Unigram reader is queued in "
                "ROADMAP.md §1, item 4)")
        if proto["byte_fallback"]:
            raise ValueError(f"{self.model_path}: byte_fallback is not "
                             "supported")
        pieces = proto["pieces"]
        self._vocab = {piece: i for i, (piece, _, _) in enumerate(pieces)}
        self._ranks = sentencepiece_merges(pieces, self._vocab)
        self._unk, self._fuse_unk, self._ignore_merges = "<unk>", True, False
        self._replacement, self._prepend = "\u2581", True
        self._special, self._added = set(), []
        self._token_to_id = dict(self._vocab)

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


# -- binary SentencePiece models ----------------------------------------------
# sentencepiece_model.proto: ModelProto.pieces = 1, .trainer_spec = 2;
# SentencePiece.piece = 1, .score = 2, .type = 3 (default NORMAL);
# TrainerSpec.model_type = 3 (default UNIGRAM), .byte_fallback = 35.
SP_UNIGRAM = 1
SP_NORMAL, SP_USER_DEFINED = 1, 4
_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5


def _varint(buf: bytes, i: int, where: str) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if i >= len(buf) or shift > 63:
            raise ValueError(f"{where}: truncated or malformed protobuf "
                             "varint")
        byte = buf[i]
        i += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if byte < 0x80:
            return value, i


def _fields(buf: bytes, where: str):
    """(field number, wire type, value) of each field of one message: an
    int for a varint, the raw bytes otherwise. Raises on a field that runs
    past the end, and on the deprecated group wire types."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i, where)
        number, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, i = _varint(buf, i, where)
        elif wire in (_BYTES, _FIXED32, _FIXED64):
            if wire == _BYTES:
                size, i = _varint(buf, i, where)
            else:
                size = 4 if wire == _FIXED32 else 8
            if i + size > len(buf):
                raise ValueError(f"{where}: truncated protobuf (field "
                                 f"{number} runs past the end)")
            value, i = buf[i:i + size], i + size
        else:
            raise ValueError(f"{where}: protobuf wire type {wire} (field "
                             f"{number}) is not read")
        if number == 0:
            raise ValueError(f"{where}: protobuf field number 0")
        yield number, wire, value


def _expect(wire: int, want: int, what: str, where: str) -> None:
    if wire != want:
        raise ValueError(f"{where}: {what} has wire type {wire}, expected "
                         f"{want}")


def read_sentencepiece_model(data: bytes, where: str = "model"
                             ) -> Dict[str, object]:
    """The parts of a serialized SentencePiece ``ModelProto`` the tokenizer
    uses: ``pieces`` as (piece, score, type) in id order, ``model_type``
    and ``byte_fallback``, with the proto's defaults where a field is
    absent. Other fields are skipped; a later occurrence of a scalar field
    wins, as protobuf merges."""
    pieces: List[Tuple[str, float, int]] = []
    model_type, byte_fallback = SP_UNIGRAM, False
    for number, wire, value in _fields(data, where):
        if number == 1:
            _expect(wire, _BYTES, "ModelProto.pieces", where)
            piece, score, kind = "", 0.0, SP_NORMAL
            for n, w, v in _fields(value, where):
                if n == 1:
                    _expect(w, _BYTES, "SentencePiece.piece", where)
                    piece = v.decode("utf-8")
                elif n == 2:
                    _expect(w, _FIXED32, "SentencePiece.score", where)
                    score = struct.unpack("<f", v)[0]
                elif n == 3:
                    _expect(w, _VARINT, "SentencePiece.type", where)
                    kind = v
            pieces.append((piece, score, kind))
        elif number == 2:
            _expect(wire, _BYTES, "ModelProto.trainer_spec", where)
            for n, w, v in _fields(value, where):
                if n == 3:
                    _expect(w, _VARINT, "TrainerSpec.model_type", where)
                    model_type = v
                elif n == 35:
                    _expect(w, _VARINT, "TrainerSpec.byte_fallback", where)
                    byte_fallback = bool(v)
    return {"pieces": pieces, "model_type": model_type,
            "byte_fallback": byte_fallback}


def sentencepiece_merges(pieces: List[Tuple[str, float, int]],
                         vocab: Dict[str, int]) -> Dict[Tuple[str, str], int]:
    """The BPE merge ranks of a SentencePiece piece table, as
    ``virtex_tpu/data/tokenizers.py`` rebuilds them: each split of a NORMAL
    or USER_DEFINED piece of two or more characters whose halves are both
    pieces, ordered by (−score, piece id, left id, right id), or by
    (piece id, left id, right id) when the candidates' scores are all
    equal (a proto whose scores carry no order)."""
    candidates = []
    for pid, (piece, score, kind) in enumerate(pieces):
        if len(piece) < 2 or kind not in (SP_NORMAL, SP_USER_DEFINED):
            continue
        for split in range(1, len(piece)):
            left, right = piece[:split], piece[split:]
            if left in vocab and right in vocab:
                candidates.append((-score, pid, vocab[left], vocab[right],
                                   left, right))
    ordered = len({c[0] for c in candidates}) > 1
    candidates.sort(key=(lambda c: c[:4]) if ordered else (lambda c: c[1:4]))
    ranks: Dict[Tuple[str, str], int] = {}
    for rank, c in enumerate(candidates):
        ranks.setdefault((c[4], c[5]), rank)
    return ranks
