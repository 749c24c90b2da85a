r"""
The caption tokenizer, read from the JSON vocabulary file that
``virtex_tpu.data.tokenizers.train_tokenizer`` writes, or from a binary
SentencePiece ``.model``, in pure Python.

Counterpart of ``virtex_tpu/data/tokenizers.py``
:class:`SentencePieceBPETokenizer`, without the HF ``tokenizers`` package.
It reads a BPE or a Unigram model and runs it as that package does:

- the special tokens (``<unk>`` 0, which doubles as padding, ``[SOS]`` 1,
  ``[EOS]`` 2, ``[MASK]`` 3) are matched in the text first, leftmost and
  longest, and the text between them is tokenized on its own;
- the Metaspace pre-tokenizer replaces spaces with ``▁``, prepends one
  ``▁`` to a piece that does not start with it (``prepend_scheme``
  ``always``), and splits before every ``▁``;
- BPE: each word is split into characters (a character outside the
  vocabulary is ``<unk>``, and with ``fuse_unk`` a run of them is one
  ``<unk>``), then the adjacent pair of lowest merge rank is merged,
  leftmost first, until no pair has a merge;
- Unigram: each word is the best path (Viterbi) over the pieces that match
  at each character, a path's score the sum of its pieces' scores; a
  character with no one-character piece may also be ``<unk>``, scored the
  lowest piece score less 10; a later candidate replaces a node's best
  only if it scores higher; the unknown runs of the best path are fused
  into one string, which is a piece or ``<unk>``;
- byte fallback (either model): a character (BPE) or fused unknown string
  (Unigram) outside the vocabulary becomes the ``<0xNN>`` pieces of its
  UTF-8 bytes when every one of them is a piece, else ``<unk>``. In BPE a
  pending ``<unk>`` is emitted at the next character in the vocabulary or
  at the word's end, so it may follow byte pieces, as the HF model does;
- :meth:`decode` drops ids ≤ 3, turns ``▁`` into spaces (none in the first
  token) and strips the result; a ``<0xNN>`` piece stays as its text, as
  the JAX reader's ``Metaspace`` decoder leaves it.

A binary SentencePiece ``.model`` (the reference's ``coco_10k.model``) is
read without the sentencepiece or protobuf packages: the ``ModelProto`` is
parsed from the protobuf wire format here
(:func:`read_sentencepiece_model`). A Unigram model takes every piece with
its score and ``<unk>`` at id 0. For a BPE model the merges are rebuilt
from the piece table as the JAX package rebuilds them: every split of a
NORMAL or USER_DEFINED piece whose halves are both pieces is a merge,
ranked by −score (SentencePiece's BPE trainer scores each merged piece
with its negated merge rank), then by (piece id, left id, right id); by
piece id alone when every score is equal. Such a model has no added
tokens; it runs with ``fuse_unk``, the proto's ``byte_fallback`` and the
``▁`` Metaspace.

:func:`train_tokenizer` trains such a vocabulary, as the JAX package's
HF ``BpeTrainer`` does, and writes the tokenizer JSON;
:func:`export_sentencepiece_model` writes a vocabulary as a binary
SentencePiece ``ModelProto`` (the wire format written here too).
"""
from __future__ import annotations

import heapq
import itertools
import json
import math
import os
import struct
import unicodedata
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

SPECIAL_TOKENS = ["<unk>", "[SOS]", "[EOS]", "[MASK]"]
UNK_INDEX, SOS_INDEX, EOS_INDEX, MASK_INDEX = 0, 1, 2, 3
# An unknown character's Unigram score: the lowest piece score less this
# (HF ``tokenizers``' ``K_UNK_PENALTY``, SentencePiece's ``kUnkPenalty``).
UNIGRAM_UNK_PENALTY = 10.0


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
    / ``decode`` over a BPE or Unigram vocabulary (see the module
    docstring).

    Args:
        model_path: a tokenizer JSON (a BPE one as ``train_tokenizer``
            writes it, or a Unigram one), or a binary SentencePiece
            ``.model``; the first byte tells them apart.
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
        if blob.get("normalizer") is not None:
            raise ValueError(f"{model_path}: a normalizer is not supported")
        self._replacement, self._prepend = _metaspace(
            blob.get("pre_tokenizer"), model_path)
        decoder = blob.get("decoder") or {}
        if decoder.get("type") != "Metaspace" or _metaspace(
                decoder, model_path) != (self._replacement, self._prepend):
            raise ValueError(f"{model_path}: expected the pre-tokenizer's "
                             "Metaspace as the decoder")
        self._byte_fallback = bool(model.get("byte_fallback", False))
        if model.get("type") == "Unigram":
            self._set_unigram([(p, float(sc)) for p, sc in model["vocab"]],
                              model.get("unk_id"))
        elif model.get("type") == "BPE":
            for key in ("dropout", "continuing_subword_prefix",
                        "end_of_word_suffix"):
                if model.get(key) is not None:
                    raise ValueError(f"{model_path}: BPE {key} is not "
                                     "supported")
            self._unigram = None
            self._vocab: Dict[str, int] = dict(model["vocab"])
            self._unk = model.get("unk_token")
            self._fuse_unk = bool(model.get("fuse_unk", False))
            self._ignore_merges = bool(model.get("ignore_merges", False))
            self._ranks: Dict[Tuple[str, str], int] = {}
            for rank, m in enumerate(model["merges"]):
                a, b = m.split(" ", 1) if isinstance(m, str) else m
                self._ranks.setdefault((a, b), rank)
        else:
            raise ValueError(f"{model_path}: model type "
                             f"{model.get('type')!r}, expected BPE or "
                             "Unigram")
        added = {t["content"]: t["id"] for t in blob.get("added_tokens", [])}
        self._special = {t["id"] for t in blob.get("added_tokens", [])
                         if t.get("special")}
        self._added = sorted(added, key=len, reverse=True)
        self._token_to_id = {**self._vocab, **added}

    def _load_sentencepiece(self, data: bytes) -> None:
        proto = read_sentencepiece_model(
            data, f"{self.model_path} (a binary SentencePiece model)")
        pieces = proto["pieces"]
        self._byte_fallback = proto["byte_fallback"]
        if proto["model_type"] == SP_UNIGRAM:
            self._set_unigram([(p, score) for p, score, _ in pieces],
                              UNK_INDEX)
        else:
            self._unigram = None
            self._vocab = {piece: i for i, (piece, _, _) in enumerate(pieces)}
            self._ranks = sentencepiece_merges(pieces, self._vocab)
            self._unk, self._fuse_unk, self._ignore_merges = ("<unk>", True,
                                                              False)
        self._replacement, self._prepend = "\u2581", True
        self._special, self._added = set(), []
        self._token_to_id = dict(self._vocab)

    def _set_unigram(self, pieces: List[Tuple[str, float]],
                     unk_id: Optional[int]) -> None:
        """A Unigram model of ``pieces`` (piece, score) in id order, as HF
        builds one: a repeated piece takes its last id."""
        if unk_id is not None and not 0 <= unk_id < len(pieces):
            raise ValueError(f"{self.model_path}: Unigram unk_id {unk_id} "
                             f"outside its {len(pieces)} pieces")
        self._unigram = pieces
        self._vocab = {piece: i for i, (piece, _) in enumerate(pieces)}
        self._unk_id = unk_id
        self._unk_score = min((sc for _, sc in pieces),
                              default=math.inf) - UNIGRAM_UNK_PENALTY
        self._max_piece = max((len(p) for p, _ in pieces), default=0)

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
                ids.extend(self._word(word))
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
        return metaspace_words(text, self._replacement, self._prepend)

    def _word(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = (self._bpe(word) if self._unigram is None
                   else self._viterbi(word))
            self._cache[word] = ids
        return ids

    def _bytes(self, text: str) -> Optional[List[str]]:
        """The ``<0xNN>`` pieces of ``text``'s UTF-8 bytes, if byte
        fallback is on and every one of them is a piece."""
        if not self._byte_fallback:
            return None
        pieces = [f"<0x{b:02X}>" for b in text.encode("utf-8")]
        return pieces if all(p in self._vocab for p in pieces) else None

    def _bpe(self, word: str) -> List[int]:
        if self._ignore_merges and word in self._vocab:
            return [self._vocab[word]]
        symbols: List[Optional[str]] = []  # None: an unknown character
        unk = 0  # unknown characters pending, fused or not
        for c in word:
            if c in self._vocab:
                symbols.extend([None] * unk)
                unk = 0
                symbols.append(c)
                continue
            fallback = self._bytes(c)
            if fallback is not None:
                symbols.extend(fallback)
            elif self._fuse_unk and unk:
                continue
            else:
                symbols.extend([None] * unk)
                unk = 1
        symbols.extend([None] * unk)
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
        return [self._vocab[s] if s is not None else self._vocab[self._unk]
                for s in symbols]

    def _viterbi(self, word: str) -> List[int]:
        """A Unigram word's ids: the best path, its unknown runs fused."""
        pieces, unk_id = self._unigram, self._unk_id
        n = len(word)
        # best[e]: (score, start, id) of the best path ending at e
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)
        for start in range(n):
            here = best[start][0] if start else 0.0
            single = False
            for end in range(start + 1, min(n, start + self._max_piece) + 1):
                pid = self._vocab.get(word[start:end])
                if pid is None:
                    continue
                score = pieces[pid][1] + here
                if best[end] is None or score > best[end][0]:
                    best[end] = (score, start, pid)
                single = single or end == start + 1
            if not single:
                if unk_id is None:
                    raise ValueError(f"{self.model_path}: unknown character "
                                     f"in {word!r} and no unk id")
                score = self._unk_score + here
                if best[start + 1] is None or score > best[start + 1][0]:
                    best[start + 1] = (score, start, unk_id)
        strings, run, end = [], [], n
        while end > 0:
            _, start, pid = best[end]
            if pid == unk_id:
                run.append(word[start:end])
            else:
                if run:
                    strings.append("".join(reversed(run)))
                    run = []
                strings.append(word[start:end])
            end = start
        if run:
            strings.append("".join(reversed(run)))
        ids: List[int] = []
        for text in reversed(strings):
            pid = self._vocab.get(text)
            if pid is None:
                fallback = self._bytes(text)
                if fallback is not None:
                    ids.extend(self._vocab[p] for p in fallback)
                    continue
                pid = unk_id
            ids.append(pid)
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


def metaspace_words(text: str, replacement: str = "\u2581",
                    prepend: bool = True) -> List[str]:
    """The Metaspace pre-tokenizer with ``split``: spaces become
    ``replacement``, one is prepended to a non-empty text that does not
    start with it (``prepend_scheme`` ``always``), and the text splits
    before every ``replacement``. An empty text has no words."""
    if not text:
        return []
    text = text.replace(" ", replacement)
    if prepend and not text.startswith(replacement):
        text = replacement + text
    words, cur = [], ""
    for c in text:
        if c == replacement and cur:
            words.append(cur)
            cur = ""
        cur += c
    if cur:
        words.append(cur)
    return words


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


# -- training -----------------------------------------------------------------
def _merge_word(symbols: List[int], a: int, b: int, new: int
                ) -> List[Tuple[Tuple[int, int], int]]:
    """Merge every (a, b) of one word into ``new``, left to right, in
    place; returns the pair-count changes (pair, ±1) the merges make to
    the pairs around them (never to (a, b) itself)."""
    changes = []
    i = 0
    while i < len(symbols):
        if symbols[i] == a and i + 1 < len(symbols) and symbols[i + 1] == b:
            if i > 0:
                changes += [((symbols[i - 1], a), -1),
                            ((symbols[i - 1], new), 1)]
            symbols[i:i + 2] = [new]
            if i < len(symbols) - 1:
                changes += [((b, symbols[i + 1]), -1),
                            ((new, symbols[i + 1]), 1)]
        i += 1
    return changes


def train_bpe(word_counts: Dict[str, int], vocab_size: int
              ) -> Tuple[List[str], List[Tuple[str, str]]]:
    """BPE merges learned from word counts, as the HF ``tokenizers``
    ``BpeTrainer`` learns them: the special tokens get ids 0.., the
    characters of the words the next ids in code-point order; then, until
    the vocabulary holds ``vocab_size`` pieces, the pair of adjacent
    pieces with the largest count (ties to the smaller pair of ids) is
    merged in the words it was queued with. A queued count that is stale
    is re-counted and queued again; pairs a merge creates are queued with
    the words they were created in. A merge whose piece exists already
    adds no piece, and a pair merged twice keeps its later rank.

    Returns the pieces in id order and the merges in rank order."""
    ids: Dict[str, int] = {}
    pieces: List[str] = []

    def add(piece: str) -> int:
        if piece not in ids:
            ids[piece] = len(pieces)
            pieces.append(piece)
        return ids[piece]

    for token in SPECIAL_TOKENS:
        add(token)
    for c in sorted({c for word in word_counts for c in word}, key=ord):
        add(c)
    words = [[ids[c] for c in word] for word in word_counts]
    counts = list(word_counts.values())
    pair_counts: Dict[Tuple[int, int], int] = defaultdict(int)
    where: Dict[Tuple[int, int], set] = defaultdict(set)
    for i, word in enumerate(words):
        for pair in zip(word, word[1:]):
            pair_counts[pair] += counts[i]
            where[pair].add(i)
    order = itertools.count()  # equal (count, pair) entries pop first-in
    queue: list = []

    def enqueue() -> None:
        for pair, pos in where.items():
            if pair_counts[pair] > 0:
                heapq.heappush(queue, (-pair_counts[pair], pair,
                                       next(order), pos))
        where.clear()

    enqueue()
    ranks: Dict[Tuple[int, int], int] = {}
    rank = 0
    while len(ids) < vocab_size and queue:
        count, pair, _, pos = heapq.heappop(queue)
        if -count != pair_counts[pair]:
            heapq.heappush(queue, (-pair_counts[pair], pair, next(order),
                                   pos))
            continue
        if -count < 1:
            break
        new = add(pieces[pair[0]] + pieces[pair[1]])
        ranks[pair] = rank
        rank += 1
        for i in pos:
            for changed, delta in _merge_word(words[i], pair[0], pair[1],
                                              new):
                pair_counts[changed] += delta * counts[i]
                if delta > 0:
                    where[changed].add(i)
        enqueue()
    merges = [(pieces[a], pieces[b]) for (a, b), _ in
              sorted(ranks.items(), key=lambda kv: kv[1])]
    return pieces, merges


def tokenizer_json(pieces: List[str], merges: List[Tuple[str, str]]
                   ) -> dict:
    """The HF tokenizer JSON of a BPE vocabulary: the special tokens as
    added tokens, the ``▁`` Metaspace pre-tokenizer and decoder
    (``prepend_scheme`` ``always``, ``split``), and a BPE model with
    ``<unk>`` and ``fuse_unk``."""
    metaspace = {"type": "Metaspace", "replacement": "▁",
                 "prepend_scheme": "always", "split": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False,
             "special": True} for i, t in enumerate(SPECIAL_TOKENS)],
        "normalizer": None, "pre_tokenizer": metaspace,
        "post_processor": None, "decoder": dict(metaspace),
        "model": {
            "type": "BPE", "dropout": None, "unk_token": "<unk>",
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": True, "byte_fallback": False,
            "ignore_merges": False,
            "vocab": {p: i for i, p in enumerate(pieces)},
            "merges": [list(m) for m in merges]}}


def train_tokenizer(captions: Iterable[str], output_path: str,
                    vocab_size: int = 10000, lower: bool = True,
                    strip_accents: bool = True) -> SentencePieceBPETokenizer:
    """Train a BPE vocabulary of ``vocab_size`` pieces on ``captions``
    (lowercased and accent-stripped as :func:`preprocess_caption` does,
    split into words by the ``▁`` Metaspace) and write its tokenizer JSON
    to ``output_path``; returns the tokenizer reading it. The counterpart
    of ``virtex_tpu.data.tokenizers.train_tokenizer``: the same vocabulary
    and merges as its HF ``BpeTrainer``, in the same JSON layout."""
    word_counts: Counter = Counter()
    for caption in captions:
        word_counts.update(metaspace_words(
            preprocess_caption(caption, lower, strip_accents)))
    pieces, merges = train_bpe(dict(word_counts), vocab_size)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(tokenizer_json(pieces, merges), f, indent=2,
                  ensure_ascii=False)
    return SentencePieceBPETokenizer(output_path)


# -- SentencePiece export -----------------------------------------------------
# SentencePiece.type; TrainerSpec.model_type 2 is BPE; the fields written:
# TrainerSpec.model_type 3, .vocab_size 4, .byte_fallback 35, .unk_id 40;
# NormalizerSpec (ModelProto field 3) .name 1, .precompiled_charsmap 2,
# .add_dummy_prefix 3, .remove_extra_whitespaces 4, .escape_whitespaces 5.
SP_UNKNOWN, SP_CONTROL, SP_BPE = 2, 3, 2


def _put_varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1  # a negative int32 as protobuf writes it
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _put_field(number: int, wire: int, value) -> bytes:
    key = _put_varint(number << 3 | wire)
    if wire == _VARINT:
        return key + _put_varint(int(value))
    if wire == _FIXED32:
        return key + struct.pack("<f", value)
    return key + _put_varint(len(value)) + value


def export_sentencepiece_model(model_path: str, output_path: str) -> None:
    """Write the BPE vocabulary of a tokenizer JSON (as
    :func:`train_tokenizer` writes it) as a binary SentencePiece
    ``ModelProto``, as ``virtex_tpu.data.tokenizers
    .export_sentencepiece_model`` writes it: each piece in id order with
    its type (``<unk>`` UNKNOWN, the other special tokens CONTROL, the
    rest NORMAL) and score (a merged piece's negated merge rank, a
    composite piece without a merge ranked after every merge, a single
    character 0), a BPE trainer spec, and the normalizer pinned to
    identity, keep-whitespace, dummy prefix and escaped whitespace, so
    :class:`SentencePieceBPETokenizer` reads it back to the same
    encodes."""
    with open(model_path, encoding="utf-8") as f:
        model = json.load(f)["model"]
    if model.get("type") != "BPE":
        raise ValueError(f"{model_path}: not a BPE tokenizer JSON")
    vocab: Dict[str, int] = model["vocab"]
    if sorted(vocab.values()) != list(range(len(vocab))):
        raise ValueError(f"{model_path}: vocab ids are not contiguous "
                         f"0..{len(vocab) - 1}; SentencePiece identifies "
                         "pieces by position")
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in model["merges"]]
    product_rank: Dict[str, int] = {}
    for rank, (left, right) in enumerate(merges):
        product_rank.setdefault(left + right, rank)
    out = bytearray()
    unranked = 0
    for piece in sorted(vocab, key=vocab.get):
        if piece == "<unk>":
            kind, score = SP_UNKNOWN, 0.0
        elif piece in SPECIAL_TOKENS:
            kind, score = SP_CONTROL, 0.0
        elif piece in product_rank:
            kind, score = SP_NORMAL, -float(product_rank[piece])
        elif len(piece) >= 2:
            unranked += 1
            kind, score = SP_NORMAL, -float(len(merges) + unranked)
        else:
            kind, score = SP_NORMAL, 0.0
        out += _put_field(1, _BYTES, _put_field(1, _BYTES, piece.encode(
            "utf-8")) + _put_field(2, _FIXED32, score) + _put_field(
            3, _VARINT, kind))
    out += _put_field(2, _BYTES, _put_field(3, _VARINT, SP_BPE)
                      + _put_field(4, _VARINT, len(vocab))
                      + _put_field(35, _VARINT, 0)
                      + _put_field(40, _VARINT, UNK_INDEX))
    out += _put_field(3, _BYTES, _put_field(1, _BYTES, b"identity")
                      + _put_field(2, _BYTES, b"")
                      + _put_field(3, _VARINT, 1)
                      + _put_field(4, _VARINT, 0)
                      + _put_field(5, _VARINT, 1))
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "wb") as f:
        f.write(bytes(out))
