r"""
Tokenizer self-check: the port's reader of a vocabulary file (a binary
SentencePiece ``.model`` or a tokenizer JSON) against a committed golden
of its encodings of a pinned caption list.

Counterpart of ``scripts/tokenizer_selfcheck.py``, with the same pinned
captions and golden format (``{"model", "captions", "encodings"}``), so a
golden that script writes is one this script reads. Two of its three
modes:

- a golden exists (``--golden``): every pinned caption's ids must equal
  it, and the golden must name this model file and hold this caption
  list; exit 0 on a match, 1 otherwise;
- no golden: write the port's encodings as a candidate next to
  ``--golden`` (``<golden>.candidate``) and exit 1, so that a check is
  never passed unchecked. ``--write-golden`` writes the golden itself
  for a tokenizer JSON only.

The JAX script's first mode (encoding with the ``sentencepiece`` runtime
and comparing) has no counterpart: the port imports neither
``sentencepiece`` nor ``protobuf``. A golden of a binary ``.model`` comes
from that script's mode 1, or from the JAX package's reader, which the
tests hold the port to.

    python -m virtex_tpu_torch.scripts.tokenizer_selfcheck \
        --model tests/fixtures/torch_sp_unigram.model \
        --golden tests/fixtures/torch_sp_unigram_golden.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from virtex_tpu_torch.data.tokenizers import SentencePieceBPETokenizer

# scripts/tokenizer_selfcheck.py's PINNED_CAPTIONS, in its order.
PINNED_CAPTIONS = [
    "a man riding a wave on top of a surfboard.",
    "Two dogs are playing catch in a grassy park",
    "A close up of a pizza with pepperoni, mushrooms and extra cheese!",
    "an old-fashioned steam locomotive travelling through the countryside",
    "Skiers race down a steep snow-covered slope at high speed.",
    "a café table with two croissants and a glaß of juice",
    "the number 42 bus stops near 5th avenue at 9:30 am",
    "A giraffe stretches its neck to reach acacia leaves — impressive!",
    "someone is skateboarding; their friend films it on a phone",
    "élèves jouant au frisbee près de l'école",
    "a zebra αβγ standing in a field",
    "    whitespace   should  not   matter   ",
]


def encode_all(tok: SentencePieceBPETokenizer) -> List[List[int]]:
    return [tok.encode(c) for c in PINNED_CAPTIONS]


def write_golden(path: str, model: str, encodings: list) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"model": os.path.basename(model),
                   "captions": PINNED_CAPTIONS,
                   "encodings": encodings}, f, indent=1)
    print(f"tokenizer_selfcheck: wrote golden {path}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Check the port's tokenizer "
                                 "against a committed golden.")
    ap.add_argument("--model", required=True,
                    help="SentencePiece .model or tokenizer JSON to check")
    ap.add_argument("--golden",
                    default=os.path.join("tests", "fixtures",
                                         "coco_10k_tokenizer_golden.json"),
                    help="committed golden encodings to compare against")
    ap.add_argument("--write-golden", action="store_true",
                    help="(re)write the golden of a tokenizer JSON")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    ours = encode_all(SentencePieceBPETokenizer(args.model))
    with open(args.model, "rb") as f:
        is_json = f.read(64).lstrip()[:1] == b"{"

    if os.path.exists(args.golden) and not args.write_golden:
        with open(args.golden) as f:
            golden = json.load(f)
        if golden.get("model") != os.path.basename(args.model):
            print(f"tokenizer_selfcheck: golden is for "
                  f"{golden.get('model')!r}, not "
                  f"{os.path.basename(args.model)!r}")
            return 1
        if (golden.get("captions") != PINNED_CAPTIONS
                or len(golden.get("encodings", [])) != len(PINNED_CAPTIONS)):
            print("tokenizer_selfcheck: golden caption list does not match "
                  "PINNED_CAPTIONS (count or content)")
            return 1
        bad = [i for i, (a, b) in enumerate(zip(ours, golden["encodings"]))
               if a != b]
        for i in bad:
            print(f"MISMATCH caption[{i}] {PINNED_CAPTIONS[i]!r}\n"
                  f"  port:   {ours[i]}\n  golden: {golden['encodings'][i]}")
        if bad:
            print(f"tokenizer_selfcheck: FAIL — {len(bad)}/"
                  f"{len(PINNED_CAPTIONS)} captions diverge from the golden")
            return 1
        print(f"tokenizer_selfcheck: PASS — matches committed golden "
              f"({len(PINNED_CAPTIONS)} captions)")
        return 0

    if args.write_golden:
        if is_json:
            write_golden(args.golden, args.model, ours)
            return 0
        print("tokenizer_selfcheck: REFUSING --write-golden for a binary "
              ".model: the golden would bless the port's own reading. "
              "Write it with the JAX package's scripts/tokenizer_selfcheck.py"
              " (its sentencepiece mode) or its reader.")
    write_golden(args.golden + ".candidate", args.model, ours)
    print(f"tokenizer_selfcheck: UNVERIFIED — no committed golden. Check "
          f"the candidate against the SentencePiece runtime or the JAX "
          f"reader, then rename it to {args.golden}.")
    return 1


if __name__ == "__main__":
    sys.exit(main())
