r"""
Build the BPE caption vocabulary from a COCO captions json, in the
PyTorch port.

Counterpart of ``scripts/build_vocabulary.py``, with the same flags:
captions lowercased (``-l``, on by default) and NFKD accent-stripped
(unless ``-a``), a vocabulary of ``-s`` pieces (``<unk>`` 0, which doubles
as padding, ``[SOS]`` 1, ``[EOS]`` 2, ``[MASK]`` 3) trained by
``train_tokenizer`` (the JAX package's HF BPE trainer's vocabulary and
merges, not SentencePiece's), written as the tokenizer JSON
``<prefix>.model`` and as a binary SentencePiece model
``<prefix>.sp.model``. Runs on the host; it needs no card.

    python -m virtex_tpu_torch.scripts.build_vocabulary \
        -c datasets/coco/annotations/captions_train2017.json \
        -s 10000 -o datasets/vocab/coco_10k
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from virtex_tpu_torch.data.tokenizers import (
    export_sentencepiece_model,
    preprocess_caption,
    train_tokenizer,
)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Build a BPE caption vocabulary (PyTorch port).")
    parser.add_argument(
        "-c", "--captions",
        default="datasets/coco/annotations/captions_train2017.json")
    parser.add_argument("-s", "--vocab-size", type=int, default=10000)
    parser.add_argument("-o", "--output-prefix",
                        default="datasets/vocab/coco_10k")
    parser.add_argument("-l", "--do-lower-case", action="store_true",
                        default=True)
    parser.add_argument("-a", "--keep-accents", action="store_true")
    return parser


def main(_A) -> Dict[str, str]:
    """Train and write both files; returns their paths."""
    with open(_A.captions, encoding="utf-8") as f:
        captions = [preprocess_caption(ann["caption"], _A.do_lower_case,
                                       not _A.keep_accents)
                    for ann in json.load(f)["annotations"]]
    os.makedirs(os.path.dirname(os.path.abspath(_A.output_prefix)),
                exist_ok=True)
    out, sp_out = _A.output_prefix + ".model", _A.output_prefix + ".sp.model"
    train_tokenizer(captions, out, vocab_size=_A.vocab_size)
    export_sentencepiece_model(out, sp_out)
    print(f"Trained a {_A.vocab_size}-piece vocabulary on {len(captions)} "
          f"captions: {out} (+ SentencePiece model {sp_out})")
    return {"model": out, "sp_model": sp_out}


if __name__ == "__main__":
    main(build_parser().parse_args())
