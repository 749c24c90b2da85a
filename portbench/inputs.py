r"""
What a run makes from its seed, on its device: the weights, the train
batches, the images to caption. Every draw comes from a
``torch.Generator`` seeded by :func:`derive` from the run's seed, a
stream name and an index, so the program and the reference get the same
tensors, and a second run of one seed the same again.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

STREAMS = {"weights": 1, "batch": 2, "dropout": 3, "calibration": 4,
           "sample": 5, "images": 6}


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit generator seed from the run's seed (any size), a stream
    and an index."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             STREAMS[stream], int(index)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, stream, index))
    return gen


# -- weights ------------------------------------------------------------------
_BN = re.compile(r"\.(bn\d|downsample\.1)\.(weight|bias)$")
_ZERO_INIT_BN = re.compile(r"\.bn3\.weight$")


def init_rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a parameter's draw: its initialisation's where that
    is random (convolutions He-normal by fan-out, dense layers and
    embeddings N(0, 0.02)); std 0.1 around the constant where it is
    constant (BatchNorm and LayerNorm scales at 1, the residual branches'
    last BatchNorm scale at 0, biases at 0)."""
    if len(shape) == 4:
        return 0.0, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if len(shape) == 2:
        return 0.0, 0.02
    if name.endswith("weight") and (_BN.search(name) or "norm" in name):
        return (0.0 if _ZERO_INIT_BN.search(name) else 1.0), 0.1
    return 0.0, 0.1


def draw_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every parameter in ``shapes`` (name, shape), fp32, from one draw of
    N(0, 1) on ``device`` scaled per tensor by :func:`init_rule`."""
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    z = torch.randn(total, generator=generator(seed, "weights", 0, device),
                    device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        mean, std = init_rule(name, shape)
        out[name] = (z[at:at + n].view(shape) * std + mean)
        at += n
    return out


# -- train batches ------------------------------------------------------------
def caption_lengths(counts: Dict[str, int]) -> List[int]:
    """The traffic's multiset of caption lengths, in ascending order."""
    return sorted(int(n) for n, c in counts.items() for _ in range(int(c)))


def train_batch(seed: int, index: int, lengths: List[int], image_size: int,
                max_length: int, vocab: int, device,
                sos: int = 1, eos: int = 2, first_word: int = 4
                ) -> Dict[str, torch.Tensor]:
    """One batch of len(``lengths``) rows: NHWC fp32 images ~ N(0, 1);
    captions [SOS] words [EOS] of the given lengths (words uniform over
    ids ≥ ``first_word``), in an order drawn from the seed, padded with 0;
    the reversed captions; the lengths. int32 ids, as the data plane's
    batches hold them."""
    gen = generator(seed, "batch", index, device)
    B, T = len(lengths), max_length
    image = torch.randn((B, image_size, image_size, 3), generator=gen,
                        device=device)
    order = torch.randperm(B, generator=gen, device=device)
    L = torch.tensor(lengths, dtype=torch.int64, device=device)[order]
    words = torch.randint(first_word, vocab, (B, T), generator=gen,
                          device=device)
    pos = torch.arange(T, device=device)[None, :]
    tokens = torch.where(pos < L[:, None], words, 0)
    tokens[:, 0] = sos
    tokens.scatter_(1, (L - 1)[:, None], eos)
    src = (L[:, None] - 1 - pos).clamp_min(0)
    noitpac = torch.where(pos < L[:, None], tokens.gather(1, src), 0)
    return {"image": image, "caption_tokens": tokens.int(),
            "noitpac_tokens": noitpac.int(), "caption_lengths": L.int()}


def images(seed: int, index: int, batch: int, image_size: int, device,
           stream: str = "images") -> torch.Tensor:
    """(batch, S, S, 3) NHWC fp32 images ~ N(0, 1)."""
    gen = generator(seed, stream, index, device)
    return torch.randn((batch, image_size, image_size, 3), generator=gen,
                       device=device)
