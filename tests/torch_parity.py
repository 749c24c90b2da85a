"""Shared pieces of the tests that hold the PyTorch port (virtex_tpu_torch)
against the JAX package on the CPU.

Inputs and weights come from numpy seeds. The JAX model is initialised by
flax, its variables are then redrawn from a numpy seed where flax's init
would make a test blind (BatchNorm statistics at 0/1, zero-init residual
scales, a zero output bias), and the port receives them only through
``virtex_tpu_torch.utils.weights.state_dict_from_flax``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from virtex_tpu.config import Config
from virtex_tpu_torch.config import ModelSpec
from virtex_tpu_torch.factories import PretrainingModelFactory
from virtex_tpu_torch.utils.weights import state_dict_from_flax


def rel_err(a, ref, atol: float) -> float:
    """max |a − ref| / (|ref| + atol), in float64."""
    a, ref = (x.detach().double().cpu().numpy() if torch.is_tensor(x)
              else np.asarray(x, np.float64) for x in (a, ref))
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + atol)))


def tiny_config(dtype: str = "float32", model_name: str = "") -> Config:
    """``__graft_entry__._flagship_config(tiny=True)`` with ``DTYPE``
    replaced: the flagship's model name and grammar at a few layers and
    narrow widths (resnet18, L1_H128_A4_F256, captions of 8 tokens).
    ``model_name`` replaces ``MODEL.NAME``; a classification name takes the
    linear head (``TEXTUAL.NAME: "none"``)."""
    from __graft_entry__ import _flagship_config
    c = _flagship_config(tiny=True)
    name = model_name or c.MODEL.NAME
    textual = ("none" if name.endswith("classification")
               else c.MODEL.TEXTUAL.NAME)
    return Config(override_list=[
        "MODEL.NAME", name,
        "MODEL.VISUAL.NAME", c.MODEL.VISUAL.NAME,
        "MODEL.VISUAL.FEATURE_SIZE", c.MODEL.VISUAL.FEATURE_SIZE,
        "MODEL.TEXTUAL.NAME", textual,
        "DATA.MAX_CAPTION_LENGTH", c.DATA.MAX_CAPTION_LENGTH,
        "DTYPE", dtype,
    ])


def caption_batch(batch_size: int, image_size: int, max_len: int,
                  vocab: int, seed: int, min_len: int = 3) -> dict:
    """Numpy batch shaped as the data pipeline makes it: [SOS] words [EOS]
    of varied lengths, padded with 0; ``noitpac_tokens`` reverses the
    valid part and pads the same way."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(min_len, max_len + 1, batch_size).astype(np.int32)
    lengths[0] = max_len
    tokens = np.zeros((batch_size, max_len), np.int32)
    noitpac = np.zeros_like(tokens)
    for i, n in enumerate(lengths):
        row = np.concatenate([[1], rng.randint(4, vocab, n - 2), [2]])
        tokens[i, :n] = row
        noitpac[i, :n] = row[::-1]
    return {
        "image": rng.rand(batch_size, image_size, image_size, 3).astype(
            np.float32),
        "caption_tokens": tokens,
        "noitpac_tokens": noitpac,
        "caption_lengths": lengths,
    }


def redraw(tree, rng, path=()):
    """Redraw the leaves that flax initialises to constants."""
    out = {}
    for key, leaf in tree.items():
        p = path + (key,)
        if isinstance(leaf, dict):
            out[key] = redraw(leaf, rng, p)
            continue
        leaf = np.asarray(leaf, np.float32)
        if key == "mean":          # BN running mean
            leaf = 0.1 * rng.randn(*leaf.shape)
        elif key == "var":         # BN running variance
            leaf = rng.uniform(0.5, 1.5, leaf.shape)
        elif key == "scale":       # BN and LayerNorm scales
            leaf = 1.0 + 0.2 * rng.randn(*leaf.shape)
        elif key == "bias" and any("bn" in q or "norm" in q for q in p):
            leaf = 0.1 * rng.randn(*leaf.shape)
        out[key] = np.asarray(leaf, np.float32)
    return out


def jax_variables(model, batch: dict, seed: int,
                  output_bias_std: float = 0.0) -> dict:
    """Flax init, then the redraw above; ``output_bias_std`` > 0 draws the
    output bias (the transformer head's ``output_bias`` or the linear
    head's ``output.bias``) from N(0, std²)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda key, b: model.init(key, b, train=False))
    variables = init(jax.random.PRNGKey(seed), jb)
    variables = jax.tree.map(np.asarray, {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"]})
    rng = np.random.RandomState(seed)
    variables = redraw(variables, rng)
    if output_bias_std:
        _draw_output_bias(variables, rng, output_bias_std)
    return variables


def drawn_variables(model, batch: dict, seed: int,
                    output_bias_std: float = 0.0) -> dict:
    """Variables of ``model`` drawn from a numpy seed, with no flax init to
    compile: shapes from ``jax.eval_shape`` of the init; conv kernels
    N(0, 2/fan_in), dense kernels and embedding tables N(0, 0.02²), biases
    zero; then the redraw and the output bias as in :func:`jax_variables`."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(seed), b, train=False), jb)
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = fill(leaf)
                continue
            shape = leaf.shape
            if key == "kernel" and len(shape) == 4:   # HWIO convolution
                std = float(np.sqrt(2.0 / np.prod(shape[:3])))
            elif key in ("kernel", "embedding"):
                std = 0.02
            else:
                std = 0.0
            out[key] = (std * rng.randn(*shape)).astype(np.float32)
        return out

    variables = redraw(fill({"params": shapes["params"],
                             "batch_stats": shapes["batch_stats"]}), rng)
    if output_bias_std:
        _draw_output_bias(variables, rng, output_bias_std)
    return variables


def _draw_output_bias(variables: dict, rng, std: float) -> None:
    """The transformer head's ``output_bias`` or the linear head's
    ``output.bias`` from N(0, std²), in place."""
    textual = variables["params"]["textual"]
    owner, key = ((textual, "output_bias") if "output_bias" in textual
                  else (textual["output"], "bias"))
    owner[key] = (std * rng.randn(*owner[key].shape)).astype(np.float32)


def port_model(spec: ModelSpec, variables: dict) -> torch.nn.Module:
    """The port's model for ``spec.model_name``, loaded strictly from the
    JAX variables."""
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}
