r"""
The weight bridge: flax variables of the JAX package → the port's state dict.

:func:`state_dict_from_flax` takes ``{"params", "batch_stats"}`` as nested
dicts of numpy arrays and returns a ``state_dict`` for any of the port's
pretext-task models (``virtex_tpu_torch.factories``). Its names are the
reference's torch names (torchvision ResNet keys with
``num_batches_tracked``, ``nn.TransformerDecoder`` keys with the packed
``in_proj_weight``, for bicaptioning ``backward_textual.*`` duplicates of
the shared projection, embedding and output, and ``textual.output.*`` for
the classification tasks' linear head), the same mapping as
``virtex_tpu.utils.checkpoint_convert.export_virtex_checkpoint``. So the
port loads either with ``load_state_dict(strict=True)``. The transfer
model's ``{"params": {"visual", "fc"}}`` gives ``visual.cnn.*`` and
``fc.weight``/``fc.bias`` (``virtex_tpu_torch.models.downstream``).

:func:`flax_names` reads the bridge backwards, giving a port parameter's
dotted name in the JAX package, which the optimizer's NO_DECAY regex and
LR groups match against, as the JAX package's do. :func:`flax_name_map`
applies it to a model's parameter names.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(x) -> torch.Tensor:
    """A float32 copy (the source may be a read-only view)."""
    return torch.tensor(np.asarray(x, np.float32))


def _conv(kernel) -> torch.Tensor:
    """flax HWIO → torch OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _lin(kernel) -> torch.Tensor:
    """flax (in, out) → torch Linear (out, in)."""
    return _t(np.asarray(kernel).T)


def _bn(out, dst: str, p: Tree, s: Tree) -> None:
    out[f"{dst}.weight"] = _t(p["scale"])
    out[f"{dst}.bias"] = _t(p["bias"])
    out[f"{dst}.running_mean"] = _t(s["mean"])
    out[f"{dst}.running_var"] = _t(s["var"])
    out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _ln(out, dst: str, p: Tree) -> None:
    out[f"{dst}.weight"] = _t(p["scale"])
    out[f"{dst}.bias"] = _t(p["bias"])


def _resnet(out, prefix: str, params: Tree, stats: Tree) -> None:
    out[f"{prefix}conv1.weight"] = _conv(params["conv1"]["kernel"])
    _bn(out, f"{prefix}bn1", params["bn1"], stats["bn1"])
    for key in sorted(k for k in params if k.startswith("layer")):
        stage, idx = key[len("layer"):].split("_")
        dst = f"{prefix}layer{stage}.{idx}"
        p, s = params[key], stats[key]
        for c in (1, 2, 3):
            if f"conv{c}" in p:
                out[f"{dst}.conv{c}.weight"] = _conv(p[f"conv{c}"]["kernel"])
                _bn(out, f"{dst}.bn{c}", p[f"bn{c}"], s[f"bn{c}"])
        if "downsample_conv" in p:
            out[f"{dst}.downsample.0.weight"] = _conv(
                p["downsample_conv"]["kernel"])
            _bn(out, f"{dst}.downsample.1", p["downsample_bn"],
                s["downsample_bn"])


def _attention(out, dst: str, a: Tree) -> None:
    qkv = ("query", "key", "value")
    out[f"{dst}.in_proj_weight"] = torch.cat([_lin(a[n]["kernel"])
                                              for n in qkv])
    out[f"{dst}.in_proj_bias"] = torch.cat([_t(a[n]["bias"]) for n in qkv])
    out[f"{dst}.out_proj.weight"] = _lin(a["out"]["kernel"])
    out[f"{dst}.out_proj.bias"] = _t(a["out"]["bias"])


def _transformer(out, dst: str, tree: Tree) -> None:
    for key in (k for k in tree if k.startswith("layer_")):
        i = int(key.split("_")[1])
        layer, pre = tree[key], f"{dst}.layers.{i}"
        _attention(out, f"{pre}.self_attn", layer["self_attn"])
        _attention(out, f"{pre}.multihead_attn", layer["cross_attn"])
        for src, name in (("intermediate", "linear1"), ("output", "linear2")):
            out[f"{pre}.{name}.weight"] = _lin(layer["ffn"][src]["kernel"])
            out[f"{pre}.{name}.bias"] = _t(layer["ffn"][src]["bias"])
        for n in ("norm1", "norm2", "norm3"):
            _ln(out, f"{pre}.{n}", layer[n])
    if "final_norm" in tree:
        _ln(out, f"{dst}.norm", tree["final_norm"])


def _textual_shared(out, dst: str, t: Tree) -> None:
    words = _t(t["embedding"]["words"]["embedding"])
    out[f"{dst}.visual_projection.weight"] = _lin(
        t["visual_projection"]["kernel"])
    out[f"{dst}.visual_projection.bias"] = _t(t["visual_projection"]["bias"])
    out[f"{dst}.embedding.words.weight"] = words
    out[f"{dst}.embedding.positions.weight"] = _t(
        t["embedding"]["positions"]["embedding"])
    _ln(out, f"{dst}.embedding.layer_norm", t["embedding"]["layer_norm"])
    out[f"{dst}.output.weight"] = words  # tied to the word table
    out[f"{dst}.output.bias"] = _t(t["output_bias"])


# The bridge read backwards: a port parameter name → the JAX package's
# dotted path (``virtex_tpu.optim.optimizer.param_path_names``). Rules apply
# in order; then a ``weight`` leaf is a ``scale`` under a norm and a
# ``kernel`` elsewhere.
_FLAX_NAME_RULES = [
    (r"^backward_textual\.transformer\.", "textual.backward_transformer."),
    (r"\.layers\.(\d+)\.", r".layer_\1."),        # decoder layers
    (r"\.layer(\d+)\.(\d+)\.", r".layer\1_\2."),  # ResNet blocks
    (r"\.multihead_attn\.", ".cross_attn."),
    (r"\.out_proj\.", ".out."),
    (r"\.linear1\.", ".ffn.intermediate."),
    (r"\.linear2\.", ".ffn.output."),
    (r"\.downsample\.0\.", ".downsample_conv."),
    (r"\.downsample\.1\.", ".downsample_bn."),
    (r"transformer\.norm\.", "transformer.final_norm."),
    (r"\.(words|positions)\.weight$", r".\1.embedding"),
]
# The transformer head's fp32 output bias is a parameter of its own in the
# JAX package; the linear head's is a Dense bias, ``textual.output.bias``.
_TRANSFORMER_OUTPUT_BIAS = (r"^textual\.output\.bias$", "textual.output_bias")
_NORM_SCOPE = re.compile(r"(bn\d*|norm\d*|final_norm|layer_norm)$")


def flax_names(name: str, linear_head: bool = False) -> List[str]:
    """The JAX package's dotted name(s) of the port's parameter ``name``:
    three for a packed ``in_proj_*`` (query, key, value), else one. E.g.
    ``backward_textual.transformer.layers.0.norm1.weight`` →
    ``textual.backward_transformer.layer_0.norm1.scale``. ``linear_head``:
    the model's textual head is :class:`LinearTextualHead`."""
    rules = _FLAX_NAME_RULES if linear_head else (
        _FLAX_NAME_RULES + [_TRANSFORMER_OUTPUT_BIAS])
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    scope, _, leaf = name.rpartition(".")
    if leaf.startswith("in_proj_"):
        kind = "kernel" if leaf == "in_proj_weight" else "bias"
        return [f"{scope}.{p}.{kind}" for p in ("query", "key", "value")]
    if leaf == "weight":
        leaf = "scale" if _NORM_SCOPE.search(scope) else "kernel"
    return [f"{scope}.{leaf}"]


def flax_name_map(names: Iterable[str]) -> Dict[str, List[str]]:
    """:func:`flax_names` of each of a model's parameter names. A
    transformer head ties its output weight to the word table, so
    ``named_parameters()`` names that tensor ``textual.embedding.words.weight``;
    a parameter named ``textual.output.weight`` is the linear head's."""
    names = list(names)
    linear = "textual.output.weight" in names
    return {n: flax_names(n, linear) for n in names}


def state_dict_from_flax(variables: Tree) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` (nested numpy dicts) → state dict.

    A tree with only ``visual`` or only ``textual`` gives only those keys,
    as ``export_virtex_checkpoint`` does."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    if "visual" in params:
        _resnet(out, "visual.cnn.", params["visual"]["cnn"],
                stats["visual"]["cnn"])
    if "fc" in params:  # LinearClassifierModel's classifier
        out["fc.weight"] = _lin(params["fc"]["kernel"])
        out["fc.bias"] = _t(params["fc"]["bias"])
    if "textual" not in params:
        return out
    t = params["textual"]
    if "visual_projection" not in t:  # the linear head
        out["textual.output.weight"] = _lin(t["output"]["kernel"])
        out["textual.output.bias"] = _t(t["output"]["bias"])
        return out
    _textual_shared(out, "textual", t)
    _transformer(out, "textual.transformer", t["transformer"])
    if "backward_transformer" in t:
        _textual_shared(out, "backward_textual", t)
        _transformer(out, "backward_textual.transformer",
                     t["backward_transformer"])
    return out
