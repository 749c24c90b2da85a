r"""
The package's configuration, and the model and optimizer descriptions
built from it.

:class:`Config` is the counterpart of :class:`virtex_tpu.config.Config`:
the same default schema (its own copy), a yaml file with ``_BASE_``
inheritance on top, then a flat list of dotted-key overrides typed as the
defaults are, then the derived ``MODEL.DECODER.MAX_DECODING_STEPS``. It
reads the files with :func:`load_yaml`, a reader of the yaml subset that
``configs/`` uses (nested mappings, lists of scalars, quoted and bare
scalars, comments), which raises on anything outside that subset; pyyaml
is not needed.

:class:`ModelSpec` and :class:`OptimSpec` hold the keys that building,
running and training the pretext-task models read.
:meth:`ModelSpec.flagship` builds the flagship
``bicaptioning_R_50_L1_H1024`` in code, :meth:`ModelSpec.task_ablation`
and :meth:`OptimSpec.task_ablation` build the five
``configs/task_ablations/*.yaml``, and the ``from_config`` methods copy the
keys out of a :class:`Config` (or, duck-typed, a
``virtex_tpu.config.Config``).
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# The yaml subset of configs/.

_BASE_KEY = "_BASE_"
# PyYAML's (YAML 1.1) resolvers for the bare scalars the subset takes.
_INT_RE = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT_RE = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?|[-+]?\.(inf|Inf|INF)"
    r"|\.(nan|NaN|NAN)")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
_NULLS = ("null", "Null", "NULL", "~", "")
_KEY_RE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(\s|$)")
_DQ_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
               "r": "\r", "0": "\0", "b": "\b"}


class YamlSubsetError(ValueError):
    """A config file uses yaml outside the subset :func:`load_yaml` reads."""


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``# comment`` (a ``#`` at the start or
    after whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == '"' and c == "\\":
            i += 2
            continue
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _quoted(text: str, where: str) -> str:
    """The string of a whole single- or double-quoted scalar."""
    q = text[0]
    if q == "'":
        if len(text) < 2 or not text.endswith("'"):
            raise YamlSubsetError(f"{where}: unterminated string {text!r}")
        body = text[1:-1]
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YamlSubsetError(f"{where}: text after a string: {text!r}")
        return body.replace("''", "'")
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if c == "\\":
            if i + 1 >= len(text):
                break
            e = text[i + 1]
            if e in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[e])
                i += 2
            elif e == "u" and re.fullmatch(r"[0-9a-fA-F]{4}",
                                           text[i + 2:i + 6]):
                out.append(chr(int(text[i + 2:i + 6], 16)))
                i += 6
            else:
                raise YamlSubsetError(f"{where}: escape \\{e} in {text!r}")
            continue
        if c == '"':
            if i != len(text) - 1:
                raise YamlSubsetError(f"{where}: text after a string: "
                                      f"{text!r}")
            return "".join(out)
        out.append(c)
        i += 1
    raise YamlSubsetError(f"{where}: unterminated string {text!r}")


def parse_scalar(text: str, where: str = "value") -> Any:
    """One scalar of the subset: a quoted string, ``true``/``false``,
    ``null``/``~``, an int, a float (with a dot, as YAML 1.1 resolves it),
    or an empty flow list ``[]`` / list of scalars ``[a, b]``. Bare words
    raise: quote strings."""
    text = text.strip()
    if text[:1] in "\"'":
        return _quoted(text, where)
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _NULLS:
        return None
    if _INT_RE.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.fullmatch(text):
        low = text.lower()
        if low.endswith("inf"):
            return -math.inf if low.startswith("-") else math.inf
        if low.endswith("nan"):
            return math.nan
        return float(text.replace("_", ""))
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        if not inner:
            return []
        if any(c in inner for c in "[]{}"):
            raise YamlSubsetError(f"{where}: nested flow collection {text!r}")
        return [parse_scalar(p, where) for p in inner.split(",")]
    if text == "{}":
        return {}
    raise YamlSubsetError(
        f"{where}: {text!r} is outside the yaml subset this reader takes "
        "(quote strings; no anchors, tags, block scalars or flow mappings)")


def _parse_lines(lines: List[Tuple[int, int, str]], where: str) -> Any:
    """Lines ``(number, indent, text)`` of one block → a dict or a list."""
    if lines[0][2].startswith("- ") or lines[0][2] == "-":
        return _parse_list(lines, where)
    out: Dict[str, Any] = {}
    indent = lines[0][1]
    i = 0
    while i < len(lines):
        num, ind, text = lines[i]
        loc = f"{where}:{num}"
        if ind != indent:
            raise YamlSubsetError(f"{loc}: bad indentation")
        m = _KEY_RE.match(text)
        if not m:
            raise YamlSubsetError(f"{loc}: expected 'KEY: value', got "
                                  f"{text!r}")
        key, rest = m.group(1), text[m.end():].strip()
        if key in out:
            raise YamlSubsetError(f"{loc}: duplicate key {key!r}")
        # The block under this key: deeper lines, or a list at this indent.
        j = i + 1
        while j < len(lines) and (lines[j][1] > indent or (
                lines[j][1] == indent and lines[j][2].startswith("-"))):
            j += 1
        block = lines[i + 1:j]
        if rest:
            if block:
                raise YamlSubsetError(f"{loc}: {key!r} has a value and a "
                                      "block")
            out[key] = parse_scalar(rest, loc)
        elif block:
            out[key] = _parse_lines(block, where)
        else:
            out[key] = None
        i = j
    return out


def _parse_list(lines, where: str) -> list:
    indent = lines[0][1]
    out = []
    for num, ind, text in lines:
        loc = f"{where}:{num}"
        if ind != indent or not (text.startswith("- ") or text == "-"):
            raise YamlSubsetError(f"{loc}: a list holds only '- scalar' "
                                  "items at one indentation")
        item = text[1:].strip()
        if _KEY_RE.match(item) or item[:1] in ("-", "[", "{"):
            raise YamlSubsetError(f"{loc}: nested collections in a list")
        out.append(parse_scalar(item, loc))
    return out


def load_yaml(path: str) -> Dict[str, Any]:
    """A config file of the subset → nested dicts (``{}`` when empty)."""
    with open(path, encoding="utf-8") as f:
        raw = f.read()
    lines = []
    for num, line in enumerate(raw.splitlines(), 1):
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise YamlSubsetError(f"{path}:{num}: tab in indentation")
        text = _strip_comment(line)
        if not text.strip():
            continue
        if text.strip() in ("---", "...") or text.lstrip()[:1] in "&*!|>%{":
            raise YamlSubsetError(f"{path}:{num}: {text.strip()!r} is "
                                  "outside the yaml subset")
        lines.append((num, len(text) - len(text.lstrip()), text.strip()))
    if not lines:
        return {}
    if lines[0][1] != 0:
        raise YamlSubsetError(f"{path}:{lines[0][0]}: indented first key")
    tree = _parse_lines(lines, path)
    if not isinstance(tree, dict):
        raise YamlSubsetError(f"{path}: the top level must be a mapping")
    return tree


def _scalar_text(v: Any) -> str:
    """A scalar as :func:`parse_scalar` reads it back."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:  # 1e-05 → 1.0e-05: YAML 1.1 floats need a dot
            mant, _, exp = text.partition("e")
            text = f"{mant}.0e{exp if exp[0] in '+-' else '+' + exp}"
        return text
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} to a config")


def dump_yaml(tree: Dict[str, Any], indent: int = 0) -> str:
    """Nested dicts of scalars and lists of scalars → text that
    :func:`load_yaml` reads back equal."""
    pad = " " * indent
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.append(f"{pad}{k}:" + ("" if v else " {}"))
            out.append(dump_yaml(v, indent + 2))
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{k}:" + ("" if v else " []"))
            out.extend(f"{pad}  - {_scalar_text(x)}" for x in v)
        else:
            out.append(f"{pad}{k}: {_scalar_text(v)}")
    return "\n".join(line for line in out if line)


# ---------------------------------------------------------------------------
# The config tree.


class CfgNode(dict):
    """A dict whose keys are also attributes, with schema-checked merges
    and freezing (``virtex_tpu.config.CfgNode``)."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in (init_dict or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is immutable; cannot set {name!r}")
        super().__setitem__(name, value)

    def freeze(self) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def merge_from_other(self, other: Dict[str, Any], _path: str = "") -> None:
        """Merge ``other`` in; every key must exist here, and values take
        the default's type."""
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            old = self[k]
            if isinstance(old, CfgNode) and isinstance(v, dict):
                old.merge_from_other(v, full)
            else:
                self[k] = _check_value_type(old, v, full)

    def merge_from_list(self, override_list: List[Any]) -> None:
        if len(override_list) % 2 != 0:
            raise ValueError("Override list must have even length (key value "
                             f"pairs); got {override_list}")
        for key, value in zip(override_list[0::2], override_list[1::2]):
            node, parts = self, str(key).split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            node[parts[-1]] = _check_value_type(node[parts[-1]], value,
                                                str(key))

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v))
                for k, v in self.items()}

    def dump(self) -> str:
        return dump_yaml(self.to_dict()) + "\n"

    def __str__(self) -> str:
        return self.dump()


def _decode_value(value: str) -> Any:
    """A command-line override's text → a value: a Python literal first
    (so ``1e-4`` is a float), then a scalar of the yaml subset (``true``,
    ``null``), else the text itself, as ``virtex_tpu.config`` decodes it."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    try:
        return parse_scalar(value)
    except YamlSubsetError:
        return value


def _check_value_type(old: Any, new: Any, key: str) -> Any:
    if old is None or new is None:
        return new
    if isinstance(new, dict) and isinstance(old, CfgNode):
        merged = copy.deepcopy(old)
        object.__setattr__(merged, CfgNode.IMMUTABLE, False)
        merged.merge_from_other(new, key)
        return merged
    if isinstance(old, float) and isinstance(new, int) \
            and not isinstance(new, bool):
        return float(new)
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return list(new)
    if type(old) is not type(new):
        raise TypeError(f"Type mismatch for config key {key}: expected "
                        f"{type(old).__name__}, got {type(new).__name__} "
                        f"({new!r})")
    return new


def _load_with_base(config_file: str) -> Dict[str, Any]:
    """A file with its ``_BASE_`` chain resolved (a relative base path is
    relative to the including file)."""
    raw = load_yaml(config_file)
    if _BASE_KEY not in raw:
        return raw
    base_path = raw.pop(_BASE_KEY)
    if not isinstance(base_path, str):
        raise YamlSubsetError(f"{config_file}: _BASE_ must be a string")
    if not os.path.isabs(base_path):
        base_path = os.path.join(os.path.dirname(config_file), base_path)
    base = _load_with_base(base_path)
    _merge_free(base, raw)
    return base


def _merge_free(base: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    for k, v in overrides.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _merge_free(base[k], v)
        else:
            base[k] = v


def default_config() -> CfgNode:
    """The complete default schema, as ``virtex_tpu/config.py`` sets it.
    Keys of the JAX package's TPU layout (``PARALLEL``, ``STEM_S2D``) are
    kept so every file of ``configs/`` loads; the port refuses the options
    it does not run where it builds the model."""
    return CfgNode({
        "RANDOM_SEED": 0,
        "DTYPE": "bfloat16",
        "AMP": True,
        "CUDNN_DETERMINISTIC": False,
        "CUDNN_BENCHMARK": True,
        "PARALLEL": {"DATA": -1, "MODEL": 1},
        "DATA": {
            "ROOT": "datasets/coco",
            "TOKENIZER_MODEL": "datasets/vocab/coco_10k.model",
            "VOCAB_SIZE": 10000,
            "UNK_INDEX": 0,
            "SOS_INDEX": 1,
            "EOS_INDEX": 2,
            "MASK_INDEX": 3,
            "IMAGE_CROP_SIZE": 224,
            "MAX_CAPTION_LENGTH": 30,
            "IMAGE_TRANSFORM_TRAIN": ["random_resized_crop",
                                      "horizontal_flip", "color_jitter",
                                      "normalize"],
            "IMAGE_TRANSFORM_VAL": ["smallest_resize", "center_crop",
                                    "normalize"],
            "MASKED_LM": {"MASK_PROPORTION": 0.15,
                          "MASK_PROBABILITY": 0.85,
                          "REPLACE_PROBABILITY": 0.10},
            "PREFETCH": 2,
            "USE_NATIVE_LOADER": True,
            "DEVICE_NORMALIZE": True,
        },
        "MODEL": {
            "NAME": "virtex",
            "VISUAL": {"NAME": "torchvision::resnet50",
                       "FEATURE_SIZE": 2048, "PRETRAINED": False,
                       "FROZEN": False, "BN_STAT_STRIDE": 1,
                       "STEM_S2D": False, "REMAT": False},
            "TEXTUAL": {"NAME": "transdec_postnorm::L1_H2048_A32_F8192",
                        "DROPOUT": 0.1, "REMAT": False},
            "DECODER": {"NAME": "beam_search", "BEAM_SIZE": 5,
                        "NUCLEUS_SIZE": 0.9, "MAX_DECODING_STEPS": 30,
                        "PREFIX_MODE": "reference"},
        },
        "OPTIM": {
            "OPTIMIZER_NAME": "sgd",
            "SGD_MOMENTUM": 0.9,
            "WEIGHT_DECAY": 0.0001,
            "NO_DECAY": ".*textual.(embedding|transformer).*(norm.*|bias)",
            "CLIP_GRAD_NORM": 10.0,
            "LOOKAHEAD": {"USE": True, "ALPHA": 0.5, "STEPS": 5},
            "BATCH_SIZE": 256,
            "GRAD_ACCUM_STEPS": 1,
            "CNN_LR": 0.2,
            "LR": 0.001,
            "NUM_ITERATIONS": 500000,
            "WARMUP_STEPS": 10000,
            "LR_DECAY_NAME": "cosine",
            "LR_STEPS": [],
            "LR_GAMMA": 0.1,
        },
    })


class Config:
    r"""The frozen configuration: the defaults, overridden by a config file
    (with ``_BASE_`` inheritance) and then by a flat list of alternating
    dotted keys and values. ``MODEL.DECODER.MAX_DECODING_STEPS`` follows
    ``DATA.MAX_CAPTION_LENGTH`` unless the file or the list sets it.

        >>> _C = Config("config.yaml", ["OPTIM.BATCH_SIZE", 1024])
        >>> _C.OPTIM.BATCH_SIZE
        1024
    """

    def __init__(self, config_file: Optional[str] = None,
                 override_list: Optional[List[Any]] = None):
        _C = default_config()
        loaded = _load_with_base(config_file) if config_file else {}
        _C.merge_from_other(loaded)
        _C.merge_from_list(list(override_list or []))
        set_in_list = "MODEL.DECODER.MAX_DECODING_STEPS" in [
            str(k) for k in list(override_list or [])[0::2]]
        set_in_file = "MAX_DECODING_STEPS" in loaded.get("MODEL", {}).get(
            "DECODER", {})
        if not (set_in_list or set_in_file):
            _C.MODEL.DECODER.MAX_DECODING_STEPS = _C.DATA.MAX_CAPTION_LENGTH
        _C.freeze()
        object.__setattr__(self, "_C", _C)

    def dump(self, file_path: str) -> None:
        with open(file_path, "w", encoding="utf-8") as f:
            f.write(self._C.dump())

    def to_dict(self) -> Dict[str, Any]:
        return self._C.to_dict()

    def __getattr__(self, attr: str) -> Any:
        return getattr(object.__getattribute__(self, "_C"), attr)

    def __setattr__(self, attr: str, value: Any) -> None:
        raise AttributeError("Config object is immutable.")

    def __str__(self) -> str:
        return str(self._C)

    def __repr__(self) -> str:
        return f"Config({self._C.to_dict()!r})"

# ``transdec_{post,pre}norm::L{l}_H{h}_A{a}_F{f}`` — the grammar of
# virtex_tpu/factories.py TextualHeadFactory.NAME_RE.
TEXTUAL_NAME_RE = re.compile(
    r"transdec_(?P<norm>post|pre)norm::"
    r"L(?P<L>\d+)_H(?P<H>\d+)_A(?P<A>\d+)_F(?P<F>\d+)")

# Model names whose textual head masks future positions, and those that
# caption in both directions (virtex_tpu/factories.py).
CAPTIONING_MODELS = ("virtex", "captioning", "bicaptioning")
BIDIRECTIONAL_MODELS = ("virtex", "bicaptioning")
MODEL_NAMES = CAPTIONING_MODELS + (
    "masked_lm", "token_classification", "multilabel_classification")
DECODER_NAMES = ("beam_search", "nucleus_sampling")

# configs/task_ablations/<stem>.yaml: the keys each file sets over
# configs/_base_bicaptioning_R_50_L1_H1024.yaml (the base's MODEL.NAME is
# "virtex"). Both classification files also set OPTIM.NO_DECAY "none".
_H2048 = "transdec_postnorm::L1_H2048_A32_F8192"
TASK_ABLATIONS = {
    "bicaptioning_R_50_L1_H2048": {"model_name": "virtex",
                                   "textual_name": _H2048},
    "captioning_R_50_L1_H2048": {"model_name": "captioning",
                                 "textual_name": _H2048},
    "masked_lm_R_50_L1_H2048": {"model_name": "masked_lm",
                                "textual_name": _H2048},
    "token_classification_R_50": {"model_name": "token_classification",
                                  "textual_name": "none"},
    "multilabel_classification_R_50": {
        "model_name": "multilabel_classification", "textual_name": "none",
        "vocab_size": 81},
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model_name: str = "virtex"
    visual_name: str = "torchvision::resnet50"
    visual_feature_size: int = 2048
    visual_frozen: bool = False
    bn_stat_stride: int = 1
    stem_s2d: bool = False
    textual_name: str = "transdec_postnorm::L1_H2048_A32_F8192"
    textual_dropout: float = 0.1
    visual_remat: bool = False
    textual_remat: bool = False
    dtype: str = "bfloat16"
    vocab_size: int = 10000
    max_caption_length: int = 30
    image_size: int = 224
    unk_index: int = 0
    sos_index: int = 1
    eos_index: int = 2
    mask_index: int = 3
    decoder_name: str = "beam_search"
    beam_size: int = 5
    nucleus_size: float = 0.9
    max_decoding_steps: int = 30
    prefix_mode: str = "reference"

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise KeyError(f"unknown MODEL.NAME {self.model_name!r}; "
                           f"known: {MODEL_NAMES}")
        if self.decoder_name not in DECODER_NAMES:
            raise KeyError(f"unknown MODEL.DECODER.NAME "
                           f"{self.decoder_name!r}; known: {DECODER_NAMES}")

    @classmethod
    def flagship(cls) -> "ModelSpec":
        """``bicaptioning_R_50_L1_H1024``: the model that
        ``__graft_entry__._flagship_config()`` builds."""
        return cls(model_name="bicaptioning",
                   textual_name="transdec_postnorm::L1_H1024_A16_F4096")

    @classmethod
    def task_ablation(cls, name: str) -> "ModelSpec":
        """``configs/task_ablations/<name>.yaml``, e.g.
        ``masked_lm_R_50_L1_H2048`` or ``token_classification_R_50``."""
        if name not in TASK_ABLATIONS:
            raise KeyError(f"unknown task ablation {name!r}; known: "
                           f"{sorted(TASK_ABLATIONS)}")
        return cls(**TASK_ABLATIONS[name])

    @classmethod
    def from_config(cls, cfg: Any) -> "ModelSpec":
        """Copy the slice's keys out of a ``virtex_tpu.config.Config``."""
        M, D = cfg.MODEL, cfg.DATA
        return cls(
            model_name=M.NAME,
            visual_name=M.VISUAL.NAME,
            visual_feature_size=int(M.VISUAL.FEATURE_SIZE),
            visual_frozen=bool(M.VISUAL.FROZEN),
            bn_stat_stride=int(M.VISUAL.BN_STAT_STRIDE),
            stem_s2d=bool(M.VISUAL.STEM_S2D),
            textual_name=M.TEXTUAL.NAME,
            textual_dropout=float(M.TEXTUAL.DROPOUT),
            visual_remat=bool(M.VISUAL.REMAT),
            textual_remat=bool(M.TEXTUAL.REMAT),
            dtype=cfg.DTYPE,
            vocab_size=int(D.VOCAB_SIZE),
            max_caption_length=int(D.MAX_CAPTION_LENGTH),
            image_size=int(D.IMAGE_CROP_SIZE),
            unk_index=int(D.UNK_INDEX),
            sos_index=int(D.SOS_INDEX),
            eos_index=int(D.EOS_INDEX),
            mask_index=int(D.MASK_INDEX),
            decoder_name=M.DECODER.NAME,
            beam_size=int(M.DECODER.BEAM_SIZE),
            nucleus_size=float(M.DECODER.NUCLEUS_SIZE),
            max_decoding_steps=int(M.DECODER.MAX_DECODING_STEPS),
            prefix_mode=M.DECODER.PREFIX_MODE,
        )

    # -- derived ------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown DTYPE {self.dtype!r}; "
                             f"supported: {sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    @property
    def visual_arch(self) -> str:
        """``torchvision::resnet50`` → ``resnet50``."""
        zoo, _, arch = self.visual_name.rpartition("::")
        if zoo not in ("", "torchvision"):
            raise KeyError(f"unknown visual backbone family {zoo!r}")
        return arch

    @property
    def linear_head(self) -> bool:
        """``TEXTUAL.NAME: "none"``: the pooled linear head of the
        classification tasks."""
        return self.textual_name == "none"

    @property
    def textual(self) -> dict:
        """The parsed textual grammar: norm, layers, hidden, heads, ffn."""
        m = TEXTUAL_NAME_RE.fullmatch(self.textual_name)
        if not m:
            raise ValueError(
                f"Cannot parse textual head name {self.textual_name!r}")
        return {"norm_type": m.group("norm"),
                "num_layers": int(m.group("L")),
                "hidden_size": int(m.group("H")),
                "attention_heads": int(m.group("A")),
                "feedforward_size": int(m.group("F"))}

    @property
    def caption_backward(self) -> bool:
        return self.model_name in BIDIRECTIONAL_MODELS


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """The ``OPTIM.*`` keys of the optimizer chain and its LR schedule
    (``virtex_tpu/config.py``), defaults included. The batch size and the
    accumulation count are the train step's to take."""
    optimizer_name: str = "sgd"
    sgd_momentum: float = 0.9
    weight_decay: float = 0.0001
    no_decay: str = ".*textual.(embedding|transformer).*(norm.*|bias)"
    clip_grad_norm: float = 10.0
    lookahead_use: bool = True
    lookahead_alpha: float = 0.5
    lookahead_steps: int = 5
    cnn_lr: float = 0.2
    lr: float = 0.001
    num_iterations: int = 500000
    warmup_steps: int = 10000
    lr_decay_name: str = "cosine"
    lr_steps: Tuple[int, ...] = ()
    lr_gamma: float = 0.1

    @classmethod
    def flagship(cls) -> "OptimSpec":
        """The flagship's optimizer: ``_flagship_config()`` keeps every
        ``OPTIM`` default."""
        return cls()

    @classmethod
    def task_ablation(cls, name: str) -> "OptimSpec":
        """The optimizer of ``configs/task_ablations/<name>.yaml``: the
        defaults, and NO_DECAY "none" (no name matches, so every parameter
        decays) for the two with the linear head."""
        linear = ModelSpec.task_ablation(name).linear_head
        return cls(no_decay="none") if linear else cls()

    @classmethod
    def from_config(cls, cfg: Any) -> "OptimSpec":
        O = cfg.OPTIM
        return cls(
            optimizer_name=O.OPTIMIZER_NAME,
            sgd_momentum=float(O.SGD_MOMENTUM),
            weight_decay=float(O.WEIGHT_DECAY),
            no_decay=O.NO_DECAY,
            clip_grad_norm=float(O.CLIP_GRAD_NORM),
            lookahead_use=bool(O.LOOKAHEAD.USE),
            lookahead_alpha=float(O.LOOKAHEAD.ALPHA),
            lookahead_steps=int(O.LOOKAHEAD.STEPS),
            cnn_lr=float(O.CNN_LR),
            lr=float(O.LR),
            num_iterations=int(O.NUM_ITERATIONS),
            warmup_steps=int(O.WARMUP_STEPS),
            lr_decay_name=O.LR_DECAY_NAME,
            lr_steps=tuple(int(s) for s in O.LR_STEPS),
            lr_gamma=float(O.LR_GAMMA),
        )
