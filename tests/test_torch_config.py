"""The port's Config (virtex_tpu_torch.config) against virtex_tpu.config.Config:
every config file of the repository loads key for key equal, with and
without overrides; the yaml-subset reader raises on what it does not take;
a dumped config reads back equal. Exact equality throughout: both sides
parse the same text into Python scalars."""
import glob
import math
import os

import pytest

from virtex_tpu.config import Config as JaxConfig
from virtex_tpu_torch.config import (
    Config,
    ModelSpec,
    OptimSpec,
    YamlSubsetError,
    load_yaml,
    parse_scalar,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The files tests/test_configs_tree.py globs.
CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "configs", "*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "*_ablations", "*.yaml"))
    + glob.glob(os.path.join(REPO, "configs", "downstream", "*.yaml")))
IDS = [os.path.relpath(p, REPO) for p in CONFIGS]
OVERRIDES = ["OPTIM.LR", "1e-4", "DATA.ROOT", "/data/coco",
             "MODEL.TEXTUAL.DROPOUT", "0", "OPTIM.LOOKAHEAD.USE", "false",
             "OPTIM.LR_STEPS", "[10, 20]", "RANDOM_SEED", 7,
             "MODEL.DECODER.MAX_DECODING_STEPS", 20]


def test_the_glob_finds_the_config_tree():
    assert len(CONFIGS) == 20


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_loads_equal_the_jax_config(path):
    assert Config(path).to_dict() == JaxConfig(path)._C.to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_loads_equal_the_jax_config_with_overrides(path, tmp_path):
    ours = Config(path, OVERRIDES)
    assert ours.to_dict() == JaxConfig(path, OVERRIDES)._C.to_dict()
    assert ours.OPTIM.LR == 1e-4 and ours.OPTIM.LR_STEPS == [10, 20]
    # and the dump reads back equal
    ours.dump(str(tmp_path / "dump.yaml"))
    assert Config(str(tmp_path / "dump.yaml")).to_dict() == ours.to_dict()


def test_derived_decoding_steps_follow_the_caption_length():
    cfg = Config(override_list=["DATA.MAX_CAPTION_LENGTH", 12])
    assert cfg.MODEL.DECODER.MAX_DECODING_STEPS == 12
    ref = JaxConfig(override_list=["DATA.MAX_CAPTION_LENGTH", 12])
    assert cfg.to_dict() == ref._C.to_dict()


def test_specs_from_the_port_config_equal_those_from_the_jax_config():
    path = os.path.join(REPO, "configs", "task_ablations",
                        "masked_lm_R_50_L1_H2048.yaml")
    assert ModelSpec.from_config(Config(path)) == ModelSpec.from_config(
        JaxConfig(path))
    assert OptimSpec.from_config(Config(path)) == OptimSpec.from_config(
        JaxConfig(path))
    assert ModelSpec.from_config(Config(path)) == ModelSpec.task_ablation(
        "masked_lm_R_50_L1_H2048")


def test_config_is_frozen_and_schema_checked():
    cfg = Config()
    with pytest.raises(AttributeError):
        cfg.OPTIM.LR = 1.0
    with pytest.raises(KeyError, match="Non-existent"):
        Config(override_list=["OPTIM.NOPE", 1])
    with pytest.raises(TypeError, match="Type mismatch"):
        Config(override_list=["OPTIM.BATCH_SIZE", "'many'"])
    with pytest.raises(ValueError, match="even length"):
        Config(override_list=["OPTIM.LR"])


@pytest.mark.parametrize("text,value", [
    ('"quoted # not a comment"', "quoted # not a comment"),
    ("'it''s'", "it's"), ('"tab\\tand \\u00e9"', "tab\tand é"),
    ("true", True), ("False", False), ("~", None), ("null", None),
    ("-1", -1), ("500_000", 500000), ("0.0001", 0.0001), ("1.0e-05", 1e-05),
    ("[]", []), ("[1, 2]", [1, 2]), ("1e-4", YamlSubsetError),
    ("bare words", YamlSubsetError), ("&anchor 1", YamlSubsetError),
    ('"unterminated', YamlSubsetError), ('"a" trailing', YamlSubsetError),
    ("[[1]]", YamlSubsetError), ("|", YamlSubsetError)])
def test_scalars_of_the_subset(text, value):
    if value is YamlSubsetError:
        with pytest.raises(YamlSubsetError):
            parse_scalar(text)
    else:
        got = parse_scalar(text)
        assert got == value and type(got) is type(value)


def test_special_floats():
    assert math.isinf(parse_scalar(".inf")) and parse_scalar("-.inf") < 0
    assert math.isnan(parse_scalar(".nan"))


@pytest.mark.parametrize("text", [
    "KEY value\n",                          # no colon
    "A:\n  B: 1\n   C: 2\n",                # bad indentation
    "A: 1\nA: 2\n",                         # duplicate key
    "A: 1\n  B: 2\n",                       # value and a block
    "A:\n\t- x\n",                          # tab indentation
    "A:\n  - B: 1\n",                       # mapping in a list
    "A:\n  - [1]\n",                        # flow list in a list item
    "---\nA: 1\n",                          # document marker
    "  A: 1\n",                             # indented first key
    "- 1\n- 2\n",                           # top level is a list
    "A: {b: 1}\n",                          # flow mapping
    "A: *ref\n",                            # alias
    "A: !!str 1\n",                         # tag
])
def test_malformed_yaml_raises(tmp_path, text):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(YamlSubsetError):
        load_yaml(str(path))


def test_base_inheritance_and_unknown_keys(tmp_path):
    (tmp_path / "base.yaml").write_text("OPTIM:\n  LR: 0.5  # comment\n")
    (tmp_path / "child.yaml").write_text(
        '_BASE_: "base.yaml"\n\nOPTIM:\n  LR_STEPS:\n  - 3\n  - 4\n')
    cfg = Config(str(tmp_path / "child.yaml"))
    assert cfg.OPTIM.LR == 0.5 and cfg.OPTIM.LR_STEPS == [3, 4]
    (tmp_path / "typo.yaml").write_text("OPTIM:\n  LRR: 0.5\n")
    with pytest.raises(KeyError, match="OPTIM.LRR"):
        Config(str(tmp_path / "typo.yaml"))
