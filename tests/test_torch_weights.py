"""The weight bridge (virtex_tpu_torch.utils.weights) and the port's import
boundary.

``state_dict_from_flax`` must give the names and values that the JAX
package's ``export_virtex_checkpoint`` gives (the reference's torch names),
so the port loads either strictly. The port must import neither JAX nor
the JAX package: the machine it runs on has neither.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import caption_batch, jax_variables, tiny_config
from virtex_tpu.factories import PretrainingModelFactory
from virtex_tpu.utils.checkpoint_convert import export_virtex_checkpoint
from virtex_tpu_torch.config import ModelSpec
from virtex_tpu_torch.factories import PretrainingModelFactory as PortFactory
from virtex_tpu_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    jm = PretrainingModelFactory.from_config(cfg)
    batch = caption_batch(2, 64, cfg.DATA.MAX_CAPTION_LENGTH,
                          cfg.DATA.VOCAB_SIZE, seed=1)
    variables = jax_variables(jm, batch, seed=1, output_bias_std=1.0)
    return ModelSpec.from_config(cfg), variables


def test_state_dict_equals_the_reference_export(tiny):
    _, variables = tiny
    ours = state_dict_from_flax(variables)
    export = export_virtex_checkpoint(variables)
    assert sorted(ours) == sorted(export)
    for name, value in export.items():
        value = np.asarray(value)
        assert ours[name].numpy().dtype == value.dtype, name
        assert np.array_equal(ours[name].numpy(), value), name
    # the reference's torch names, spot-checked
    for name in ("visual.cnn.layer1.0.bn1.running_var",
                 "visual.cnn.layer1.0.bn1.num_batches_tracked",
                 "textual.transformer.layers.0.self_attn.in_proj_weight",
                 "backward_textual.embedding.words.weight",
                 "backward_textual.output.bias"):
        assert name in ours


def test_port_loads_both_strictly(tiny):
    spec, variables = tiny
    model = PortFactory.from_spec(spec, device="cpu")
    assert sorted(model.state_dict()) == sorted(state_dict_from_flax(
        variables))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    export = {k: torch.from_numpy(np.array(v))
              for k, v in export_virtex_checkpoint(variables).items()}
    fresh = PortFactory.from_spec(spec, device="cpu")
    fresh.load_state_dict(export, strict=True)
    for name, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    # the tied output weight is the word table, and the backward head
    # shares it
    assert fresh.textual.output.weight is fresh.textual.embedding.words.weight
    assert (fresh.backward_textual.output.weight
            is fresh.textual.embedding.words.weight)


def test_from_spec_builds_on_the_card_unless_asked(tiny):
    """The factory is an entry point: its default device is the card, and
    without one it raises instead of building on the CPU."""
    spec, _ = tiny
    if torch.cuda.is_available():
        model = PortFactory.from_spec(spec)
        assert next(model.parameters()).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PortFactory.from_spec(spec)
    model = PortFactory.from_spec(spec, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {b.device.type for b in model.buffers()} == {"cpu"}


def test_partial_trees_give_partial_state_dicts(tiny):
    _, variables = tiny
    p, s = variables["params"], variables["batch_stats"]
    visual = state_dict_from_flax({"params": {"visual": p["visual"]},
                                   "batch_stats": {"visual": s["visual"]}})
    textual = state_dict_from_flax({"params": {"textual": p["textual"]}})
    assert visual and all(k.startswith("visual.") for k in visual)
    assert textual and not any(k.startswith("visual.") for k in textual)
    assert sorted({**visual, **textual}) == sorted(state_dict_from_flax(
        variables))


SLICE_MODULES = [
    "virtex_tpu_torch",
    "virtex_tpu_torch.config",
    "virtex_tpu_torch.ops._build",
    "virtex_tpu_torch.ops.attention",
    "virtex_tpu_torch.ops.batchnorm",
    "virtex_tpu_torch.modules.normalization",
    "virtex_tpu_torch.modules.resnet",
    "virtex_tpu_torch.modules.visual_backbones",
    "virtex_tpu_torch.modules.embedding",
    "virtex_tpu_torch.modules.transformer",
    "virtex_tpu_torch.modules.textual_heads",
    "virtex_tpu_torch.models.captioning",
    "virtex_tpu_torch.models.classification",
    "virtex_tpu_torch.models.masked_lm",
    "virtex_tpu_torch.factories",
    "virtex_tpu_torch.utils.beam_search",
    "virtex_tpu_torch.utils.nucleus_sampling",
    "virtex_tpu_torch.utils.weights",
    "virtex_tpu_torch.engine.captioner",
    "virtex_tpu_torch.engine.evaluation",
    "virtex_tpu_torch.engine.trainer",
    "virtex_tpu_torch.optim.lr_schedules",
    "virtex_tpu_torch.optim.optimizer",
    "virtex_tpu_torch.utils.common",
    "virtex_tpu_torch.utils.timer",
    "virtex_tpu_torch.native",
    "virtex_tpu_torch.data",
    "virtex_tpu_torch.data.tokenizers",
    "virtex_tpu_torch.data.readers",
    "virtex_tpu_torch.data.transforms",
    "virtex_tpu_torch.data.native_pipeline",
    "virtex_tpu_torch.data.loader",
    "virtex_tpu_torch.data.datasets",
    "virtex_tpu_torch.data.datasets._common",
    "virtex_tpu_torch.data.datasets.captioning",
    "virtex_tpu_torch.data.datasets.masked_lm",
    "virtex_tpu_torch.data.datasets.classification",
    "virtex_tpu_torch.engine.train_state",
    "virtex_tpu_torch.engine.checkpointing",
    "virtex_tpu_torch.scripts",
    "virtex_tpu_torch.scripts.pretrain_virtex",
    "virtex_tpu_torch.scripts.eval_captioning",
    "virtex_tpu_torch.scripts.clf_linear",
    "virtex_tpu_torch.utils.metrics",
    "virtex_tpu_torch.models.downstream",
    "virtex_tpu_torch.data.datasets.downstream",
    "virtex_tpu_torch.scripts.clf_voc07",
    "virtex_tpu_torch.utils.remat",
    "virtex_tpu_torch.utils.svm",
    "virtex_tpu_torch.utils.distributed",
    "virtex_tpu_torch.ops._mesh",
    "virtex_tpu_torch.parallel",
    "virtex_tpu_torch.parallel.mesh",
    "virtex_tpu_torch.model_zoo",
    "virtex_tpu_torch.model_zoo.model_zoo",
    "virtex_tpu_torch.hubconf",
    "virtex_tpu_torch.scripts.eval_detectron2",
    "virtex_tpu_torch.scripts.build_vocabulary",
    "virtex_tpu_torch.scripts.tokenizer_selfcheck",
    "virtex_tpu_torch.scripts.feature_bitcheck",
    "virtex_tpu_torch.scripts.reproduce_parity",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "cv2",
             "tokenizers", "PIL", "virtex_tpu", "transformers",
             "google.protobuf", "sentencepiece", "sklearn")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules for f in {FORBIDDEN!r} "
        "if m == f or m.startswith(f + '.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_slice_modules_name_every_module_of_the_port():
    pkg = os.path.join(REPO, "virtex_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                found.add(mod[:-len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    missing = {m for m in found - set(SLICE_MODULES)
               if not m.endswith(("models", "modules", "ops", "optim",
                                  "engine", "utils"))}
    assert not missing, sorted(missing)


def test_checkpoints_load_only_through_the_weights_only_unpickler():
    """Every torch.load in the port passes weights_only=True, and nothing
    passes weights_only=False."""
    import re
    calls = 0
    for dirpath, _, files in os.walk(os.path.join(REPO, "virtex_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, f)).read()
            assert "weights_only=False" not in text, f
            for m in re.finditer(r"torch\.load\(([^)]*)\)", text):
                calls += 1
                assert "weights_only=True" in m.group(1), (f, m.group(0))
    assert calls >= 1
