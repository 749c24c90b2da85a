"""The port's model zoo (virtex_tpu_torch.model_zoo) against the JAX
package's (virtex_tpu.model_zoo), and the checkpoint interchange between
the packages, on the CPU.

- the same 16 entries; for each, the port model's state-dict names and
  shapes equal ``export_virtex_checkpoint`` of the JAX model's init at the
  published widths (shapes from ``jax.eval_shape``: no JAX compute);
- a ``.pth`` that the JAX package exports from seeded variables loads
  through both zoos' ``get(pretrained=True)``, narrowed (resnet18, a
  32-wide head, 64² crops, vocabulary 100, fp32), to the same visual grid
  (≤ 1e-4 of |ref| + 1) and eval-step losses (≤ 1e-5 of |ref| + 1e-3);
- a textual-only ``.pth`` keeps the visual backbone as initialised; the
  zoo directory resolves ``<name>`` and ``<name>.pth``; ``fetch`` over
  ``file://`` with its cache, checksum and fragment; an orbax directory is
  refused by name; a legacy (non-zip) ``.pth`` loads;
- the JAX package's import and export scripts round-trip a port
  checkpoint back to the port bit for bit;
- without a card, ``get()`` raises instead of building on the CPU.
"""
import argparse
import hashlib
import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch

from tests.torch_parity import (
    caption_batch,
    drawn_variables,
    init_batch,
    one_torch_thread,  # noqa: F401
    rel_err,
    torch_batch,
)
from virtex_tpu.config import Config as JaxConfig
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_eval_step as jax_eval_step
from virtex_tpu.factories import PretrainingModelFactory as JaxFactory
from virtex_tpu.model_zoo import model_zoo as jax_zoo
from virtex_tpu.utils.checkpoint_convert import export_virtex_checkpoint
from virtex_tpu_torch.engine.checkpointing import read_checkpoint
from virtex_tpu_torch.engine.evaluation import make_eval_step
from virtex_tpu_torch.model_zoo import model_zoo as zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = sorted(zoo._MODEL_ZOO_CONFIGS)
IMAGE, T, VOCAB = 64, 8, 100
NARROW = ["DATA.IMAGE_CROP_SIZE", IMAGE, "DATA.MAX_CAPTION_LENGTH", T,
          "DATA.VOCAB_SIZE", VOCAB, "MODEL.VISUAL.NAME",
          "torchvision::resnet18", "MODEL.VISUAL.FEATURE_SIZE", 512,
          "DTYPE", "float32"]
NARROW_HEAD = ["MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H32_A4_F64"]
FLAGSHIP = "width_ablations/bicaptioning_R_50_L1_H1024.yaml"


def jax_export_shapes(rel: str) -> dict:
    """{name: shape} of ``export_virtex_checkpoint`` of the JAX model's
    init, from ``jax.eval_shape`` (zero-stride arrays stand in)."""
    cfg = JaxConfig(os.path.join(jax_zoo._configs_root(), rel))
    model = JaxFactory.from_config(cfg)
    shapes = jax.eval_shape(lambda b: model.init(
        jax.random.PRNGKey(0), b, train=False), init_batch(cfg, IMAGE))
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    return {k: tuple(np.shape(v))
            for k, v in export_virtex_checkpoint(zeros).items()}


def test_the_entries_equal_the_jax_zoo():
    assert zoo._MODEL_ZOO_CONFIGS == jax_zoo._MODEL_ZOO_CONFIGS
    assert len(ENTRIES) == 16
    assert os.path.realpath(zoo._configs_root()) == os.path.realpath(
        jax_zoo._configs_root())
    for rel in ENTRIES:
        assert os.path.isfile(os.path.join(zoo._configs_root(), rel)), rel


@pytest.mark.parametrize("rel", ENTRIES)
def test_state_dict_names_and_shapes_equal_the_jax_export(rel):
    """At the published widths (built on the meta device: shapes only);
    ``num_batches_tracked`` is a torch buffer the JAX export writes too."""
    with torch.device("meta"):
        model, cfg = zoo.get(rel, device="meta")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == jax_export_shapes(rel)
    assert cfg.MODEL.VISUAL.NAME in ("torchvision::resnet50",
                                     "torchvision::resnet101",
                                     "torchvision::wide_resnet50_2")


def seeded_pth(tmp_path, rel, overrides, seed, keep=lambda name: True):
    """A ``.pth`` that the JAX package exports from variables drawn from a
    numpy seed for ``rel`` under ``overrides``; returns its path and the
    JAX model."""
    cfg = JaxConfig(os.path.join(jax_zoo._configs_root(), rel), overrides)
    model = JaxFactory.from_config(cfg)
    variables = drawn_variables(model, init_batch(cfg, IMAGE), seed,
                                output_bias_std=1.0)
    sd = {k: torch.from_numpy(np.array(v))  # 0-d stays 0-d
          for k, v in export_virtex_checkpoint(variables).items()
          if keep(k)}
    path = tmp_path / f"{seed}.pth"
    torch.save({"model": sd, "iteration": 7}, str(path))
    return str(path), sd


def task_batch(name: str, seed: int) -> dict:
    batch = caption_batch(4, IMAGE, T, VOCAB, seed)
    if name == "token_classification":
        return {"image": batch["image"], "labels": batch["caption_tokens"]}
    return batch


@pytest.mark.parametrize("rel,head", [
    ("width_ablations/bicaptioning_R_50_L1_H512.yaml", NARROW_HEAD),
    ("task_ablations/captioning_R_50_L1_H2048.yaml", NARROW_HEAD),
    ("task_ablations/token_classification_R_50.yaml", [])])
def test_a_jax_export_loads_in_both_zoos_to_equal_outputs(tmp_path, rel,
                                                          head):
    overrides = NARROW + head
    path, sd = seeded_pth(tmp_path, rel, overrides, seed=3)
    jm, jvars, jcfg = jax_zoo.get(rel, pretrained=True, checkpoint_path=path,
                                  overrides=overrides)
    model, cfg = zoo.get(rel, pretrained=True, checkpoint_path=path,
                         overrides=overrides, device="cpu")
    assert cfg.to_dict() == jcfg.to_dict()
    for name, value in model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    model.eval()
    batch = task_batch(cfg.MODEL.NAME, seed=5)
    with torch.inference_mode():
        grid = model.visual(torch.from_numpy(batch["image"]))
    ref_grid = jm.apply(jvars, batch["image"],
                        method=lambda m, x: m.visual(x, train=False))
    assert rel_err(grid, np.asarray(ref_grid), 1.0) <= 1e-4
    state = TrainState.create(jvars["params"], jvars["batch_stats"],
                              optax.sgd(0.0))
    ref = jax_eval_step(jm)(state, batch)
    got = make_eval_step(model)(torch_batch(batch))
    assert set(got) == set(ref)
    for key in ref:
        assert rel_err(got[key], np.asarray(ref[key]), 1e-3) <= 1e-5, key


def test_a_textual_only_pth_keeps_the_rest_as_initialised(tmp_path):
    """As the JAX zoo's ``_merge_into``: what the file lacks keeps its
    init."""
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    overrides = NARROW + NARROW_HEAD
    path, sd = seeded_pth(tmp_path, rel, overrides, seed=4,
                          keep=lambda k: not k.startswith("visual."))
    torch.manual_seed(0)
    fresh, _ = zoo.get(rel, overrides=overrides, device="cpu")
    torch.manual_seed(0)
    model, _ = zoo.get(rel, pretrained=True, checkpoint_path=path,
                       overrides=overrides, device="cpu")
    fresh_sd = fresh.state_dict()
    for name, value in model.state_dict().items():
        want = sd[name] if name in sd else fresh_sd[name]
        assert torch.equal(value, want), name
    _, jvars, _ = jax_zoo.get(rel, pretrained=True, checkpoint_path=path,
                              overrides=overrides)
    exported = export_virtex_checkpoint(jax.tree.map(np.asarray, jvars))
    for name, value in sd.items():
        assert np.array_equal(exported[name], value.numpy()), name


def test_pretrained_without_the_zoo_dir_raises(monkeypatch):
    monkeypatch.delenv(zoo.ZOO_DIR_ENV, raising=False)
    with pytest.raises(RuntimeError, match="VIRTEX_TPU_ZOO_DIR"):
        zoo.get("width_ablations/bicaptioning_R_50_L1_H512.yaml",
                pretrained=True, overrides=NARROW + NARROW_HEAD,
                device="cpu")


@pytest.mark.parametrize("suffix", ["", ".pth"])
def test_the_zoo_dir_resolves_name_and_name_pth(tmp_path, monkeypatch,
                                                 suffix):
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    overrides = NARROW + NARROW_HEAD
    path, sd = seeded_pth(tmp_path, rel, overrides, seed=6)
    zoo_dir = tmp_path / "zoo"
    zoo_dir.mkdir()
    os.replace(path, zoo_dir / f"bicaptioning_R_50_L1_H512{suffix}")
    monkeypatch.setenv(zoo.ZOO_DIR_ENV, str(zoo_dir))
    model, _ = zoo.get(rel, pretrained=True, overrides=overrides,
                       device="cpu")
    for name, value in model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    # the JAX zoo resolves the same file
    assert jax_zoo._zoo_checkpoint_path(os.path.join(
        jax_zoo._configs_root(), rel)) == zoo._zoo_checkpoint_path(
        os.path.join(zoo._configs_root(), rel))


def test_a_missing_zoo_file_and_an_orbax_directory_raise(tmp_path,
                                                         monkeypatch):
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    monkeypatch.setenv(zoo.ZOO_DIR_ENV, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bicaptioning_R_50_L1_H512"):
        zoo.get(rel, pretrained=True, overrides=NARROW + NARROW_HEAD,
                device="cpu")
    (tmp_path / "bicaptioning_R_50_L1_H512").mkdir()
    with pytest.raises(ValueError, match="export_torch_checkpoint.py"):
        zoo.get(rel, pretrained=True, overrides=NARROW + NARROW_HEAD,
                device="cpu")


def test_a_legacy_pth_loads(tmp_path):
    """A ``.pth`` of the pre-zip format, as old reference-era files are."""
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    overrides = NARROW + NARROW_HEAD
    path, sd = seeded_pth(tmp_path, rel, overrides, seed=8)
    legacy = tmp_path / "legacy.pth"
    torch.save({"model": sd}, str(legacy), _use_new_zipfile_serialization=False)
    with open(legacy, "rb") as f:
        assert f.read(2) != b"PK"  # not a zip archive
    model, _ = zoo.get(rel, pretrained=True, checkpoint_path=str(legacy),
                       overrides=overrides, device="cpu")
    for name, value in model.state_dict().items():
        assert torch.equal(value, sd[name]), name


def test_fetch_file_url_cache_and_checksum(tmp_path):
    src = tmp_path / "weights.pth"
    src.write_bytes(b"fake-checkpoint-bytes")
    sha = hashlib.sha256(src.read_bytes()).hexdigest()
    cache = tmp_path / "cache"
    got = zoo.fetch(f"file://{src}", sha256=sha, cache_dir=str(cache))
    assert open(got, "rb").read() == b"fake-checkpoint-bytes"
    src.unlink()  # a cache hit reads nothing
    assert zoo.fetch(f"file://{src}", sha256=sha, cache_dir=str(cache)) == got
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        zoo.fetch(f"file://{src}", sha256="0" * 64, cache_dir=str(cache))
    assert not os.path.exists(got)


def test_fetch_sha256_fragment_and_cache_env(tmp_path, monkeypatch):
    src = tmp_path / "w.pth"
    src.write_bytes(b"abc123")
    sha = hashlib.sha256(b"abc123").hexdigest()
    monkeypatch.setenv(zoo.CACHE_DIR_ENV, str(tmp_path / "c"))
    got = zoo.fetch(f"file://{src}#sha256={sha}")
    assert got.startswith(str(tmp_path / "c"))
    assert open(got, "rb").read() == b"abc123"
    with pytest.raises(RuntimeError, match="checksum"):
        zoo.fetch(f"file://{src}#sha256={'f' * 64}",
                  cache_dir=str(tmp_path / "c2"))


def test_a_url_zoo_dir_fetches_name_pth(tmp_path, monkeypatch):
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    overrides = NARROW + NARROW_HEAD
    path, sd = seeded_pth(tmp_path, rel, overrides, seed=9)
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    os.replace(path, mirror / "bicaptioning_R_50_L1_H512.pth")
    monkeypatch.setenv(zoo.ZOO_DIR_ENV, f"file://{mirror}")
    monkeypatch.setenv(zoo.CACHE_DIR_ENV, str(tmp_path / "cache"))
    model, _ = zoo.get(rel, pretrained=True, overrides=overrides,
                       device="cpu")
    assert torch.equal(model.state_dict()["textual.output.bias"],
                       sd["textual.output.bias"])
    assert os.listdir(tmp_path / "cache")


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_jax_import_and_export_scripts_round_trip_a_port_checkpoint(
        tmp_path):
    """The port's checkpoint is the reference's ``.pth``: the JAX
    package's ``import_torch_checkpoint.py`` reads it into orbax, which the
    port refuses by name, and ``export_torch_checkpoint.py`` writes it back
    as a ``.pth`` that the port loads to the same bits."""
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    overrides = NARROW + NARROW_HEAD
    torch.manual_seed(1)
    model, _ = zoo.get(rel, overrides=overrides, device="cpu")
    with torch.no_grad():  # statistics off their constant init
        for name, buf in model.named_buffers():
            if buf.is_floating_point():
                buf.uniform_(0.5, 1.5)
    port_pth = tmp_path / "port.pth"
    torch.save({"model": model.state_dict(), "iteration": 3},
               str(port_pth))
    config = os.path.join(zoo._configs_root(), rel)
    orbax_dir = tmp_path / "orbax"
    _jax_script("import_torch_checkpoint").main(argparse.Namespace(
        config=config, config_override=overrides,
        checkpoint_path=str(port_pth), output=str(orbax_dir), iteration=3))
    with pytest.raises(ValueError, match="export_torch_checkpoint.py"):
        zoo.get(rel, pretrained=True, checkpoint_path=str(orbax_dir),
                overrides=overrides, device="cpu")
    back = tmp_path / "back.pth"
    _jax_script("export_torch_checkpoint").main(argparse.Namespace(
        config=config, config_override=overrides,
        checkpoint_path=str(orbax_dir), output=str(back), iteration=3))
    loaded, _ = zoo.get(rel, pretrained=True, checkpoint_path=str(back),
                        overrides=overrides, device="cpu")
    want = model.state_dict()
    for name, value in loaded.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert read_checkpoint(str(back))["iteration"] == 3


def test_get_builds_on_the_card_unless_asked():
    rel = "width_ablations/bicaptioning_R_50_L1_H512.yaml"
    overrides = NARROW + NARROW_HEAD
    if torch.cuda.is_available():
        model, _ = zoo.get(rel, overrides=overrides)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zoo.get(rel, overrides=overrides)
    model, _ = zoo.get(rel, overrides=overrides, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
