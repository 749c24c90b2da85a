"""The port's hub entry points (virtex_tpu_torch/hubconf.py) against the
JAX package's (the repository's root hubconf.py), on the CPU.

Both read one ``.pth`` from a temporary ``$VIRTEX_TPU_ZOO_DIR``: the
flagship's ResNet-50 with a narrow textual head (32 wide, vocabulary 100)
in fp32, through a temporary ``$VIRTEX_TPU_CONFIGS_DIR`` whose
``width_ablations/bicaptioning_R_50_L1_H1024.yaml`` narrows the head over
the repository's base config; weights drawn from a numpy seed and
exported by the JAX package. The features agree within 1e-4 of |ref| +
their RMS (the visual grid's bound); NCHW and NHWC inputs give the same bits; the
entry loads through ``torch.hub.load(..., source="local")``."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    drawn_variables,
    init_batch,
    one_torch_thread,
    rel_err,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUB_DIR = os.path.join(REPO, "virtex_tpu_torch")
ZOO_NAME = "bicaptioning_R_50_L1_H1024"


@pytest.fixture(scope="module")
def zoo_env(tmp_path_factory):
    """(configs dir, zoo dir) holding the narrowed flagship config and its
    seeded ``.pth``."""
    from virtex_tpu.config import Config
    from virtex_tpu.factories import PretrainingModelFactory
    from virtex_tpu.utils.checkpoint_convert import export_virtex_checkpoint

    tmp = tmp_path_factory.mktemp("hub")
    configs = tmp / "configs" / "width_ablations"
    configs.mkdir(parents=True)
    base = os.path.join(REPO, "configs",
                        "_base_bicaptioning_R_50_L1_H1024.yaml")
    (configs / f"{ZOO_NAME}.yaml").write_text(
        f'_BASE_: "{base}"\nDTYPE: "float32"\nDATA:\n  VOCAB_SIZE: 100\n'
        'MODEL:\n  TEXTUAL:\n    NAME: "transdec_postnorm::L1_H32_A4_F64"\n')
    cfg = Config(str(configs / f"{ZOO_NAME}.yaml"))
    assert cfg.MODEL.VISUAL.NAME == "torchvision::resnet50"
    model = PretrainingModelFactory.from_config(cfg)
    variables = drawn_variables(model, init_batch(cfg, image=64), seed=2)
    zoo = tmp / "zoo"
    zoo.mkdir()
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          export_virtex_checkpoint(variables).items()}},
               str(zoo / f"{ZOO_NAME}.pth"))
    return str(tmp / "configs"), str(zoo)


@pytest.fixture
def zoo_vars(zoo_env, monkeypatch):
    monkeypatch.setenv("VIRTEX_TPU_CONFIGS_DIR", zoo_env[0])
    monkeypatch.setenv("VIRTEX_TPU_ZOO_DIR", zoo_env[1])


def jax_hubconf():
    """The root hubconf.py, loaded by path (not through sys.modules)."""
    spec = importlib.util.spec_from_file_location(
        "jax_hubconf", os.path.join(REPO, "hubconf.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_extractor(**kwargs):
    return torch.hub.load(HUB_DIR, "resnet50_extractor", source="local",
                          device="cpu", **kwargs)


def test_features_equal_the_jax_extractor(zoo_vars):
    images = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax_hubconf().resnet50_extractor(pretrained=True)(
        images))
    got = port_extractor(pretrained=True)(images)
    assert got.shape == ref.shape == (2, 2, 2, 2048)
    assert got.dtype == torch.float32
    # the visual grid's bound (tests/test_torch_captioning.py), atol the
    # grid's scale: with redrawn BatchNorm statistics it grows to O(100)
    scale = float(np.sqrt(np.mean(np.square(ref))))
    assert scale > 1.0
    assert rel_err(got, ref, scale) <= 1e-4


def test_nchw_and_nhwc_give_the_same_bits_at_224(zoo_vars):
    extract = port_extractor(pretrained=True)
    nhwc = torch.from_numpy(np.random.RandomState(1).rand(
        1, 224, 224, 3).astype(np.float32))
    out = extract(nhwc)
    assert out.shape == (1, 7, 7, 2048)
    assert torch.equal(out, extract(nhwc.permute(0, 3, 1, 2)))
    assert torch.equal(out, extract(nhwc.numpy()))  # numpy in, same bits
    with pytest.raises(ValueError, match="expected"):
        extract(nhwc[0])


def test_resnet50_is_the_zoo_models_visual_in_eval_mode(zoo_vars):
    from virtex_tpu_torch import model_zoo
    visual = torch.hub.load(HUB_DIR, "resnet50", source="local",
                            pretrained=True, device="cpu")
    model, _ = model_zoo.get(f"width_ablations/{ZOO_NAME}.yaml",
                             pretrained=True, device="cpu")
    assert not visual.training
    want = model.visual.state_dict()
    for name, value in visual.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_hubconf_declares_its_dependencies_and_needs_a_card():
    spec = importlib.util.spec_from_file_location(
        "port_hubconf", os.path.join(HUB_DIR, "hubconf.py"))
    hub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hub)
    assert hub.dependencies == ["torch", "numpy"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hub.resnet50_extractor()
