"""The fault pass over the parts of the port not yet held against the JAX
package, on the CPU.

- Bicaptioning's backward transformer is initialised on its own, as
  ``virtex_tpu``'s ``backward_transformer`` is: at construction the two
  transformers differ and draw from the same distribution.
- A frozen visual backbone through the whole model: the forward equals the
  JAX package's (``cnn(train=False)`` then ``stop_gradient``), BatchNorm's
  running statistics stay fixed in training, and no gradient reaches the
  CNN.
- The trunks of configs/backbone_ablations (resnet101, wide_resnet50_2):
  one fp32 forward at 64² equals the JAX trunk's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401 (an autouse fixture)
    caption_batch,
    drawn_variables,
    one_torch_thread,
    port_model,
    redraw,
    rel_err,
    torch_batch,
)
from virtex_tpu.config import Config
from virtex_tpu.factories import PretrainingModelFactory as JaxFactory
from virtex_tpu.modules.visual_backbones import (
    ResNetVisualBackbone as JaxVisual,
)
from virtex_tpu_torch.config import ModelSpec
from virtex_tpu_torch.factories import PretrainingModelFactory
from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone
from virtex_tpu_torch.utils.weights import state_dict_from_flax

TINY = ["MODEL.NAME", "bicaptioning", "MODEL.VISUAL.NAME",
        "torchvision::resnet18", "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H64_A2_F128",
        "MODEL.TEXTUAL.DROPOUT", 0.0, "DATA.VOCAB_SIZE", 300,
        "DATA.MAX_CAPTION_LENGTH", 8, "DTYPE", "float32"]


def test_backward_transformer_is_initialised_on_its_own():
    spec = ModelSpec.from_config(Config(override_list=TINY))
    torch.manual_seed(0)
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    fwd = dict(model.textual.transformer.named_parameters())
    bwd = dict(model.backward_textual.transformer.named_parameters())
    assert sorted(fwd) == sorted(bwd)
    drawn = [n for n in fwd if fwd[n].numel() >= 4096]  # the matrices
    assert drawn
    for name in drawn:
        a, b = fwd[name].detach(), bwd[name].detach()
        assert not torch.equal(a, b), name
        # the same distribution: mean and spread agree to sampling noise
        std = float(a.std())
        assert abs(float(a.mean() - b.mean())) < 0.1 * std, name
        assert abs(float(b.std()) / std - 1.0) < 0.05, name
    # the shared parts are shared, not copied
    assert model.backward_textual.embedding is model.textual.embedding
    assert (model.backward_textual.visual_projection
            is model.textual.visual_projection)


def test_frozen_backbone_through_the_whole_model():
    cfg = Config(override_list=TINY + ["MODEL.VISUAL.FROZEN", True])
    jm = JaxFactory.from_config(cfg)
    batch = caption_batch(4, 64, 8, 300, seed=3)
    variables = drawn_variables(jm, batch, seed=3, output_bias_std=1.0)
    spec = ModelSpec.from_config(cfg)
    assert spec.visual_frozen
    model = port_model(spec, variables)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    apply = jax.jit(lambda v, b: jm.apply(v, b, train=True,
                                          mutable=["batch_stats"]))
    ref, updates = apply(variables, jb)
    # JAX: the frozen CNN's statistics come back unchanged
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, updates["batch_stats"]["visual"]),
                 variables["batch_stats"]["visual"])

    before = copy.deepcopy(model.visual.state_dict())
    model.train()
    out = model(torch_batch(batch), generator=torch.Generator())
    # fp32 losses of O(10), the visual grid on running statistics on both
    assert rel_err(out["loss"], np.asarray(ref["loss"]), 1.0) <= 1e-5
    out["loss"].backward()
    assert model.visual.cnn.training is False
    for name, p in model.visual.named_parameters():
        assert p.grad is None and not p.requires_grad, name
    assert any(p.grad is not None for p in model.textual.parameters())
    for k, v in model.visual.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch", ["resnet101", "wide_resnet50_2",
                                  "resnext50_32x4d", "resnext101_32x8d"])
def test_backbone_ablation_trunk_matches_jax(arch):
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    jm = JaxVisual(arch, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                              train=False), x)
    rng = np.random.RandomState(2)

    def fill(tree):
        if not isinstance(tree, dict):
            std = (np.sqrt(2.0 / np.prod(tree.shape[:3]))
                   if len(tree.shape) == 4 else 0.0)
            return (std * rng.randn(*tree.shape)).astype(np.float32)
        return {k: fill(v) for k, v in tree.items()}

    v = redraw(fill({"params": dict(shapes["params"]),
                     "batch_stats": dict(shapes["batch_stats"])}), rng)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    port = ResNetVisualBackbone(arch, dtype=torch.float32).eval()
    state = state_dict_from_flax({"params": {"visual": v["params"]},
                                  "batch_stats": {"visual": v["batch_stats"]}})
    port.load_state_dict({k[len("visual."):]: t for k, t in state.items()},
                         strict=True)
    with torch.no_grad():
        grid = port(torch.from_numpy(x))
    assert tuple(grid.shape) == ref.shape == (1, 2, 2, 2048)
    # fp32 convolutions summed in other orders: within 1e-5 of the grid's
    # scale, as the ResNet-50 trunk in tests/test_torch_modules.py
    assert rel_err(grid, ref, float(np.abs(ref).max())) <= 1e-5
