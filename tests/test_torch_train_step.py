"""The port's train step (virtex_tpu_torch.engine.trainer) against the JAX
package's ``make_train_step``, end to end on the CPU, and its dropout's
reproducibility from a seed.

The trajectory gate: the flagship ``bicaptioning`` at
``_flagship_config(tiny=True)`` (resnet18, L1_H128_A4_F256, captions of 8
tokens, 10k vocab) in float32 with dropout 0, ``WARMUP_STEPS`` 1 (the
first update is zero but for the momentum and Lookahead state) and
``LOOKAHEAD.STEPS`` 2 (a sync at step 2), from the same weights, 3 steps,
with ``accum_steps`` 1 and 2. Each step's loss and ``grad_norm``, then the
final parameters and BatchNorm statistics through ``state_dict_from_flax``,
agree within the bounds stated below.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (
    caption_batch,
    jax_variables,
    port_model,
    rel_err,
    tiny_config,
    torch_batch,
)
from virtex_tpu.config import Config
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_train_step as jax_train_step
from virtex_tpu.factories import OptimizerFactory, PretrainingModelFactory
from virtex_tpu_torch.config import ModelSpec, OptimSpec
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.optim.optimizer import build_optimizer
from virtex_tpu_torch.utils.weights import state_dict_from_flax

MICRO, IMAGE, STEPS = 4, 64, 3


def _config(dropout: float) -> Config:
    base = tiny_config()
    return Config(override_list=[
        "MODEL.NAME", base.MODEL.NAME,
        "MODEL.VISUAL.NAME", base.MODEL.VISUAL.NAME,
        "MODEL.VISUAL.FEATURE_SIZE", base.MODEL.VISUAL.FEATURE_SIZE,
        "MODEL.TEXTUAL.NAME", base.MODEL.TEXTUAL.NAME,
        "DATA.MAX_CAPTION_LENGTH", base.DATA.MAX_CAPTION_LENGTH,
        "DTYPE", "float32",
        "MODEL.TEXTUAL.DROPOUT", dropout,
        "OPTIM.WARMUP_STEPS", 1,
        "OPTIM.LOOKAHEAD.STEPS", 2,
    ])


def _micro(batch, accum):
    """(accum·B, ...) leaves → (accum, B, ...), the JAX package's layout."""
    if accum == 1:
        return batch
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
            for k, v in batch.items()}


def _run_jax(cfg, variables, batches, accum):
    jm = PretrainingModelFactory.from_config(cfg)
    tx = OptimizerFactory.from_config(cfg, variables["params"])
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              tx)
    step = jax_train_step(jm, tx, donate=False, jit=True, accum_steps=accum)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    return metrics, state_dict_from_flax(final)


def _run_port(cfg, variables, batches, accum):
    model = port_model(ModelSpec.from_config(cfg), variables)
    opt = build_optimizer(model.named_parameters(),
                          OptimSpec.from_config(cfg))
    step = make_train_step(model, opt, accum_steps=accum)
    metrics = [{k: float(v) for k, v in step(torch_batch(b)).items()}
               for b in batches]
    return metrics, model.state_dict()


@pytest.mark.parametrize("accum", [1, 2])
def test_trajectory_matches_jax(accum):
    cfg = _config(dropout=0.0)
    jm = PretrainingModelFactory.from_config(cfg)
    L = cfg.DATA.MAX_CAPTION_LENGTH
    batches = [caption_batch(MICRO * accum, IMAGE, L, cfg.DATA.VOCAB_SIZE,
                             seed=s) for s in range(STEPS)]
    variables = jax_variables(jm, batches[0], seed=0, output_bias_std=1.0)
    batches = [_micro(b, accum) for b in batches]
    ref, ref_final = _run_jax(cfg, variables, batches, accum)
    got, final = _run_port(cfg, variables, batches, accum)

    for step, (a, r) in enumerate(zip(got, ref)):
        assert set(a) == set(r) == {"loss", "grad_norm", "captioning_forward",
                                    "captioning_backward"}
        # fp32 losses of O(10): the forward passes agree to ~2e-7.
        for k in ("loss", "captioning_forward", "captioning_backward"):
            assert abs(a[k] - r[k]) <= 1e-5 * abs(r[k]), (step, k)
        # The ResNet's backward is ill-conditioned at 4 images of 64²: a
        # ReLU input within fp32 noise of zero flips between the two sides
        # (a float64 run of the port agrees with JAX's fp32 to 2e-5 where
        # the port's fp32 differs by up to 16% in one layer's gradient).
        # Measured grad_norm gap <= 8.5e-5 relative.
        assert abs(a["grad_norm"] - r["grad_norm"]) \
            <= 1e-3 * r["grad_norm"], step

    assert sorted(final) == sorted(ref_final)
    for name, ref_value in ref_final.items():
        if name.endswith("num_batches_tracked"):
            assert int(final[name]) == STEPS * accum, name
            continue
        ref_value = ref_value.numpy()
        scale = float(np.abs(ref_value).max()) + 1e-12
        # Per element, relative to the tensor's own scale. The textual
        # head's parameters agree to ~3e-6; the ResNet's carry the flips
        # above through LR 0.2 (measured <= 1.8e-3).
        tol = 1e-2 if name.startswith("visual.") else 1e-4
        assert rel_err(final[name], ref_value, scale) <= tol, name


# -- dropout bits come from the caller's generator ----------------------------
@pytest.fixture(scope="module")
def dropout_setup():
    cfg = _config(dropout=0.1)
    jm = PretrainingModelFactory.from_config(cfg)
    batch = caption_batch(2, IMAGE, cfg.DATA.MAX_CAPTION_LENGTH,
                          cfg.DATA.VOCAB_SIZE, seed=5)
    variables = jax_variables(jm, batch, seed=5)
    return cfg, port_model(ModelSpec.from_config(cfg), variables), batch


def _step_from_seed(cfg, model, batch, seed):
    model = copy.deepcopy(model)
    opt = build_optimizer(model.named_parameters(),
                          OptimSpec.from_config(cfg))
    gen = torch.Generator().manual_seed(seed)
    metrics = make_train_step(model, opt, generator=gen)(torch_batch(batch))
    metrics = make_train_step(model, opt, generator=gen)(torch_batch(batch))
    return metrics, model.state_dict()


def test_two_steps_from_one_seed_are_identical(dropout_setup):
    cfg, model, batch = dropout_setup
    m1, s1 = _step_from_seed(cfg, model, batch, 11)
    m2, s2 = _step_from_seed(cfg, model, batch, 11)
    m3, s3 = _step_from_seed(cfg, model, batch, 12)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    # another seed drops other units: other losses and other parameters
    assert not torch.equal(m1["loss"], m3["loss"])
    assert any(not torch.equal(s1[k], s3[k]) for k in s1
               if k.startswith("textual.transformer"))


def test_training_with_dropout_needs_a_generator(dropout_setup):
    cfg, model, batch = dropout_setup
    model = copy.deepcopy(model).train()
    with pytest.raises(ValueError, match="torch.Generator"):
        model(torch_batch(batch))


def test_accum_steps_validation(dropout_setup):
    cfg, model, _ = dropout_setup
    opt = build_optimizer(model.named_parameters(),
                          OptimSpec.from_config(cfg))
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(model, opt, accum_steps=0)
