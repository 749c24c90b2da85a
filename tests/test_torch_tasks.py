"""The port's other pretext tasks against the JAX package, on the CPU:
forward captioning, masked LM, token classification and multilabel
classification, built by ``virtex_tpu_torch.factories`` from the same
``Config`` as ``virtex_tpu.factories.PretrainingModelFactory``.

At small size in float32 (resnet18 at 64², ``L1_H32_A4_F64`` or the linear
head, vocabulary 60, captions of 8 tokens, dropout 0), from weights drawn
from a numpy seed that reach the port only through ``state_dict_from_flax``
and ``load_state_dict(strict=True)``:

- each model's loss and components in train and eval mode, and its eval
  predictions, which must be equal;
- a 3-step trajectory against the JAX ``make_train_step`` (two tasks at
  ``accum_steps`` 2): losses, ``grad_norm``, final parameters and BatchNorm
  statistics;
- ``LinearTextualHead`` alone in bf16, and ``instance_label_set_loss``
  with duplicate labels, all-ignored rows and padding;
- the ``task_ablation`` presets against ``configs/task_ablations/*.yaml``.

Every comparison is |a − b| / (|ref| + atol) with its bound stated.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (
    caption_batch,
    drawn_variables,
    port_model,
    rel_err,
    torch_batch,
)
from virtex_tpu.config import Config
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_train_step as jax_train_step
from virtex_tpu.factories import OptimizerFactory, PretrainingModelFactory
from virtex_tpu_torch.config import TASK_ABLATIONS, ModelSpec, OptimSpec
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.optim.optimizer import build_optimizer
from virtex_tpu_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO, IMAGE, LENGTH, VOCAB, STEPS = 4, 64, 8, 60, 3
# accumulation per task: masked LM and multilabel slice masked_labels and
# labels into micro-batches
TASKS = {"captioning": 1, "masked_lm": 2, "token_classification": 1,
         "multilabel_classification": 2}
MASK_INDEX, MULTILABEL_WIDTH = 3, 12


def _config(name: str) -> Config:
    classification = name.endswith("classification")
    return Config(override_list=[
        "MODEL.NAME", name,
        "MODEL.VISUAL.NAME", "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", ("none" if classification
                               else "transdec_postnorm::L1_H32_A4_F64"),
        "MODEL.TEXTUAL.DROPOUT", 0.0,
        "DATA.VOCAB_SIZE", VOCAB,
        "DATA.MAX_CAPTION_LENGTH", LENGTH,
        "DATA.IMAGE_CROP_SIZE", IMAGE,
        "DTYPE", "float32",
        "OPTIM.NO_DECAY", ("none" if classification else
                           ".*textual.(embedding|transformer).*(norm.*|bias)"),
        "OPTIM.WARMUP_STEPS", 1,
        "OPTIM.LOOKAHEAD.STEPS", 2,
    ])


def mask_tokens(tokens, lengths, vocab, rng):
    """Masked LM's batch, as ``virtex_tpu.data.datasets.masked_lm`` makes
    it: ⌈15%⌉ of the inner positions chosen; of those 85% ``[MASK]``ed
    (their label is the token), 10% a random token, the rest kept; labels
    are padding (0) elsewhere. A single chosen position is always masked."""
    tokens = tokens.copy()
    labels = np.zeros_like(tokens)
    for i, n in enumerate(lengths):
        k = math.ceil((n - 2) * 0.15)
        for j in rng.choice(np.arange(1, n - 1), size=k, replace=False):
            flag = rng.uniform()
            if k == 1 or flag <= 0.85:
                labels[i, j], tokens[i, j] = tokens[i, j], MASK_INDEX
            elif flag <= 0.95:
                tokens[i, j] = rng.randint(vocab)
    return tokens, labels


def task_batch(name: str, size: int, seed: int) -> dict:
    """A numpy batch with the keys the task's dataset makes."""
    b = caption_batch(size, IMAGE, LENGTH, VOCAB, seed)
    rng = np.random.RandomState(seed + 100)
    if name == "captioning":
        return b
    if name == "masked_lm":
        tokens, labels = mask_tokens(b["caption_tokens"],
                                     b["caption_lengths"], VOCAB, rng)
        return {"image": b["image"], "caption_tokens": tokens,
                "masked_labels": labels,
                "caption_lengths": b["caption_lengths"]}
    if name == "token_classification":
        return {"image": b["image"], "labels": b["caption_tokens"]}
    # multilabel: categories 1..VOCAB-1, duplicates allowed, padded with 0
    labels = np.zeros((size, MULTILABEL_WIDTH), np.int32)
    for i in range(size):
        n = rng.randint(1, MULTILABEL_WIDTH + 1)
        labels[i, :n] = rng.randint(1, VOCAB, n)
    return {"image": b["image"], "labels": labels}


def _micro(batch, accum):
    """(accum·B, ...) leaves → (accum, B, ...), the JAX package's layout."""
    if accum == 1:
        return batch
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(TASKS))
def task(request):
    """A task's config, JAX model, weights, and the port's model."""
    name = request.param
    cfg = _config(name)
    jm = PretrainingModelFactory.from_config(cfg)
    variables = drawn_variables(jm, task_batch(name, 2, 0), seed=1,
                                output_bias_std=1.0)
    spec = ModelSpec.from_config(cfg)
    return name, cfg, jm, variables, port_model(spec, variables)


# -- the models --------------------------------------------------------------
def test_model_matches_jax_in_train_and_eval_mode(task):
    name, _, jm, variables, model = task
    batch = task_batch(name, MICRO, 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    both = jax.jit(lambda v, b: (
        jm.apply(v, b, train=False),
        jm.apply(v, b, train=True, mutable=["batch_stats"])[0]))
    ref_eval, ref_train = both(variables, jb)

    with torch.no_grad():
        got_eval = model.eval()(torch_batch(batch))
        got_train = model.train()(torch_batch(batch))
    for got, ref in ((got_eval, ref_eval), (got_train, ref_train)):
        assert set(got["loss_components"]) == set(ref["loss_components"])
        pairs = [(got["loss"], ref["loss"])] + [
            (v, ref["loss_components"][k])
            for k, v in got["loss_components"].items()]
        for a, r in pairs:
            # fp32 losses of O(1-10) through the same math; measured <= 3e-7
            assert got["loss"].dtype == torch.float32
            assert rel_err(a, np.asarray(r), 1e-3) <= 1e-5
    assert "predictions" not in got_train
    # Ranks of logits whose gaps (output bias of std 1) dwarf fp32 noise.
    assert np.array_equal(got_eval["predictions"].numpy(),
                          np.asarray(ref_eval["predictions"]))
    if name == "masked_lm":
        labels = batch["masked_labels"]
        assert (got_eval["predictions"].numpy()[labels == 0] == 0).all()
    if name.endswith("classification"):
        assert tuple(got_eval["predictions"].shape) == (MICRO, 10)


# -- 3-step trajectories -----------------------------------------------------
def _run_jax(cfg, jm, variables, batches, accum):
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


def test_trajectory_matches_jax(task):
    name, cfg, jm, variables, _ = task
    accum = TASKS[name]
    batches = [_micro(task_batch(name, MICRO * accum, 10 + s), accum)
               for s in range(STEPS)]
    ref, ref_final = _run_jax(cfg, jm, variables, batches, accum)
    got, final = _run_port(cfg, variables, batches, accum)

    # The ResNet's backward is ill-conditioned at 4 images of 64²: layer4
    # normalizes 16 values per channel, so one ReLU input within fp32 noise
    # of zero that lands on the other side moves the gradient of every
    # layer below it by up to 2% (perturbing the initial weights by 1e-7
    # of their size does the same to the port's own gradients). Captioning
    # and masked LM read the grid through the transformer, and their
    # grad_norm is the textual gradients': their losses and grad_norm agree
    # to ~3e-7. The classification tasks put the loss's gradient straight
    # into the pooled grid, so their grad_norm is the ResNet's (measured
    # <= 1.2e-3). Their steps 0 and 1 run on the initial weights (warmup
    # makes the first update zero) and the losses agree to ~4e-7; step 2
    # follows an update that carries the ResNet's gradients through CNN_LR
    # 0.2 (measured <= 1.4e-4).
    classification = name.endswith("classification")
    grad_norm_tol = 1e-2 if classification else 1e-3
    for step, (a, r) in enumerate(zip(got, ref)):
        assert set(a) == set(r)
        for k in r:
            if k == "grad_norm":
                assert abs(a[k] - r[k]) <= grad_norm_tol * r[k], (step, k)
            else:
                tol = 2e-3 if classification and step == 2 else 1e-5
                assert abs(a[k] - r[k]) <= tol * abs(r[k]), (step, k)

    assert sorted(final) == sorted(ref_final)
    for key, ref_value in ref_final.items():
        if key.endswith("num_batches_tracked"):
            assert int(final[key]) == STEPS * accum, key
            continue
        ref_value = ref_value.numpy()
        scale = float(np.abs(ref_value).max()) + 1e-12
        # Per element, relative to the tensor's own scale. The textual
        # parameters agree to ~2e-5. The ResNet's carry the gradient flips
        # above through CNN_LR 0.2: ~1e-5 where the transformer feeds them,
        # up to 2e-2 where the classification loss does.
        if not key.startswith("visual."):
            tol = 1e-4
        else:
            tol = 5e-2 if classification else 1e-4
        assert rel_err(final[key], ref_value, scale) <= tol, key


# -- pieces ------------------------------------------------------------------
def test_linear_head_matches_jax_in_bf16():
    """``jnp.mean`` of a bf16 grid returns bf16: the pooled features are
    rounded to bf16 before the fp32 layer, and the port rounds them too."""
    from virtex_tpu.modules.textual_heads import LinearTextualHead as JaxHead
    from virtex_tpu_torch.modules.textual_heads import LinearTextualHead
    rng = np.random.RandomState(3)
    grid = (rng.randn(4, 7, 7, 64) + 0.3).astype(np.float32)
    head = JaxHead(visual_feature_size=64, vocab_size=81)
    params = {"output": {"kernel": (0.5 * rng.randn(64, 81)).astype(
                  np.float32),
              "bias": rng.randn(81).astype(np.float32)}}
    jgrid = jnp.asarray(grid, jnp.bfloat16)
    ref = np.asarray(head.apply({"params": params}, jgrid))
    ours_head = LinearTextualHead(64, 81)
    ours_head.load_state_dict({
        "output.weight": torch.from_numpy(params["output"]["kernel"].T.copy()),
        "output.bias": torch.from_numpy(params["output"]["bias"])})
    tgrid = torch.from_numpy(grid).to(torch.bfloat16)
    with torch.no_grad():
        ours = ours_head(tgrid).numpy()
        fp32_mean = ours_head(tgrid.float()).numpy()
    assert ours.dtype == ref.dtype == np.float32
    # The fp32 means of 49 bf16 values agree to ~1e-7 before the bf16
    # rounding, which lands on the same bf16 value except where a mean sits
    # on a rounding boundary (one ulp, 2^-8 relative); logits of scale ~4.
    assert rel_err(ours, ref, 1.0) <= 1e-5
    # Without the rounding the logits move by ~1e-3: the test sees it.
    assert rel_err(fp32_mean, ref, 1.0) > 1e-4


def test_instance_label_set_loss_matches_jax():
    from virtex_tpu.models.classification import (
        instance_label_set_loss as jax_loss,
    )
    from virtex_tpu_torch.models.classification import (
        instance_label_set_loss,
    )
    rng = np.random.RandomState(4)
    logits = (2.0 * rng.randn(5, 30)).astype(np.float32)
    labels = np.array([[7, 7, 9, 0, 0, 0],       # a duplicate, padding
                       [1, 2, 3, 0, 0, 0],       # every label ignored
                       [4, 29, 4, 4, 12, 0],     # duplicates
                       [0, 0, 0, 0, 0, 0],       # padding only
                       [5, 6, 8, 10, 11, 13]], np.int32)
    ignore = (0, 1, 2, 3)
    ref = float(jax_loss(jnp.asarray(logits), jnp.asarray(labels), ignore))
    x = torch.from_numpy(logits).requires_grad_()
    ours = instance_label_set_loss(x, torch.from_numpy(labels), ignore)
    # an fp32 mean of ~3 log-probabilities of O(3)
    assert abs(float(ours.detach()) - ref) <= 1e-6 * abs(ref)
    ref_grad = np.asarray(jax.grad(lambda z: jax_loss(
        z, jnp.asarray(labels), ignore))(jnp.asarray(logits)))
    ours.backward()
    assert rel_err(x.grad.numpy(), ref_grad, 1e-3) <= 1e-5
    # rows 1 and 3 have no valid label: no gradient reaches them
    assert not x.grad[1].any() and not x.grad[3].any()


@pytest.mark.parametrize("stem", sorted(TASK_ABLATIONS))
def test_task_ablation_presets_equal_the_yaml(stem):
    cfg = Config(os.path.join(REPO, "configs", "task_ablations",
                              f"{stem}.yaml"))
    assert ModelSpec.task_ablation(stem) == ModelSpec.from_config(cfg)
    assert OptimSpec.task_ablation(stem) == OptimSpec.from_config(cfg)


def test_specs_refuse_unknown_names():
    with pytest.raises(KeyError, match="MODEL.NAME"):
        ModelSpec(model_name="simclr")
    with pytest.raises(KeyError, match="DECODER"):
        ModelSpec(decoder_name="greedy")
    with pytest.raises(KeyError, match="task ablation"):
        ModelSpec.task_ablation("bicaptioning_R_50_L1_H1024")
