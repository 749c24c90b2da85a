"""The port's training pieces that hold no kernel, against the JAX package
on the CPU: the LR schedules, the decay and CNN masks, the optimizer chain
(SGD or AdamW, clip, dual LR, frozen, Lookahead) against optax, and the
token cross-entropy's hand-written gradient. Every comparison states its
bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_parity import caption_batch, jax_variables, tiny_config
from virtex_tpu.factories import PretrainingModelFactory
from virtex_tpu.models.captioning import token_cross_entropy as jax_ce
from virtex_tpu.optim import build_optimizer as jax_build_optimizer
from virtex_tpu.optim import make_schedule as jax_make_schedule
from virtex_tpu.optim.optimizer import cnn_mask as jax_cnn_mask
from virtex_tpu.optim.optimizer import decay_mask as jax_decay_mask
from virtex_tpu.optim.optimizer import param_path_names
from virtex_tpu_torch.config import ModelSpec, OptimSpec
from virtex_tpu_torch.factories import PretrainingModelFactory as PortFactory
from virtex_tpu_torch.models.captioning import token_cross_entropy
from virtex_tpu_torch.optim.lr_schedules import make_schedule
from virtex_tpu_torch.optim.optimizer import (
    NO_DECAY,
    Optimizer,
    cnn_mask,
    decay_mask,
)
from virtex_tpu_torch.utils.weights import (
    flax_name_map,
    flax_names,
    state_dict_from_flax,
)


# -- schedules ----------------------------------------------------------------
@pytest.mark.parametrize("name", ["none", "multistep", "linear", "cosine"])
def test_schedules_match_jax(name):
    total, warmup, milestones = 100, 10, (30, 60)
    ours = make_schedule(name, total, warmup, milestones, gamma=0.1)
    ref = jax_make_schedule(name, total, warmup, milestones, gamma=0.1)
    for step in range(total + 11):
        # the JAX side computes in float32; ours in float64
        assert abs(ours(step) - float(ref(step))) <= 1e-6, step
    assert ours(0) == 0.0  # warmup starts at 0
    assert make_schedule(name, total, 0, milestones)(0) == 1.0


def test_flagship_optim_spec_is_the_jax_default():
    from __graft_entry__ import _flagship_config
    assert OptimSpec.from_config(_flagship_config()) == OptimSpec.flagship()
    assert OptimSpec.flagship().no_decay == NO_DECAY


# -- masks --------------------------------------------------------------------
def _mask_setup(model_name):
    cfg = tiny_config(model_name=model_name)
    jm = PretrainingModelFactory.from_config(cfg)
    batch = caption_batch(2, 64, cfg.DATA.MAX_CAPTION_LENGTH,
                          cfg.DATA.VOCAB_SIZE, seed=2)
    batch["labels"] = batch["caption_tokens"]
    variables = jax_variables(jm, batch, seed=2)
    return variables, PortFactory.from_spec(ModelSpec.from_config(cfg),
                                         device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _mask_setup("bicaptioning")


@pytest.fixture(scope="module")
def tiny_linear_head():
    """A classification model, whose linear head's output bias is
    ``textual.output.bias`` in the JAX package (not ``output_bias``)."""
    return _mask_setup("token_classification")


# Holds the linear head's output bias out of decay under its JAX name only.
LINEAR_HEAD_NO_DECAY = r".*textual\.output\.bias"


def _check_flax_names(variables, model):
    jax_names = jax.tree.leaves(param_path_names(variables["params"]))
    ours = [n for names in flax_name_map(
        n for n, _ in model.named_parameters()).values() for n in names]
    # every JAX parameter once; the tied and shared ones are one port entry
    assert sorted(ours) == sorted(jax_names)


def _check_masks(variables, model, which, no_decay):
    params = variables["params"]
    jmask = (jax_decay_mask(params, no_decay) if which == "decay"
             else jax_cnn_mask(params))
    bridged = state_dict_from_flax({
        "params": jax.tree.map(lambda m, p: np.full(np.shape(p), float(m)),
                               jmask, params),
        "batch_stats": variables["batch_stats"]})
    ours = (decay_mask(model.named_parameters(), no_decay) if which == "decay"
            else cnn_mask(model.named_parameters()))
    assert set(ours) == {n for n, _ in model.named_parameters()}
    for name, value in ours.items():
        carried = bridged[name]
        assert bool(carried.all()) == bool(carried.any()) == value, name
    return ours


def test_flax_names_cover_the_jax_parameters_once(tiny):
    _check_flax_names(*tiny)


def test_flax_names_cover_the_linear_head_once(tiny_linear_head):
    _check_flax_names(*tiny_linear_head)


@pytest.mark.parametrize("which", ["decay", "cnn"])
def test_masks_equal_the_jax_masks_through_the_bridge(tiny, which):
    ours = _check_masks(*tiny, which, NO_DECAY)
    if which == "decay":
        # The JAX package's regex misses its backward transformer's norms
        # and biases ("textual.backward_transformer..."), so they decay;
        # matched on the JAX names, the port's mask keeps that.
        assert ours["backward_textual.transformer.layers.0.norm1.bias"]
        assert not ours["textual.transformer.layers.0.norm1.bias"]


@pytest.mark.parametrize("which", ["decay", "cnn"])
def test_linear_head_masks_equal_the_jax_masks(tiny_linear_head, which):
    ours = _check_masks(*tiny_linear_head, which, LINEAR_HEAD_NO_DECAY)
    if which == "decay":
        assert not ours["textual.output.bias"]
        assert ours["textual.output.weight"]


# -- the optimizer chain against optax ----------------------------------------
# One small tree whose names reach every mask: CNN and textual, decayed and
# not, and the backward transformer.
TREE = {
    "visual.cnn.conv1.weight": (6, 5),
    "visual.cnn.bn1.weight": (5,),
    "textual.transformer.layers.0.norm1.weight": (4,),
    "textual.transformer.layers.0.linear1.weight": (4, 3),
    "textual.transformer.layers.0.linear1.bias": (3,),
    "backward_textual.transformer.layers.0.norm1.bias": (4,),
    "textual.output.bias": (7,),
}


def _nest(flat):
    """Port name → its JAX path, as a nested dict of numpy arrays."""
    out = {}
    for name, value in flat.items():
        (path,) = flax_names(name)
        *scopes, leaf = path.split(".")
        node = out
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return out


def _draw(rng, scale=1.0):
    return {n: (scale * rng.randn(*s)).astype(np.float32)
            for n, s in TREE.items()}


@pytest.mark.parametrize("name,frozen", [("sgd", None), ("adamw", None),
                                         ("sgd", "cnn")])
def test_chain_matches_optax(name, frozen):
    rng = np.random.RandomState(0)
    init = _draw(rng)
    # grads of global norm ~16: clip at 4 bites at every step
    grads = [_draw(rng, 2.0) for _ in range(6)]
    kw = dict(lr=0.05, cnn_lr=0.3, weight_decay=0.1, momentum=0.9,
              clip_norm=4.0, use_lookahead=True, lookahead_k=3,
              lookahead_alpha=0.5, frozen_pattern=frozen)
    schedule = ("cosine", 10, 2)

    jparams = _nest(init)
    tx = jax_build_optimizer(jparams, name, jax_make_schedule(*schedule),
                             no_decay_pattern=NO_DECAY, **kw)
    jstate = tx.init(jparams)

    params = {n: torch.from_numpy(v.copy()).requires_grad_()
              for n, v in init.items()}
    opt = Optimizer(params.items(), name, make_schedule(*schedule), **kw)
    for step, g in enumerate(grads):
        jg = _nest(g)
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n])
        norm = opt.step()
        assert abs(float(norm) - float(optax.global_norm(jg))) <= 1e-5 * \
            float(norm)
        for n, p in params.items():
            node = jparams
            for s in flax_names(n)[0].split("."):
                node = node[s]
            # fp32 arithmetic in other orders; parameters of scale 1
            assert np.max(np.abs(p.detach().numpy() - np.asarray(node))) \
                <= 1e-5, (step, n)
    if frozen:
        for n in TREE:
            if "cnn" in n:
                assert np.array_equal(params[n].detach().numpy(), init[n])


def test_optimizer_refuses_a_parameter_twice():
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="twice"):
        Optimizer([("textual.output.bias", p), ("textual.output.bias", p)])


# -- token cross-entropy ------------------------------------------------------
def _ce_inputs():
    rng = np.random.RandomState(3)
    logits = (3.0 * rng.randn(3, 7, 50)).astype(np.float32)
    targets = rng.randint(1, 50, (3, 7)).astype(np.int32)
    targets[1, 4:] = 0  # padding, ignored
    targets[2, 2:] = 0
    g = np.float32(1.7)
    return logits, targets, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_ce_and_its_gradient_match_jax(dtype):
    logits, targets, g = _ce_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl = jnp.asarray(logits, jdt)
    ref_loss, vjp = jax.vjp(lambda x: jax_ce(x, jnp.asarray(targets), 0), jl)
    (ref_grad,) = vjp(jnp.asarray(g))

    x = torch.from_numpy(logits).to(tdt).requires_grad_()
    loss = token_cross_entropy(x, torch.from_numpy(targets), 0)
    loss.backward(torch.tensor(g))
    assert loss.dtype == torch.float32
    assert x.grad.dtype == tdt  # emitted in the logits' dtype
    ref_loss = float(ref_loss)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    ours = x.grad.float().numpy()
    ref = np.asarray(jnp.asarray(ref_grad, jnp.float32))
    # fp32: softmax − onehot of scale 1/denom; measured ~1e-8. bf16: both
    # round the same fp32 value to 8 bits, one ulp apart at most.
    tol = 1e-6 if dtype == "float32" else 2 ** -8 * float(np.abs(ref).max())
    assert np.max(np.abs(ours - ref)) <= tol
    assert not ours[1, 4:].any() and not ours[2, 2:].any()
