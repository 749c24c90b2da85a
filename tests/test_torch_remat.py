"""The port's training options against its plain step and against the JAX
package on the CPU: rematerialisation (``MODEL.VISUAL.REMAT``,
``MODEL.TEXTUAL.REMAT``, ``virtex_tpu_torch.utils.remat``) and BatchNorm's
"batch" sampler (``MODEL.VISUAL.BN_STAT_STRIDE`` > 1).

- Remat in the port against no remat in the port, dropout 0.1, one
  generator seed, one ``make_train_step`` step of bicaptioning (resnet18
  at 64², L2_H32_A4_F64, fp32): the same loss, gradients and new
  parameters (1e-6; measured bit-equal), BatchNorm buffers and
  ``num_batches_tracked``, and the generator's final state; the decode path
  untouched.
- Remat in the port against remat in ``virtex_tpu``, dropout 0, through the
  bridge, as ``tests/test_remat.py`` sets it up; the split flags.
- The "batch" sampler against ``virtex_tpu``'s ``SubsampledBatchNorm``:
  the forward, the running statistics after 2 steps, and dx, dγ, dβ through
  ``jax.vjp``; the K4 stages are never called.
"""
import dataclasses

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
    torch_batch,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from virtex_tpu.config import Config
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_train_step as jax_train_step
from virtex_tpu.factories import OptimizerFactory
from virtex_tpu.factories import PretrainingModelFactory as JaxModels
from virtex_tpu.modules.normalization import (
    SubsampledBatchNorm as JaxBatchNorm,
)
from virtex_tpu_torch.config import ModelSpec, OptimSpec
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    PretrainingModelFactory,
)
from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
from virtex_tpu_torch.optim.optimizer import build_optimizer
from virtex_tpu_torch.utils import remat as remat_module
from virtex_tpu_torch.utils.weights import state_dict_from_flax

# tests/test_remat.py's model: resnet18, L2_H32_A4_F64, 8 tokens, fp32.
TINY = [
    "MODEL.NAME", "bicaptioning",
    "MODEL.VISUAL.NAME", "torchvision::resnet18",
    "MODEL.VISUAL.FEATURE_SIZE", 512,
    "MODEL.TEXTUAL.NAME", "transdec_postnorm::L2_H32_A4_F64",
    "DATA.VOCAB_SIZE", 40,
    "DATA.MAX_CAPTION_LENGTH", 8,
    "DTYPE", "float32",
]
REMAT = ["MODEL.VISUAL.REMAT", True, "MODEL.TEXTUAL.REMAT", True]
MICRO, IMAGE = 4, 64
# Remat against the plain step, both in the port: the recomputation replays
# the same fp32 operations on the same inputs, so they agree to rounding
# at most (measured bit-equal).
SAME_TOL = 1e-6


def _spec(*overrides) -> ModelSpec:
    return ModelSpec.from_config(Config(override_list=TINY + list(overrides)))


def _batch(accum, seed=0):
    b = caption_batch(MICRO * accum, IMAGE, 8, 40, seed)
    if accum > 1:
        b = {k: v.reshape((accum, MICRO) + v.shape[1:]) for k, v in b.items()}
    return b


def _port_step(spec, state, batch, accum, seed=7):
    """One step of a fresh port model loaded from ``state``; returns the
    metrics, the gradients, the model and the generator."""
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    model.load_state_dict(state, strict=True)
    gen = torch.Generator()
    gen.manual_seed(seed)
    opt = build_optimizer(model.named_parameters(),
                          dataclasses.replace(OptimSpec(), warmup_steps=0))
    grads = {}

    def keep_grads(*_):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    opt.step = (lambda step: lambda: (keep_grads(), step())[1])(opt.step)
    metrics = make_train_step(model, opt, accum, generator=gen)(
        torch_batch(batch))
    return {k: float(v) for k, v in metrics.items()}, grads, model, gen


@pytest.fixture(scope="module")
def drawn_state():
    spec = dataclasses.replace(_spec(), textual_dropout=0.1)
    torch.manual_seed(0)
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            if name.endswith(("running_mean", "bn3.weight", "bn2.weight",
                              "output.bias")):
                t.copy_(torch.from_numpy(
                    0.1 * rng.randn(*t.shape).astype(np.float32)))
    return spec, model.state_dict()


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_step_equals_the_plain_step_with_dropout(drawn_state, accum):
    spec, state = drawn_state
    batch = _batch(accum)
    m1, g1, plain, gen1 = _port_step(spec, state, batch, accum)
    remat_spec = dataclasses.replace(spec, visual_remat=True,
                                     textual_remat=True)
    m2, g2, remat, gen2 = _port_step(remat_spec, state, batch, accum)
    assert remat.visual.cnn.remat and remat.textual.transformer.remat
    assert remat.backward_textual.transformer.remat
    assert set(m1) == set(m2)
    for k in m1:
        assert abs(m1[k] - m2[k]) <= SAME_TOL * abs(m1[k]), k
    assert set(g1) == set(g2) and len(g1) > 0
    for name in g1:
        scale = float(g1[name].abs().max()) + 1e-12
        assert rel_err(g2[name], g1[name], scale) <= SAME_TOL, name
    s1, s2 = plain.state_dict(), remat.state_dict()
    assert list(s1) == list(s2)
    for name in s1:
        if not s1[name].is_floating_point():   # num_batches_tracked
            assert torch.equal(s1[name], s2[name]), name
            assert int(s2[name]) == accum, name
        elif "running_" in name:
            assert torch.equal(s1[name], s2[name]), name
        else:
            scale = float(s1[name].abs().max()) + 1e-12
            assert rel_err(s2[name], s1[name], scale) <= SAME_TOL, name
    assert torch.equal(gen1.get_state(), gen2.get_state())


def test_remat_recomputes_each_block_and_layer_once(drawn_state):
    """Under remat each residual block and decoder layer runs twice per
    micro-step (forward and recomputation), the recomputation on the
    generator's state from before the layer: the dropout masks it draws
    equal the first run's."""
    spec, state = drawn_state
    spec = dataclasses.replace(spec, visual_remat=True, textual_remat=True)
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    model.load_state_dict(state, strict=True)
    calls, masks = {"block": 0, "layer": 0}, []
    model.visual.cnn.layer2[0].register_forward_pre_hook(
        lambda *_: calls.__setitem__("block", calls["block"] + 1))
    model.textual.transformer.layers[1].register_forward_pre_hook(
        lambda *_: calls.__setitem__("layer", calls["layer"] + 1))
    ffn = model.textual.transformer.layers[1].ffn

    def recording_ffn(x, generator=None):
        state = generator.get_state()
        masks.append(torch.rand(8, generator=generator))
        generator.set_state(state)
        return ffn(x, generator)
    model.textual.transformer.layers[1].ffn = recording_ffn
    gen = torch.Generator()
    gen.manual_seed(3)
    opt = build_optimizer(model.named_parameters(), OptimSpec())
    make_train_step(model, opt, generator=gen)(torch_batch(_batch(1)))
    assert calls == {"block": 2, "layer": 2}
    assert len(masks) == 2 and torch.equal(masks[0], masks[1])
    assert all(int(m.num_batches_tracked) == 1 for m in model.modules()
               if isinstance(m, SubsampledBatchNorm))


def test_remat_decode_path_untouched(drawn_state):
    spec, state = drawn_state
    images = torch.from_numpy(_batch(1)["image"])
    tokens = []
    for s in (spec, dataclasses.replace(spec, visual_remat=True,
                                        textual_remat=True)):
        model = PretrainingModelFactory.from_spec(s, device="cpu")
        model.load_state_dict(state, strict=True)
        decoder = CaptionDecoderFactory.from_spec(dataclasses.replace(
            s, beam_size=2, max_decoding_steps=4))
        tokens.append(make_caption_fn(model.eval(), decoder, s.sos_index,
                                      s.prefix_mode)(images))
    assert torch.equal(tokens[0], tokens[1])


# -- against virtex_tpu's remat -----------------------------------------------
@pytest.mark.parametrize("flags", [["VISUAL"], ["TEXTUAL"],
                                   ["VISUAL", "TEXTUAL"]])
def test_split_remat_flags(flags):
    """``MODEL.VISUAL.REMAT`` reaches the ResNet alone and
    ``MODEL.TEXTUAL.REMAT`` both transformers alone, as ``virtex_tpu``
    routes them; the parameter tree is the plain model's."""
    overrides = sum(([f"MODEL.{f}.REMAT", True] for f in flags), [])
    spec = _spec(*overrides)
    assert (spec.visual_remat, spec.textual_remat) == (
        "VISUAL" in flags, "TEXTUAL" in flags)
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    assert model.visual.cnn.remat == ("VISUAL" in flags)
    for head in (model.textual, model.backward_textual):
        assert head.transformer.remat == ("TEXTUAL" in flags)
    calls = {"block": 0}
    model.visual.cnn.layer1[0].register_forward_pre_hook(
        lambda *_: calls.__setitem__("block", calls["block"] + 1))
    out = model.train()(torch_batch(caption_batch(2, IMAGE, 8, 40, 1)),
                        generator=torch.Generator())
    out["loss"].backward()
    assert calls["block"] == (2 if "VISUAL" in flags else 1)
    plain = PretrainingModelFactory.from_spec(_spec(), device="cpu")
    assert list(model.state_dict()) == list(plain.state_dict())


def test_remat_step_matches_jax_remat_through_the_bridge():
    """One step, dropout 0: the port's remat model against
    ``virtex_tpu``'s, from the same weights through the bridge: the JAX
    remat model's tree loads strictly into the port's remat model."""
    cfg = Config(override_list=TINY + REMAT + ["MODEL.TEXTUAL.DROPOUT", 0.0,
                                               "OPTIM.WARMUP_STEPS", 1])
    jm = JaxModels.from_config(cfg)
    batch = _batch(1, seed=2)
    variables = jax_variables(jm, batch, seed=2, output_bias_std=1.0)

    tx = OptimizerFactory.from_config(cfg, variables["params"])
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              tx)
    step = jax_train_step(jm, tx, donate=False, jit=True)
    state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    ref = {k: float(v) for k, v in ref.items()}
    ref_final = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))

    spec = ModelSpec.from_config(cfg)
    assert spec.visual_remat and spec.textual_remat
    model = port_model(spec, variables)
    opt = build_optimizer(model.named_parameters(),
                          OptimSpec.from_config(cfg))
    got = {k: float(v) for k, v in make_train_step(model, opt)(
        torch_batch(batch)).items()}
    assert set(got) == set(ref)
    for k in ("loss", "captioning_forward", "captioning_backward"):
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), k
    # As in tests/test_torch_train_step.py: a ReLU input within fp32 noise
    # of zero may flip between the frameworks at 4 images of 64².
    assert abs(got["grad_norm"] - ref["grad_norm"]) <= 1e-3 * ref["grad_norm"]
    final = model.state_dict()
    assert sorted(final) == sorted(ref_final)
    for name, want in ref_final.items():
        if name.endswith("num_batches_tracked"):
            assert int(final[name]) == 1, name
            continue
        want = want.numpy()
        scale = float(np.abs(want).max()) + 1e-12
        tol = 1e-2 if name.startswith("visual.") else 1e-4
        assert rel_err(final[name], want, scale) <= tol, name


# -- BatchNorm's "batch" sampler ----------------------------------------------
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the sides reduce in other orders (~1e-6 of the scale). bf16: the
# output and dx round to 8 bits on both sides; a rounding apart is 2^-8 of
# the value, held at 1e-2 of the scale.
SAMPLER_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64)


def _bf16_param_grads(x, dy, stride, eps=1e-5):
    """dγ and dβ of the bf16 forward, summed in float64: Σ dy·(x − μ)·rstd
    with (x − μ) rounded to bf16 as the forward rounds it, and Σ dy. JAX's
    own bf16 cotangents are not the reference here: XLA's CPU reduction
    sums the bf16 products in bf16 (measured 3.4% of the scale off this
    float64 sum at B 32, C 16, where the port is 1e-5 off)."""
    xb, dyb = _bf16(x), _bf16(dy)
    div = max(1, min(stride, x.shape[0] // 8))
    sample = xb[: x.shape[0] // div].reshape(-1, x.shape[-1])
    mean = sample.mean(0)
    var = np.maximum((sample ** 2).mean(0) - mean ** 2, 0.0)
    rstd = 1.0 / np.sqrt(var + eps)
    centred = _bf16(xb - _bf16(mean))
    axes = (0, 1, 2)
    return (dyb * centred).sum(axes) * rstd, dyb.sum(axes)


def _no_k4(*_):
    raise AssertionError("the batch sampler's backward called a K4 stage")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,stride", [(32, 2), (32, 4), (12, 4)])
def test_batch_sampler_matches_jax(batch, stride, dtype):
    """B 32 at stride 2 and 4 (samples of 16 and 8 images), and B 12, where
    ``div`` is 1 and the statistics are the whole batch's."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(stride + batch)
    C = 16
    xs = [(2.0 * rng.randn(batch, 5, 6, C) + 0.5).astype(np.float32)
          for _ in range(2)]
    dy = rng.randn(batch, 5, 6, C).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    mean = (0.1 * rng.randn(C)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, C).astype(np.float32)

    jbn = JaxBatchNorm(momentum=0.9, epsilon=1e-5, dtype=jdt,
                       stat_stride=stride)

    def f(x, s, b, stats):
        return jbn.apply({"params": {"scale": s, "bias": b},
                          "batch_stats": stats}, x, mutable=["batch_stats"])
    _, upd = f(jnp.asarray(xs[0], jdt), scale, bias,
               {"mean": mean, "var": var})
    y_ref, vjp, upd = jax.vjp(
        lambda x, s, b: f(x, s, b, upd["batch_stats"]),
        jnp.asarray(xs[1], jdt), scale, bias, has_aux=True)
    stats = upd["batch_stats"]
    dx_ref, ds_ref, db_ref = vjp(jnp.asarray(dy, y_ref.dtype))
    if dtype == "bfloat16":
        ds_ref, db_ref = _bf16_param_grads(xs[1], dy, stride)

    bn = SubsampledBatchNorm(C, momentum=0.9, eps=1e-5, dtype=tdt,
                             stat_stride=stride)
    bn.sums_fn = bn.dx_fn = _no_k4
    bn.load_state_dict({
        "weight": torch.tensor(scale), "bias": torch.tensor(bias),
        "running_mean": torch.tensor(mean), "running_var": torch.tensor(var),
        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    for x in xs:
        xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
        xt.requires_grad_(True)
        y = bn(xt)
    assert int(bn.num_batches_tracked) == 2
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        assert rel_err(getattr(bn, ours), stats[theirs], 1e-3) <= 1e-5, ours
    y.permute(0, 2, 3, 1).backward(torch.from_numpy(dy).to(tdt))
    tol = SAMPLER_TOL[dtype]
    for got, want in ((y.permute(0, 2, 3, 1), y_ref),
                      (xt.grad.permute(0, 2, 3, 1), dx_ref),
                      (bn.weight.grad, ds_ref), (bn.bias.grad, db_ref)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert rel_err(got.float(), want, float(np.abs(want).max())) <= tol


def test_batch_sampler_gradient_flows_through_the_sample_only():
    """dx of the images outside the sample carries no statistics term:
    there it is dy·γ·rstd, the affine map's gradient alone."""
    rng = np.random.RandomState(4)
    C = 8
    bn = SubsampledBatchNorm(C, stat_stride=4).train()
    x = torch.from_numpy(rng.randn(32, C, 3, 3).astype(np.float32))
    x.requires_grad_(True)
    dy = torch.from_numpy(rng.randn(32, C, 3, 3).astype(np.float32))
    bn(x).backward(dy)
    sample = x[:8].detach()
    var = (sample.square().mean((0, 2, 3))
           - sample.mean((0, 2, 3)).square())
    rstd = 1.0 / torch.sqrt(var + bn.eps)
    want = dy[8:] * (bn.weight * rstd).detach()[None, :, None, None]
    assert rel_err(x.grad[8:], want, 1.0) <= 1e-6
    assert rel_err(x.grad[:8], dy[:8] * rstd[None, :, None, None], 1.0) > 1e-3


def test_batch_sampler_updates_running_statistics_once_under_remat():
    bn = SubsampledBatchNorm(8, stat_stride=2).train()
    x = torch.randn(16, 8, 2, 2, requires_grad=True)
    remat_module.remat(bn, x).sum().backward()
    assert int(bn.num_batches_tracked) == 1
    twin = SubsampledBatchNorm(8, stat_stride=2).train()
    twin(x.detach())
    assert torch.equal(bn.running_var, twin.running_var)


@pytest.mark.parametrize("batch, stride, sampled", [(32, 4, 8), (24, 8, 8)])
def test_batch_sampler_takes_the_first_images(batch, stride, sampled):
    """The statistics are those of the first ``B // div`` images, ``div =
    max(1, min(stride, B // 8))`` (whole images, not the "rows" sample)."""
    bn = SubsampledBatchNorm(8, momentum=0.0, stat_stride=stride).train()
    x = torch.randn(batch, 8, 3, 3, generator=torch.Generator().manual_seed(5))
    bn(x)
    sample = x[:sampled]
    n = sample.numel() // 8
    assert torch.allclose(bn.running_mean, sample.mean((0, 2, 3)),
                          rtol=1e-6, atol=1e-7)
    assert torch.allclose(bn.running_var,
                          sample.var((0, 2, 3), unbiased=False) * n / (n - 1),
                          rtol=1e-5, atol=1e-7)


def test_resnet_at_stat_stride_runs_the_sampler_in_every_layer():
    spec = _spec("MODEL.VISUAL.BN_STAT_STRIDE", 4)
    assert spec.bn_stat_stride == 4
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    bns = [m for m in model.modules() if isinstance(m, SubsampledBatchNorm)]
    assert len(bns) == 20 and all(m.stat_stride == 4 for m in bns)
    for m in bns:
        m.sums_fn = m.dx_fn = _no_k4
    out = model.train()(torch_batch(caption_batch(16, IMAGE, 8, 40, 3)),
                        generator=torch.Generator())
    out["loss"].backward()
    assert np.isfinite(float(out["loss"].detach()))
    assert all(int(m.num_batches_tracked) == 1 for m in bns)
    assert all(torch.isfinite(m.running_var).all() for m in bns)
