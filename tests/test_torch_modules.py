"""The port's modules (virtex_tpu_torch.modules) against the JAX package's
on the CPU, on the same numpy inputs.

BatchNorm takes its parameters and statistics as numpy inputs handed to both
sides. The ResNet and the textual head are initialised by flax, redrawn
from a numpy seed where flax's init is a constant, and reach the port
through ``state_dict_from_flax``. Every comparison is
|a − b| / (|ref| + atol) with its bound stated.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import redraw, rel_err
from virtex_tpu.modules.normalization import (
    SubsampledBatchNorm as JaxBatchNorm,
)
from virtex_tpu.modules.textual_heads import (
    TransformerTextualHead as JaxTextualHead,
)
from virtex_tpu.modules.transformer import (
    make_self_attention_mask as jax_self_mask,
)
from virtex_tpu.modules.visual_backbones import (
    ResNetVisualBackbone as JaxVisual,
)
from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
from virtex_tpu_torch.modules.textual_heads import TransformerTextualHead
from virtex_tpu_torch.modules.transformer import make_self_attention_mask
from virtex_tpu_torch.modules.visual_backbones import ResNetVisualBackbone
from virtex_tpu_torch.utils.weights import state_dict_from_flax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the two sides reduce in other orders; measured errors are ~1e-6 of
# the scale. bf16: the output is rounded to 8 bits on both sides, so one
# rounding apart is 2^-8 relative.
TOL = {"float32": 1e-4, "bfloat16": 2 ** -7}


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


# -- BatchNorm ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_jax(dtype, train):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    C = 16
    x = (2.0 * rng.randn(4, 5, 6, C) + 0.5).astype(np.float32)   # NHWC
    scale, bias = 1 + 0.2 * rng.randn(C), 0.1 * rng.randn(C)
    mean, var = 0.1 * rng.randn(C), rng.uniform(0.5, 1.5, C)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731

    jbn = JaxBatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    y_ref, upd = jbn.apply(
        {"params": {"scale": f32(scale), "bias": f32(bias)},
         "batch_stats": {"mean": f32(mean), "var": f32(var)}},
        jnp.asarray(x, jdt), mutable=["batch_stats"])

    bn = SubsampledBatchNorm(C, momentum=0.9, eps=1e-5, dtype=tdt)
    bn.load_state_dict({
        "weight": torch.tensor(f32(scale)), "bias": torch.tensor(f32(bias)),
        "running_mean": torch.tensor(f32(mean)),
        "running_var": torch.tensor(f32(var)),
        "num_batches_tracked": torch.tensor(0)})
    bn.train(train)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)   # NCHW view
    y = bn(xt).permute(0, 2, 3, 1)
    assert y.dtype == tdt
    assert rel_err(y.float(), np.asarray(y_ref, np.float32), 1.0) \
        <= TOL[dtype]
    # Running statistics after one call: momentum 0.9 (torch's 0.1) and,
    # in train mode, the Bessel-corrected variance (n = 4·5·6 = 120).
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        assert rel_err(getattr(bn, ours), upd["batch_stats"][theirs],
                       1e-3) <= 1e-5
    assert int(bn.num_batches_tracked) == int(train)
    if train:
        xf = x.reshape(-1, C).astype(np.float64)
        if dtype == "bfloat16":
            xf = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float64
                            ).reshape(-1, C)
        unbiased = xf.var(0) * 120 / 119
        assert rel_err(bn.running_var, 0.9 * var + 0.1 * unbiased,
                       1e-3) <= 1e-5


def test_batchnorm_samples_statistics_at_stride():
    """``stat_stride`` 2 at B 16 runs the "batch" sampler (held against the
    JAX package in tests/test_torch_remat.py): the statistics of the first
    8 images, plain autograd, no K4 stage."""
    def no_k4(*_):
        raise AssertionError("the sampler's backward launched a K4 stage")

    bn = SubsampledBatchNorm(8, stat_stride=2).train()
    bn.sums_fn = bn.dx_fn = no_k4
    x = torch.randn(16, 8, 2, 2, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    bn(x).square().sum().backward()
    assert int(bn.num_batches_tracked) == 1
    assert torch.allclose(bn.running_mean,
                          0.1 * x[:8].detach().mean((0, 2, 3)), atol=1e-7)
    assert torch.isfinite(x.grad).all()


# -- ResNet-50 trunk through the visual backbone ---------------------------
@pytest.fixture(scope="module")
def resnet50():
    """JAX and port ResNet-50 backbones with the same weights; B=2 at 64²."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    jm = JaxVisual("resnet50", dtype=jnp.float32)
    init = jax.jit(lambda key, x: jm.init(key, x, train=False))
    v = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(1), x)))
    v = redraw(v, np.random.RandomState(1))
    port = ResNetVisualBackbone("resnet50", dtype=torch.float32)
    state = state_dict_from_flax({"params": {"visual": v["params"]},
                                  "batch_stats": {"visual": v["batch_stats"]}})
    port.load_state_dict(_sub(state, "visual."), strict=True)
    return jm, v, port, x


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_grid_matches_jax(resnet50, train):
    jm, v, port, x = resnet50
    port = copy.deepcopy(port)  # train mode updates the running statistics
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=train,
                                          mutable=["batch_stats"]))
    ref, upd = apply(v, x)
    port.train(train)
    grid = port(torch.from_numpy(x))
    assert tuple(grid.shape) == (2, 2, 2, 2048)     # NHWC layer4 grid
    # atol is the grid's own scale (max |ref|, ~700 in eval). fp32 conv
    # sums differ in order; measured 2e-6 of the scale in eval. Train-mode
    # BN renormalises every layer over a 2-image batch (8 values per
    # channel at layer4), which amplifies those differences ~50x (measured
    # 8e-4): a 1e-6 input perturbation moves the train-mode grid 3e-5.
    ref = np.asarray(ref)
    tol = 2e-3 if train else 1e-5
    assert rel_err(grid, ref, np.abs(ref).max()) <= tol
    if train:
        stats = upd["batch_stats"]["cnn"]
        assert rel_err(port.cnn.layer4[2].bn3.running_var.detach(),
                       stats["layer4_2"]["bn3"]["var"], 1e-3) <= 1e-4
        assert rel_err(port.cnn.bn1.running_mean.detach(),
                       stats["bn1"]["mean"], 1e-3) <= 1e-4


def test_uint8_images_are_normalised_as_in_jax(resnet50):
    jm, v, port, _ = resnet50
    img = np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3), np.uint8)
    ref = jm.apply(v, jnp.asarray(img), train=False)
    grid = port.eval()(torch.from_numpy(img))
    ref = np.asarray(ref)
    assert rel_err(grid, ref, np.abs(ref).max()) <= 1e-5


def test_resnet_refuses_tpu_layout_and_remat():
    """STEM_S2D is a TPU layout and raises; remat is ported
    (tests/test_torch_remat.py)."""
    with pytest.raises(NotImplementedError, match="STEM_S2D"):
        ResNetVisualBackbone("resnet18", stem_s2d=True)


# -- embedding, decoder layers, textual head --------------------------------
V, C, H, A, F, L, T = 50, 16, 32, 4, 64, 2, 8


def _tokens(seed):
    rng = np.random.RandomState(seed)
    lengths = np.array([T, 5, 3], np.int32)
    tokens = np.zeros((3, T), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = np.concatenate([[1], rng.randint(4, V, n - 2), [2]])
    return tokens, lengths


@pytest.fixture(scope="module", params=["post", "pre"])
def heads(request):
    """Bidirectional JAX textual head and the port's forward and backward
    heads with the same weights."""
    norm = request.param
    jh = JaxTextualHead(visual_feature_size=C, vocab_size=V, hidden_size=H,
                        num_layers=L, attention_heads=A, feedforward_size=F,
                        dropout=0.1, norm_type=norm, max_caption_length=T,
                        bidirectional=True, dtype=jnp.float32)
    rng = np.random.RandomState(3)
    grid = rng.randn(3, 2, 2, C).astype(np.float32)
    tokens, lengths = _tokens(3)
    variables = jh.init(jax.random.PRNGKey(3), grid, tokens, lengths)
    params = redraw(jax.tree.map(np.asarray, dict(variables["params"])), rng)
    params["output_bias"] = (0.1 * rng.randn(V)).astype(np.float32)
    state = state_dict_from_flax({"params": {"textual": params}})
    fwd = TransformerTextualHead(C, V, H, L, A, F, dropout=0.1,
                                 norm_type=norm, max_caption_length=T,
                                 dtype=torch.float32)
    bwd = fwd.backward_head()
    fwd.load_state_dict(_sub(state, "textual."), strict=True)
    bwd.load_state_dict(_sub(state, "backward_textual."), strict=True)
    fwd.eval(), bwd.eval()
    return jh.bind({"params": params}), fwd, bwd, grid


def test_embedding_with_position_offset(heads):
    jh, fwd, _, _ = heads
    tokens, _ = _tokens(4)
    for offset in (0, 3):
        ref = jh.embedding(jnp.asarray(tokens[:, :4]), deterministic=True,
                           position_offset=offset)
        ours = fwd.embedding(torch.from_numpy(tokens[:, :4]), offset)
        assert rel_err(ours.detach(), np.asarray(ref), 1e-2) <= 1e-4
    # pad positions are exactly zero
    assert float(ours[2, 3:].detach().abs().max()) == 0.0


def test_decoder_layer_matches_jax(heads):
    jh, fwd, _, _ = heads
    rng = np.random.RandomState(5)
    x = rng.randn(3, T, H).astype(np.float32)
    visual = rng.randn(3, 4, H).astype(np.float32)
    tokens, lengths = _tokens(5)
    jmask = jax_self_mask(jnp.asarray(tokens), jnp.asarray(lengths), True)
    mask = make_self_attention_mask(torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), True)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    ref = jh.transformer.layers[0](x, visual, jmask, True)
    ours = fwd.transformer.layers[0](torch.from_numpy(x),
                                     torch.from_numpy(visual), mask)
    assert rel_err(ours.detach(), np.asarray(ref), 1.0) <= 1e-4


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_textual_head_matches_jax(heads, direction):
    jh, fwd, bwd, grid = heads
    tokens, lengths = _tokens(6)
    if direction == "backward":
        tokens = np.stack([np.concatenate([t[:n][::-1], t[n:]])
                           for t, n in zip(tokens, lengths)])
    ref = jh(grid, tokens, lengths, True, backward=direction == "backward")
    head = fwd if direction == "forward" else bwd
    ours = head(torch.from_numpy(grid), torch.from_numpy(tokens),
                torch.from_numpy(lengths))
    assert ours.shape == (3, T, V)
    # logits are O(1) (tied output over LayerNormed features)
    assert rel_err(ours.detach(), np.asarray(ref), 1.0) <= 1e-4


def test_backward_head_shares_projection_embedding_and_output(heads):
    _, fwd, bwd, _ = heads
    assert bwd.embedding is fwd.embedding
    assert bwd.visual_projection is fwd.visual_projection
    assert bwd.output is fwd.output
    assert bwd.output.weight is fwd.embedding.words.weight
    assert bwd.transformer is not fwd.transformer
