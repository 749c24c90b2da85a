"""The latent-attention, routed-expert captioning head
(``virtex_tpu_torch/modules/latent_moe.py``, ``textual_heads.py
LatentMoETextualHead``, ``ops/moe.py``) against the plain fp32 reference
of ``tests/latent_moe_reference.py``, at the ``tiny`` preset on the CPU.

Tolerances: the head and the reference compute the same fp32 products in
other orders (SDPA or the absorbed scores against explicit per-head keys;
the dense expert loop against a per-token sum), so they agree to fp32
round-off over a few layers: 1e-4 of the logits' scale. The router's
choice is compared exactly (the scores are continuous, so ties have
probability zero) and its weights to 1e-6. Beam search is compared token
for token on logits spread wide enough (the LM head scaled ×50) that no
two candidates lie within round-off of each other.

Cases marked ``cuda`` hold the grouped expert launches to the plain loop
in bf16 and the graphed caption call to the eager one on the card; they
skip elsewhere (``python -m pytest tests/test_torch_latent_moe.py -m cuda
--noconftest`` there).
"""
import importlib.util
import os
import types

import pytest
import torch

from portbench.reference import beam
from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    PretrainingModelFactory,
)
from virtex_tpu_torch.modules import latent_moe as M
from virtex_tpu_torch.modules.textual_heads import LatentMoETextualHead
from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import moe
from virtex_tpu_torch.parallel.mesh import shard_module_


def _sibling(name: str):
    """A module of this directory, by its path (the name ``tests`` may be
    another package's where this file runs)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        name + ".py")
    spec = importlib.util.spec_from_file_location("_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _sibling("latent_moe_reference")
StubGraph = _sibling("test_torch_decode_graph").StubGraph
DIMS = M.PRESETS["tiny"]
LAYERS, C, VOCAB, T, BEAMS = 3, 24, DIMS.vocab_size, 6, 3
SIZES = {**{f: float(getattr(DIMS, f)) for f in DIMS.__dataclass_fields__},
         "layers": LAYERS}
TOL = 1e-4


def _perturb(module: torch.nn.Module, seed: int = 0) -> None:
    """Norm scales around 1, biases and the router's correction bias
    drawn, so that each of them matters."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                base = 1.0 if "norm" in name and name.endswith("weight") \
                    else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))


def _head(dtype=torch.float32) -> LatentMoETextualHead:
    torch.manual_seed(0)
    head = LatentMoETextualHead(C, VOCAB, DIMS, LAYERS, T, dtype)
    _perturb(head)
    return head.eval()


def _state(head):
    return {n: p.detach() for n, p in head.named_parameters()}


def _grid(B=2, seed=1):
    return torch.randn(B, 2, 2, C, generator=torch.Generator().manual_seed(
        seed))


def _tokens(B=2, seed=2):
    return torch.randint(3, VOCAB, (B, T),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want, tol=TOL):
    scale = want.abs().max()
    assert (got - want).abs().max() <= tol * scale, \
        float((got - want).abs().max() / scale)


def test_teacher_forced_logits_equal_the_reference():
    head, grid, tokens = _head(), _grid(), _tokens()
    with torch.no_grad():
        got = head(grid, tokens, None)
    assert got.shape == (2, T, VOCAB)
    _close(got, ref.logits(_state(head), SIZES, grid, tokens))


def test_prefill_and_absorbed_decode_equal_the_full_forward():
    head, grid, tokens = _head(), _grid(), _tokens()
    want = ref.logits(_state(head), SIZES, grid, tokens)
    with torch.no_grad():
        caches = head.init_decode(grid, T)
        assert [tuple(c["prefix"].shape) for c in caches] == \
            [(2, 4, DIMS.latent_dim)] * LAYERS
        for t in range(T):
            got, caches = head.decode_step(tokens[:, t], t, caches)
            _close(got, want[:, t])


def test_the_prefix_serves_each_images_rows():
    """Two rows an image, each its own generated tokens: the per-image
    prefix read for both rows equals each row's own full forward."""
    head, grid, tokens = _head(), _grid(), _tokens(4, seed=3)
    with torch.no_grad():
        caches = head.init_decode(grid, T)
        caches = [{"prefix": c["prefix"],
                   "generated": c["generated"].repeat_interleave(2, 0)}
                  for c in caches]
        for t in range(T):
            got, caches = head.decode_step(tokens[:, t], t, caches)
    want = ref.logits(_state(head), SIZES, grid.repeat_interleave(2, 0),
                      tokens)[:, -1]
    _close(got, want)


def test_router_selection_and_weights_equal():
    head = _head()
    W = _state(head)
    y = torch.randn(50, DIMS.hidden_size,
                    generator=torch.Generator().manual_seed(4))
    p = "decoder.layers.1.mlp."
    choice, weights = M.route(W, p, y, DIMS)
    want_choice, want_weights = ref.route(W, p, y, SIZES)
    assert torch.equal(choice, want_choice)
    torch.testing.assert_close(weights, want_weights, rtol=1e-6, atol=1e-6)
    assert torch.allclose(weights.sum(-1), torch.full((50,), 2.446))


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_grouped_dispatch_equals_the_dense_loop(rows):
    g = torch.Generator().manual_seed(rows)
    E, H, Fw, k = 8, 16, 12, 3
    x = torch.randn(rows, H, generator=g)
    gate_up = torch.randn(E, 2 * Fw, H, generator=g) * 0.3
    down = torch.randn(E, H, Fw, generator=g) * 0.3
    # experts 0 and 5 never chosen: empty groups
    allowed = torch.tensor([1, 2, 3, 4, 6, 7])
    choice = allowed[torch.stack([torch.randperm(6, generator=g)[:k]
                                  for _ in range(rows)])]
    weights = torch.rand(rows, k, generator=g)
    order, ends = moe.dispatch(choice, E)
    assert ends.dtype == torch.int32 and int(ends[-1]) == rows * k
    assert torch.equal(choice.reshape(-1)[order],
                       choice.reshape(-1).sort(stable=True).values)
    got = moe.grouped_experts(x, choice, weights, gate_up, down)
    want = moe.looped_experts(x, choice, weights, gate_up, down)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _config(dtype="float32", **over):
    items = {
        "MODEL.NAME": "captioning",
        "MODEL.VISUAL.NAME": "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE": 512,
        "MODEL.TEXTUAL.NAME": f"moe_mla::tiny_L{LAYERS}",
        "MODEL.DECODER.BEAM_SIZE": BEAMS,
        "MODEL.DECODER.PREFIX_MODE": "sos",
        "DATA.VOCAB_SIZE": VOCAB, "DATA.MAX_CAPTION_LENGTH": T,
        "DATA.IMAGE_CROP_SIZE": 64, "DTYPE": dtype, **over}
    return Config(None, [v for kv in items.items() for v in kv])


def _model(dtype="float32"):
    torch.manual_seed(0)
    model = PretrainingModelFactory.from_config(_config(dtype), "cpu")
    _perturb(model.textual)
    with torch.no_grad():  # wide logits: no near-ties in the search
        model.textual.lm_head.weight.mul_(50.0)
    return model.eval()


def _caption_fn(model, graph_type=None, dtype="float32"):
    spec = ModelSpec.from_config(_config(dtype))
    fn = make_caption_fn(model, CaptionDecoderFactory.from_spec(spec),
                         spec.sos_index, spec.prefix_mode)
    fn.decode_graphs.graph_type = graph_type
    return fn


def _images(B=2, seed=5):
    return torch.rand(B, 64, 64, 3,
                      generator=torch.Generator().manual_seed(seed))


def test_beam_captions_equal_the_reference_search():
    model, images = _model(), _images()
    got = _caption_fn(model)(images)
    W = _state(model.textual)
    with torch.no_grad():
        grid = model.visual(images).repeat_interleave(BEAMS, 0)
    calls = []

    def next_fn(tokens):  # beam.py drops the start token after step 0
        sos = torch.ones_like(tokens[:, :1])
        seq = sos if not calls else torch.cat((sos, tokens), 1)
        calls.append(1)
        with torch.no_grad():
            return torch.log_softmax(ref.logits(W, SIZES, grid, seq)[:, -1],
                                     -1)
    want = beam.beam_search(next_fn, 2, BEAMS, T, 1, 2, "cpu")
    assert torch.equal(got, want)


def test_a_changed_weight_is_read_by_the_next_graphed_call():
    model, images = _model("bfloat16"), _images()
    fn = _caption_fn(model, StubGraph, "bfloat16")
    L.reset()
    fn(images)
    fn(images)                          # captures, then replays
    assert L.snapshot()[("decode_graph", "replay")] == T
    with torch.no_grad():
        model.textual.lm_head.weight.neg_()
    got = fn(images)
    assert L.snapshot()[("decode_graph", "replay")] == 2 * T
    want = _caption_fn(model, None, "bfloat16")(images)
    assert torch.equal(got, want)


def test_the_decode_copies_are_cast_once_and_refreshed_in_place():
    head = _head(torch.bfloat16)
    with head.decoding():
        W = head._weights()
    assert W is head._decode_weights
    name = "decoder.layers.1.self_attn.q_proj"
    assert W[name].dtype == torch.bfloat16
    assert W["decoder.layers.1.mlp.gate.weight"].dtype == torch.float32
    assert W["embed_tokens.weight"].dtype == torch.float32
    with torch.no_grad():
        dict(head.named_parameters())[name].add_(1.0)
    with head.decoding():               # outside a caption call too
        assert head._weights()[name] is W[name]
    torch.testing.assert_close(
        W[name].float(), dict(head.named_parameters())[name].detach(),
        rtol=1e-2, atol=1e-2)


def test_outside_a_caption_call_the_head_reads_its_parameters():
    model, images = _model("bfloat16"), _images()
    fn = _caption_fn(model, None, "bfloat16")
    fn(images)                          # leaves the call's copies behind
    head = model.textual
    name = "decoder.layers.1.self_attn.q_proj"
    with torch.no_grad():
        dict(head.named_parameters())[name].neg_()
    kept = head._decode_weights[name]
    read = head._weights()[name]
    assert read is not kept
    torch.testing.assert_close(
        read.float(), dict(head.named_parameters())[name].detach(),
        rtol=1e-2, atol=1e-2)


def test_each_head_names_the_searches_it_serves():
    model = _model()
    assert model.textual.searches == ("beam search",)
    for name in ("nucleus_sampling", "beam_search"):
        spec = ModelSpec.from_config(_config(**{"MODEL.DECODER.NAME": name}))
        decoder = CaptionDecoderFactory.from_spec(spec)
        if name == "beam_search":
            make_caption_fn(model.eval(), decoder, spec.sos_index,
                            spec.prefix_mode)
        else:
            with pytest.raises(ValueError, match="nucleus sampling with it"):
                make_caption_fn(model.eval(), decoder, spec.sos_index,
                                spec.prefix_mode)


def test_record_routing_hands_over_each_routed_layers_choice():
    model, images = _model(), _images()
    fn = _caption_fn(model)
    with M.record_routing() as log:
        fn(images)
    routed = LAYERS - DIMS.first_k_dense_replace
    # the prefill leaves out the last layer's FFN; then every step
    assert len(log) == routed - 1 + routed * T
    assert log[0].shape == (2 * 4, DIMS.num_experts_per_tok)  # 2 × 2×2 grid
    assert log[-1].shape == (2 * BEAMS, DIMS.num_experts_per_tok)
    fn(images)
    assert len(log) == routed - 1 + routed * T   # closed with the block


def test_out_of_scope_uses_refuse():
    model = _model()
    model.train()
    batch = {"image": _images(), "caption_tokens": _tokens(),
             "caption_lengths": torch.full((2,), T)}
    with pytest.raises(NotImplementedError, match="inference only"):
        model(batch)
    for name in ("bicaptioning", "virtex", "masked_lm"):
        with pytest.raises(ValueError, match="captioning only"):
            PretrainingModelFactory.from_config(
                _config(**{"MODEL.NAME": name}), "cpu")
    with pytest.raises(ValueError, match="no tensor parallel form"):
        shard_module_(model, types.SimpleNamespace(model=2))
    spec = ModelSpec.from_config(_config(**{
        "MODEL.DECODER.NAME": "nucleus_sampling"}))
    with pytest.raises(ValueError, match="beam search only"):
        make_caption_fn(model.eval(), CaptionDecoderFactory.from_spec(spec),
                        spec.sos_index, spec.prefix_mode)


@pytest.mark.parametrize("name, error", [
    ("moe_mla::nope_L3", KeyError), ("moe_mla::tiny_L5", ValueError),
    ("moe_mla::kimi_vl_a3b_L0", ValueError)])
def test_the_name_grammar_refuses_what_the_table_lacks(name, error):
    with pytest.raises(error):
        M.parse_name(name)


def test_the_published_table_and_the_depth():
    dims, layers = M.parse_name("moe_mla::kimi_vl_a3b_L9")
    assert layers == 9 and dims.num_hidden_layers == 27
    assert (dims.hidden_size, dims.kv_lora_rank, dims.latent_dim,
            dims.n_routed_experts, dims.num_experts_per_tok,
            dims.moe_intermediate_size, dims.vocab_size) == (
        2048, 512, 576, 64, 6, 1408, 163840)
    decoder = M.LatentMoEDecoder(M.PRESETS["tiny"], 3)
    assert [layer.dense for layer in decoder.layers] == [True, False, False]


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (grouped GEMMs and CUDA graphs)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 1280])
def test_grouped_launches_equal_the_loop_in_bf16_on_card(cuda, rows):
    g = torch.Generator(device="cuda").manual_seed(rows)
    E, H, Fw, k = 64, 2048, 1408, 6
    x = torch.randn(rows, H, generator=g, device=cuda).bfloat16()
    gate_up = (torch.randn(E, 2 * Fw, H, generator=g, device=cuda)
               * 0.02).bfloat16()
    down = (torch.randn(E, H, Fw, generator=g, device=cuda) * 0.02).bfloat16()
    choice = torch.rand(rows, E, generator=g, device=cuda).topk(k).indices
    weights = torch.rand(rows, k, generator=g, device=cuda)
    L.reset()
    got = moe.routed_experts(x, choice, weights, gate_up, down)
    assert L.snapshot()[moe.KEY] == 2
    want = moe.looped_experts(x, choice, weights, gate_up, down)
    # bf16 products in two orders: a few bf16 roundings of the output
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * float(want.float().abs().max()))


@pytest.mark.cuda
def test_graphed_captions_equal_the_eager_ones_on_card(cuda):
    torch.manual_seed(0)
    model = PretrainingModelFactory.from_config(_config("bfloat16"),
                                                cuda).eval()
    _perturb(model.textual)
    with torch.no_grad():
        model.textual.lm_head.weight.mul_(50.0)
    images = _images(4).to(cuda)
    fn = _caption_fn(model, None, "bfloat16")
    L.reset()
    # the first call eager, the second captures and replays, the third
    # replays
    got = [fn(images).clone() for _ in range(3)]
    counts = L.snapshot()
    assert counts[("decode_graph", "capture")] == T
    assert counts[("decode_graph", "replay")] == 2 * T
    routed = LAYERS - DIMS.first_k_dense_replace
    # two grouped launches per routed layer and step, and in the prefill,
    # which leaves out the last layer's FFN
    assert counts[moe.KEY] == 3 * 2 * (routed * T + routed - 1)
    for later in got[1:]:
        assert torch.equal(later, got[0])
