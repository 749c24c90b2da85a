"""The caption loop's decode steps as CUDA graph replays
(``virtex_tpu_torch.engine.captioner.DecodeGraphs``).

On the CPU, through :class:`StubGraph` in place of ``torch.cuda.CUDAGraph``:
its capture runs the step and records every aten op with the tensors it
took, and its replay runs the recorded ops again on those tensors, so that,
as on the card, a replay reads its inputs where they lay at capture and
writes its outputs there. The runner's rule: a shape's first call runs
eagerly, its later calls capture each step once and replay it; the last
two shapes keep their graphs; a recording profiler captures nothing; a
state that does not lie where the graph's did runs eagerly. Replays give
the eager path's captions, and count and note the decode attention's
launches as the eager path does. With no stand-in the CPU never captures.

Cases marked ``cuda`` hold the real graphs to the eager path on the card:
the caption cell's shapes (H2048, B 256, beam 5, 30 steps) and B 3, nucleus
sampling with one generator seed, a second shape and a return to the
first, and the decode attention's launches and notes per batch. Run there
with ``python -m pytest tests/test_torch_decode_graph.py -m cuda
--noconftest``; they skip elsewhere (CUDA graphs need a card).
"""
import dataclasses
import gc
import os
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.engine import captioner as C
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.factories import (
    CaptionDecoderFactory,
    PretrainingModelFactory,
)
from virtex_tpu_torch.modules.transformer import MultiHeadAttention
from virtex_tpu_torch.ops import _launch as L
from virtex_tpu_torch.ops import decode_attention as DA
from virtex_tpu_torch.utils import tracing

IMAGE, T, VOCAB, EOS, BEAMS = 64, 8, 50, 2, 2


# -- a CUDA graph's semantics on the CPU --------------------------------------
class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a host sync inside a captured step")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class StubGraph:
    """``torch.cuda.CUDAGraph``'s interface over :class:`_Recorder`."""

    def __init__(self):
        self.ops, self.mode, self.handle = [], None, None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.handle = pool if pool is not None else object()
        self.mode = _Recorder(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)

    def pool(self):
        return self.handle

    def replay(self):
        new = {}  # id of a captured op's output → its value at this replay

        def now(x):
            return new.get(id(x), x) if torch.is_tensor(x) else x

        for func, args, kwargs, out in self.ops:
            got = func(*pytree.tree_map(now, args),
                       **pytree.tree_map(now, kwargs))
            for o, g in zip(pytree.tree_leaves(out), pytree.tree_leaves(got)):
                if torch.is_tensor(o):
                    new[id(o)] = g
        for _, args, kwargs, out in self.ops:
            own = {id(x) for x in pytree.tree_leaves((args, kwargs))}
            for o in pytree.tree_leaves(out):
                # the capture's fresh tensors (the graph's pool), not an
                # in-place op's operand or a view
                if torch.is_tensor(o) and id(o) not in own \
                        and not o._is_view():
                    o.copy_(new[id(o)])


def _config(decoder: str) -> Config:
    return Config(None, [
        "MODEL.VISUAL.NAME", "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H32_A2_F64",
        "MODEL.TEXTUAL.DROPOUT", 0.0,
        "MODEL.DECODER.NAME", decoder, "MODEL.DECODER.BEAM_SIZE", BEAMS,
        "DATA.VOCAB_SIZE", VOCAB, "DATA.MAX_CAPTION_LENGTH", T,
        "DATA.IMAGE_CROP_SIZE", IMAGE, "DTYPE", "float32"])


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = PretrainingModelFactory.from_config(_config("beam_search"), "cpu")
    with torch.no_grad():  # a peaked output; EOS never wins: T steps a call
        m.textual.output.bias.copy_(torch.randn(VOCAB) * 2.0)
        m.textual.output.bias[EOS] = -1e4
    return m.eval()


@pytest.fixture(autouse=True)
def fresh_counts():
    L.reset()
    yield


def _images(batch: int, seed: int = 1):
    return torch.rand(batch, IMAGE, IMAGE, 3,
                      generator=torch.Generator().manual_seed(seed))


def _caption_fn(model, decoder: str = "beam_search", graph_type=StubGraph):
    """A caption function returning its beams and scores (beam search) or
    its tokens (nucleus sampling, drawn from seed 5)."""
    spec = ModelSpec.from_config(_config(decoder))
    dec = CaptionDecoderFactory.from_spec(spec)
    fn = make_caption_fn(model, dec, spec.sos_index, spec.prefix_mode)
    fn.decode_graphs.graph_type = graph_type
    if decoder == "nucleus_sampling":
        return lambda images: fn(images, torch.Generator().manual_seed(5))
    search, result = dec.search, {}

    def every_beam(start, step_fn, state):
        if not call.spare:
            step_fn = lambda *a, step=step_fn: step(*a)  # noqa: E731
        result["beams"] = search(start, step_fn, state,
                                 only_return_best=False)
        return result["beams"]
    dec.search = every_beam

    def call(images):
        fn(images)
        return result["beams"]
    call.decode_graphs, call.spare = fn.decode_graphs, True
    return call


def _counts():
    n = L.snapshot()
    return n[C.CAPTURE], n[C.REPLAY]


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("decoder", ["beam_search", "nucleus_sampling"])
def test_a_shape_runs_eagerly_once_then_captures_each_step_once(model,
                                                                decoder):
    eager = _caption_fn(model, decoder, graph_type=None)
    images = [_images(3, seed) for seed in (1, 2, 3)]
    fn = _caption_fn(model, decoder)
    assert _equal(fn(images[0]), eager(images[0]))
    assert _counts() == (0, 0)       # the first call: the warm-up
    assert _equal(fn(images[1]), eager(images[1]))
    assert _counts() == (T, T)       # each step captured, then replayed
    assert _equal(fn(images[2]), eager(images[2]))
    assert _counts() == (T, 2 * T)   # and replayed, on new images


def test_the_cpu_never_captures_without_a_stand_in(model):
    fn = _caption_fn(model, graph_type=None)
    for _ in range(3):
        fn(_images(2))
    assert _counts() == (0, 0)


def test_the_last_two_shapes_keep_their_graphs(model):
    fn = _caption_fn(model)
    want = {b: _caption_fn(model, graph_type=None)(_images(b))
            for b in (1, 2, 3)}
    for b in (1, 1, 2, 2):
        assert _equal(fn(_images(b)), want[b])
    assert _counts() == (2 * T, 2 * T)
    fn(_images(1))                   # the oldest shape, used again
    assert _counts() == (2 * T, 3 * T)
    fn(_images(3))                   # a third shape drops shape 2
    assert _counts() == (2 * T, 3 * T)
    assert _equal(fn(_images(2)), want[2])  # eager again: a first call
    assert _counts() == (2 * T, 3 * T)
    assert _equal(fn(_images(2)), want[2])
    assert _counts() == (3 * T, 4 * T)
    assert len(fn.decode_graphs._shapes) == 2


def test_a_dropped_caption_function_frees_its_graphs_at_once(model):
    # Without the cyclic collector: a cycle would leave the graphs to it,
    # which could destroy them inside another graph's capture.
    spec = ModelSpec.from_config(_config("beam_search"))
    fn = make_caption_fn(model, CaptionDecoderFactory.from_spec(spec),
                         spec.sos_index, spec.prefix_mode)
    fn.decode_graphs.graph_type = StubGraph
    for _ in range(2):
        fn(_images(2))
    (shape,) = fn.decode_graphs._shapes.values()
    graphs = weakref.ref(shape.graphs[0].graph)
    shape = None
    collecting = gc.isenabled()
    gc.disable()
    try:
        fn = None
        assert graphs() is None
    finally:
        if collecting:
            gc.enable()


def _profiled(fn):
    with tracing.span("between sessions"):  # a store of its own
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_a_recording_profiler_captures_nothing(model):
    fn, images = _caption_fn(model), _images(2)
    fn(images)
    _profiled(lambda: fn(images))
    assert _counts() == (0, 0)
    assert tracing.notes("decode_graph") == ["eager"] * T
    fn(images)
    assert _counts() == (T, T)
    _profiled(lambda: fn(images))
    assert _counts() == (T, 2 * T)
    assert tracing.notes("decode_graph") == ["replay"] * T


def test_a_state_elsewhere_runs_that_step_eagerly(model):
    fn, images = _caption_fn(model), _images(2)
    want = fn(images)
    fn(images)
    assert _counts() == (T, T)
    # Without the step's spare the search gathers into caches of its
    # own before each even step: those steps run eagerly, the others
    # replay.
    fn.spare = False
    got = _profiled(lambda: fn(images))
    notes = tracing.notes("decode_graph")
    assert notes == ["replay", "replay"] + ["eager", "replay"] * (T // 2 - 1)
    assert _counts() == (T, T + notes.count("replay"))
    assert _equal(got, want)


def _counting_decode_attention(model):
    """Each decode attention a counted, noted launch of its shape, as on
    the card, computing the plain version."""
    def launch(q, k, v, n_valid, rows_per_kv=1):
        L.count(DA.KEY, (q.shape[0], k.shape[0], n_valid, q.shape[2],
                         q.shape[3]))
        return DA.decode_attention_reference(q, k, v, n_valid, rows_per_kv)
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.decode_attention_fn = launch


@pytest.mark.parametrize("decoder", ["beam_search", "nucleus_sampling"])
def test_replays_count_and_note_launches_as_the_eager_steps_do(model,
                                                               decoder):
    _counting_decode_attention(model)
    try:
        images = _images(2)
        eager, fn = _caption_fn(model, decoder), _caption_fn(model, decoder)
        fn(images)
        fn(images)
        seen = []
        for call in (eager, fn):
            before = L.snapshot()
            out = _profiled(lambda: call(images))
            seen.append((out, (L.snapshot() - before)[DA.KEY],
                         tracing.notes("decode_attention"),
                         tracing.notes("decode_graph")))
        (e_out, e_count, e_notes, e_kind), (r_out, r_count, r_notes,
                                            r_kind) = seen
        assert e_kind == ["eager"] * T and r_kind == ["replay"] * T
        assert e_count == r_count == len(e_notes) == 2 * T  # self, cross
        assert r_notes == e_notes
        assert _equal(r_out, e_out)
    finally:
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.decode_attention_fn = DA.decode_attention


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the decode "
                    "attention kernel have no CPU mode")
    return torch.device("cuda")


H2048 = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                     "width_ablations", "bicaptioning_R_50_L1_H2048.yaml")


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    cfg = Config(H2048)
    model = PretrainingModelFactory.from_config(cfg, "cuda").eval()
    return model, ModelSpec.from_config(cfg)


def _card_fn(card_model, decoder="beam_search"):
    model, spec = card_model
    spec = dataclasses.replace(spec, decoder_name=decoder)
    dec = CaptionDecoderFactory.from_spec(spec)
    fn = make_caption_fn(model, dec, spec.sos_index, spec.prefix_mode)
    if decoder == "nucleus_sampling":
        def draw(images):
            gen = torch.Generator(device=images.device).manual_seed(5)
            return fn(images, gen)
        return draw
    search, result = dec.search, {}

    def every_beam(*args):
        result["beams"] = search(*args, only_return_best=False)
        return result["beams"]
    dec.search = every_beam

    def call(images):
        fn(images)
        return result["beams"]
    return call


def _card_images(batch, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(batch, 224, 224, 3, generator=g, device="cuda")


def _same_beams(got, want):
    (tokens, scores), (w_tokens, w_scores) = got, want
    assert torch.equal(tokens, w_tokens)
    assert torch.isfinite(w_scores).all()
    rel = ((scores - w_scores).abs() / w_scores.abs().clamp(min=1.0)).max()
    assert float(rel) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 3])
def test_graphed_captions_equal_the_eager_ones_on_card(cuda, card_model,
                                                       batch):
    fn, images = _card_fn(card_model), _card_images(batch)
    eager = [t.clone() for t in fn(images)]   # the first call
    before = _counts()
    for _ in range(2):                        # capture and replay, replay
        _same_beams(fn(images), eager)
    captures, replays = (a - b for a, b in zip(_counts(), before))
    steps = card_model[1].max_decoding_steps
    assert 0 < captures <= steps and captures < replays <= 2 * steps


@pytest.mark.cuda
def test_graphed_nucleus_draws_equal_the_eager_ones_on_card(cuda,
                                                            card_model):
    fn, images = _card_fn(card_model, "nucleus_sampling"), _card_images(8)
    eager = fn(images).clone()
    for _ in range(2):
        assert torch.equal(fn(images), eager)
    assert _counts()[1] > 0


@pytest.mark.cuda
def test_a_second_shape_and_a_return_to_the_first_on_card(cuda, card_model):
    fn = _card_fn(card_model)
    a, b = _card_images(3), _card_images(4, seed=2)
    want_a = [t.clone() for t in fn(a)]
    want_b = [t.clone() for t in fn(b)]
    for images, want in ((a, want_a), (b, want_b), (a, want_a),
                         (b, want_b)):
        _same_beams(fn(images), want)
    # each shape: an eager call, a capturing call, a replaying call
    captures, replays = _counts()
    assert replays == 2 * captures > 0


@pytest.mark.cuda
def test_replays_count_and_note_launches_as_eager_ones_on_card(cuda,
                                                              card_model):
    images = _card_images(4)
    eager, fn = _card_fn(card_model), _card_fn(card_model)
    fn(images)
    fn(images)
    seen = []
    for call in (eager, fn):
        before = L.snapshot()
        _profiled(lambda: call(images))
        torch.cuda.synchronize()
        seen.append(((L.snapshot() - before)[DA.KEY],
                     tracing.notes("decode_attention"),
                     set(tracing.notes("decode_graph"))))
    assert seen[0][2] == {"eager"} and seen[1][2] == {"replay"}
    assert seen[0][0] == seen[1][0] == len(seen[0][1]) > 0
    assert seen[0][1] == seen[1][1]
