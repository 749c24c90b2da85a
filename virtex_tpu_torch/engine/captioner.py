r"""
End-to-end caption generation: visual encode → KV-cache init → beam search
or nucleus sampling.

Counterpart of ``virtex_tpu/engine/captioner.py`` :func:`make_caption_fn`
and :func:`decode_predictions`. The visual grid is encoded once and the
head's ``init_decode`` (the span ``prefill``) builds its caches. The head
says which parts of them follow the beams and which are one per image
(``split_cache``): the transformer head's self-attention K/V follow the
beams and its cross-attention K/V, projected once, are one row per image
that serves all of its beams (the decode attention reads it once per
image); the latent-attention head's generated positions follow the beams
and its prefix's latents are one per image. Beam search holds the per-image
part outside the search state (the per-step beam reorder never gathers
it) and reorders the per-beam part with the beams, from one of two fixed
sets of caches into the other. Each call runs inside the head's
``decoding()`` (the latent-attention head casts its matrices once a call
there). Nucleus sampling keeps one row per image, so its state is the
whole cache; it runs on a head whose ``searches`` name it.

On CUDA the decode steps run as CUDA graph replays (:class:`DecodeGraphs`):
one graph per step index and call shape, in place of the step's ~70
launches.
"""
from __future__ import annotations

import collections
import contextlib
import gc
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from virtex_tpu_torch.ops import _launch
from virtex_tpu_torch.utils import tracing
from virtex_tpu_torch.utils.beam_search import (
    AutoRegressiveBeamSearch,
    tree_map,
)
from virtex_tpu_torch.utils.nucleus_sampling import (
    AutoRegressiveNucleusSampling,
)
from virtex_tpu_torch.utils.tracing import span

CaptionFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]

KEPT_SHAPES = 2  # call shapes whose graphs and buffers stay
# The count keys (ops/_launch.py) of a decode step replayed and captured.
REPLAY, CAPTURE = ("decode_graph", "replay"), ("decode_graph", "capture")


def _leaves(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out = []
    tree_map(lambda x: out.append(x) if torch.is_tensor(x) else None, tree)
    return out


def _layout(tree) -> tuple:
    """Where each tensor of ``tree`` lies: what a graph reads and writes."""
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for t in _leaves(tree))


class _Graph(NamedTuple):
    """One captured step: the graph, what its capture returned (its
    outputs, at fixed addresses), the layout of the state it was captured
    on, and the kernel launches recorded inside it."""

    graph: Any
    result: Any
    layout: tuple
    launches: tuple


class _Shape:
    """The graphs and fixed buffers of one call shape. ``buffers`` holds
    the step's inputs besides the tokens (the state, the constant K/V),
    which each call copies its own into; ``calls`` counts the calls.
    ``graph_type``: see :class:`DecodeGraphs`."""

    def __init__(self, buffers: dict, device: torch.device, graph_type):
        self.buffers, self.device = buffers, device
        self.graph_type = graph_type
        self.calls = 0
        self.graphs: Dict[int, _Graph] = {}
        self.tokens: Optional[torch.Tensor] = None
        self.pool = None  # the memory pool every graph of the shape shares
        self.stream = None
        self._owned = {t.data_ptr() for t in _leaves(buffers)}

    def steps(self, step_fn):
        """``step_fn`` as the search calls it, ``(tokens, t, state) →
        (out, state)``, each step a replay where it can be: step ``t`` is
        captured the first time it comes in a later call than the shape's
        first, with no profiler recording and the state in this shape's
        buffers; then replayed while the state lies where it lay."""
        def step(tokens: torch.Tensor, t: int, state):
            with span("decode_step", tokens):
                g = self.graphs.get(t)
                if g is None and self._may_capture(state):
                    g = self._capture(step_fn, tokens, t, state)
                if g is None or g.layout != _layout(state):
                    tracing.note("decode_graph", "eager")
                    return step_fn(tokens, t, state)
                self.tokens.copy_(tokens)
                g.graph.replay()
                _launch.count(REPLAY)
                _launch.replayed(g.launches)
                tracing.note("decode_graph", "replay")
                return g.result
        return step

    def _may_capture(self, state) -> bool:
        return (self.calls > 1 and not tracing.recording()
                and (self.graph_type is not None
                     or self.device.type == "cuda")
                and all(t.data_ptr() in self._owned for t in _leaves(state)))

    def _capture(self, step_fn, tokens, t: int, state) -> _Graph:
        if self.tokens is None:
            self.tokens = torch.empty_like(tokens)
        self.tokens.copy_(tokens)
        graph = (self.graph_type or torch.cuda.CUDAGraph)()
        on_stream = contextlib.nullcontext()
        if self.device.type == "cuda":  # captured on a side stream
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            on_stream = torch.cuda.stream(self.stream)
        # No garbage collection inside: it could destroy another graph, a
        # call the capture would not survive.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with on_stream, _launch.capturing() as launches:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    result = step_fn(self.tokens, t, state)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        if self.pool is None:
            self.pool = graph.pool()
        self.graphs[t] = g = _Graph(graph, result, _layout(state),
                                    tuple(launches))
        _launch.count(CAPTURE)
        return g


class DecodeGraphs:
    r"""The decode steps of a caption function's calls as CUDA graph
    replays, one graph per step index (the position is a host int the step
    bakes in) and call shape (the shapes, dtypes and device of its caches).

    The first call at a shape runs eagerly, which is also the warm-up a
    capture needs; from the second call on each step is captured once and
    then replayed. The graphs of a shape share one memory pool, captured
    and replayed in step order. A call under a recording profiler captures
    nothing (its uncaptured steps run eagerly); a step whose state does
    not lie where its graph's did runs eagerly. The last ``KEPT_SHAPES``
    shapes keep their graphs and buffers. Graphs are made on CUDA devices
    only, unless ``graph_type`` stands in for ``torch.cuda.CUDAGraph``.
    """

    def __init__(self, graph_type=None):
        self.graph_type = graph_type
        self._shapes: "collections.OrderedDict[tuple, _Shape]" = \
            collections.OrderedDict()

    def shape(self, caches, make_buffers: Callable[[], dict]) -> _Shape:
        """The :class:`_Shape` of a call whose caches are ``caches``, its
        buffers made by ``make_buffers`` on the shape's first call."""
        leaves = _leaves(caches)
        key = (leaves[0].device,) + tuple((t.shape, t.dtype) for t in leaves)
        entry = self._shapes.pop(key, None)
        if entry is None:
            entry = _Shape(make_buffers(), leaves[0].device, self.graph_type)
        self._shapes[key] = entry
        while len(self._shapes) > KEPT_SHAPES:
            self._shapes.popitem(last=False)
        entry.calls += 1
        return entry


def make_caption_fn(model, decoder, sos_index: int = 1,
                    prefix_mode: str = "reference") -> CaptionFn:
    r"""Build ``(images, generator=None) → predictions`` (B, max_steps)
    token ids, the start token excluded. Nucleus sampling draws from
    ``generator`` (on the images' device) and raises without one; beam
    search takes none. The function's :class:`DecodeGraphs` is its
    ``decode_graphs``.

    ``prefix_mode`` (config ``MODEL.DECODER.PREFIX_MODE``), beam search
    only:

    - ``"reference"`` (default, the parity contract): prefixes EXCLUDE the
      start token, as the reference decodes, so generated token i sits at
      position i−1 and the first prediction overwrites the SOS cache slot.
      This is the reference's train/inference mismatch, kept on purpose
      so that published checkpoints caption as they did.
    - ``"sos"``: keep SOS at position 0, as in training.

    Nucleus sampling always keeps SOS at position 0, as the reference
    does, and its step returns raw logits, not log-probabilities.
    """
    if not isinstance(decoder, (AutoRegressiveBeamSearch,
                                AutoRegressiveNucleusSampling)):
        raise TypeError(f"unknown caption decoder {type(decoder).__name__}")
    if prefix_mode not in ("reference", "sos"):
        raise ValueError(f"unknown prefix_mode {prefix_mode!r}")
    max_pos = model.textual.max_caption_length
    if decoder.max_steps > max_pos:
        raise ValueError(
            f"decoder.max_steps={decoder.max_steps} exceeds the positional "
            f"table ({max_pos} rows); raise DATA.MAX_CAPTION_LENGTH or "
            "lower MODEL.DECODER.MAX_DECODING_STEPS")
    graphs = DecodeGraphs()
    head = model.textual
    search = ("nucleus sampling"
              if isinstance(decoder, AutoRegressiveNucleusSampling)
              else "beam search")
    if search not in head.searches:
        raise ValueError(f"{type(head).__name__} captions by "
                         f"{' and '.join(head.searches)} only: {search} with "
                         "it is not written")
    if search == "nucleus sampling":
        caption_fn = _nucleus_caption_fn(model, decoder, sos_index, graphs)
        caption_fn.decode_graphs = graphs
        return caption_fn
    rebase = prefix_mode == "reference"
    K = decoder.beam_size

    def beam_buffers(per_beam, per_image) -> dict:
        """Two sets of the per-beam caches, B·K rows each (the search
        reorders from one into the other), and the per-image ones."""
        def rows(t):
            return t.new_empty((t.shape[0] * K, *t.shape[1:]))
        return {"beam": [tree_map(rows, per_beam) for _ in range(2)],
                "image": tree_map(torch.empty_like, per_image),
                "logprobs": None}

    @torch.inference_mode()
    def caption_fn(images: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        with span("caption", images), head.decoding():
            model.eval()
            grid = model.encode_visual(images)
            B = images.shape[0]
            with span("prefill", images):
                caches = model.init_decode(grid, decoder.max_steps)
            per_beam, per_image = head.split_cache(caches)
            shape = graphs.shape(
                caches, lambda: beam_buffers(per_beam, per_image))
            buf = shape.buffers
            state, spare = buf["beam"]
            # Row i of the per-image caches serves beams [i·K, (i + 1)·K);
            # each image's per-beam caches are repeated to its beams.
            tree_map(lambda out, c: out.view(B, K, *c.shape[1:]).copy_(
                c[:, None]), state, per_beam)
            tree_map(lambda out, c: out.copy_(c), buf["image"], per_image)
            del caches, per_beam, per_image

            def step_fn(tokens, position: int, state):
                if rebase:
                    position = max(position - 1, 0)
                full = head.join_cache(state, buf["image"])
                logits, full = model.decode_step(tokens, position, full)
                state = head.split_cache(full)[0]
                if buf["logprobs"] is None:
                    buf["logprobs"] = logits.new_empty(logits.shape,
                                                       dtype=torch.float32)
                return torch.log_softmax(logits.float(), dim=-1,
                                         out=buf["logprobs"]), state

            start = torch.full((B,), sos_index, dtype=torch.long,
                               device=images.device)
            steps = shape.steps(step_fn)
            steps.spare = spare
            preds, _ = decoder.search(start, steps, state)
            return preds

    caption_fn.decode_graphs = graphs
    return caption_fn


def _nucleus_caption_fn(model, decoder: AutoRegressiveNucleusSampling,
                        sos_index: int, graphs: DecodeGraphs) -> CaptionFn:
    @torch.inference_mode()
    def caption_fn(images: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        if generator is None:
            # A fixed seed would make "sampling" deterministic with no
            # symptom; the caller threads its own randomness.
            raise ValueError("nucleus captioning needs a torch.Generator "
                             "(generator=)")
        with span("caption", images), model.textual.decoding():
            model.eval()
            grid = model.encode_visual(images)
            with span("prefill", images):
                caches = model.init_decode(grid, decoder.max_steps)
            shape = graphs.shape(
                caches, lambda: {"caches": tree_map(torch.empty_like,
                                                    caches)})
            state = shape.buffers["caches"]
            tree_map(lambda buffer, c: buffer.copy_(c), state, caches)
            del caches
            start = torch.full((images.shape[0],), sos_index,
                               dtype=torch.long, device=images.device)
            preds, _ = decoder.search(start, shape.steps(step_fn), state,
                                      generator)
            return preds

    def step_fn(tokens, position: int, caches):
        return model.decode_step(tokens, position, caches)

    return caption_fn


def decode_predictions(tokens, tokenizer, eos_index: int = 2) -> list:
    """(B, T) token ids (a tensor or an array) → B captions: each row cut
    before its first ``eos_index``, then ``tokenizer.decode``, which drops
    the special ids."""
    if torch.is_tensor(tokens):
        tokens = tokens.cpu()
    out = []
    for row in tokens.tolist():
        ids = []
        for t in row:
            if t == eos_index:
                break
            ids.append(int(t))
        out.append(tokenizer.decode(ids))
    return out
