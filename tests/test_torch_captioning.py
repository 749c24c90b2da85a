"""The port's inference slice against the JAX package, end to end, on the
CPU: the flagship ``bicaptioning`` at ``_flagship_config(tiny=True)`` in
float32 (resnet18, L1_H128_A4_F256, captions of 8 tokens, 10k vocab).

- the eval step's loss and components against JAX ``make_eval_step``;
- the KV-cached ``decode_step`` log-probabilities along a fixed prefix;
- beam search against ``virtex_tpu.utils.beam_search`` with one step
  function that both sides share, over a numpy table with exact ties;
- captions token for token against JAX ``make_caption_fn``.

Weights reach the port only through ``state_dict_from_flax``. Every
comparison is |a − b| / (|ref| + atol) with its bound stated.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from virtex_tpu.engine.captioner import make_caption_fn as jax_caption_fn
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_eval_step as jax_eval_step
from virtex_tpu.factories import PretrainingModelFactory
from virtex_tpu.utils.beam_search import (
    AutoRegressiveBeamSearch as JaxBeamSearch,
)
from virtex_tpu_torch.config import ModelSpec
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.engine.evaluation import make_eval_step
from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch

IMAGE = 64


@pytest.fixture(scope="module")
def tiny():
    """JAX model, its variables, the port's model and a batch of 4 captions
    of lengths 8, 3..8. The output bias is drawn peaked (std 2) so that the
    gaps between the top tokens (~0.3) dwarf float noise (~1e-6) and beam
    search ranks the same candidates on both sides."""
    cfg = tiny_config()
    jm = PretrainingModelFactory.from_config(cfg)
    batch = caption_batch(4, IMAGE, cfg.DATA.MAX_CAPTION_LENGTH,
                          cfg.DATA.VOCAB_SIZE, seed=0)
    variables = jax_variables(jm, batch, seed=0, output_bias_std=2.0)
    spec = ModelSpec.from_config(cfg)
    return cfg, jm, variables, port_model(spec, variables), batch


def test_spec_reads_the_flagship_config():
    from __graft_entry__ import _flagship_config
    assert ModelSpec.from_config(_flagship_config()) == ModelSpec.flagship()
    spec = ModelSpec.from_config(tiny_config())
    assert spec.textual == {"norm_type": "post", "num_layers": 1,
                            "hidden_size": 128, "attention_heads": 4,
                            "feedforward_size": 256}
    assert spec.caption_backward and spec.torch_dtype == torch.float32


def test_eval_step_matches_jax(tiny):
    _, jm, variables, model, batch = tiny
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              optax.sgd(0.0))
    ref = jax_eval_step(jm)(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    got = make_eval_step(model)(torch_batch(batch))
    assert set(got) == set(ref) == {"loss", "captioning_forward",
                                    "captioning_backward"}
    for key in ref:
        assert got[key].dtype == torch.float32 and got[key].dim() == 0
        # fp32 losses of O(10); measured agreement ~1e-7 relative
        assert rel_err(got[key], np.asarray(ref[key]), 1e-3) <= 1e-5, key


def test_decode_step_logprobs_along_a_prefix(tiny):
    _, jm, variables, model, batch = tiny
    image = batch["image"][:2]
    prefix = batch["caption_tokens"][:2]
    grid = jm.apply(variables, image, method="encode_visual")
    caches = jm.apply(variables, grid, prefix.shape[1], method="init_decode")
    step = jax.jit(lambda v, tok, pos, c: jm.apply(
        v, tok, pos, c, method="decode_step"))
    with torch.inference_mode():
        tgrid = model.encode_visual(torch.from_numpy(image))
        assert rel_err(tgrid, np.asarray(grid), 1.0) <= 1e-4
        tcaches = model.init_decode(tgrid, prefix.shape[1])
        for pos in range(prefix.shape[1]):
            logits, caches = step(variables, jnp.asarray(prefix[:, pos]),
                                  pos, caches)
            ours, tcaches = model.decode_step(
                torch.from_numpy(prefix[:, pos]), pos, tcaches)
            ref = jax.nn.log_softmax(logits)
            # log-probabilities of O(10) from fp32 logits through a
            # 10k-way logsumexp; measured 7e-6
            assert rel_err(torch.log_softmax(ours, -1), np.asarray(ref),
                           1.0) <= 5e-5, pos


# -- beam search over a shared step function ----------------------------------
B, K, V, STEPS, EOS = 3, 4, 20, 7, 2


def _table():
    """Log-probability table (step, last token, next token), in quarters so
    that many entries, and sums of them, tie exactly; EOS made likely from
    step 3 on so that beams finish at different steps."""
    rng = np.random.RandomState(11)
    table = np.round(rng.randn(STEPS, V, V) * 4) / 4 - 2.0
    table[3:, :, EOS] += 1.5
    return table.astype(np.float32)


def _step_fn(table):
    """(last tokens, position, state) → (log-probs, state) for either
    framework, given the table as that framework's array: log-probs are the table row of the last token plus the
    beam's running token sum / 8 (also in quarters), so a beam whose state
    is not reordered with it scores differently."""
    def step(last, position, state):
        lp = table[position][last] + (state["acc"] / 8.0)[:, None]
        return lp, {"acc": state["acc"] + last * 1.0}
    return step


@pytest.mark.parametrize("only_best", [True, False])
def test_beam_search_matches_jax(only_best):
    table = _table()
    start = np.array([1, 5, 9], np.int32)
    acc0 = np.zeros(B * K, np.float32)

    jsearch = JaxBeamSearch(EOS, max_steps=STEPS, beam_size=K)
    jpreds, jscores = jsearch.search(
        jnp.asarray(start), _step_fn(jnp.asarray(table)),
        {"acc": jnp.asarray(acc0)}, only_return_best=only_best)

    search = AutoRegressiveBeamSearch(EOS, max_steps=STEPS, beam_size=K)
    preds, scores = search.search(
        torch.from_numpy(start), _step_fn(torch.from_numpy(table)),
        {"acc": torch.from_numpy(acc0)}, only_return_best=only_best)

    assert preds.shape == jpreds.shape
    assert np.array_equal(preds.numpy(), np.asarray(jpreds))
    # sums of quarters: exact in fp32
    assert np.array_equal(scores.numpy(), np.asarray(jscores))
    assert (preds == EOS).any()        # some beams finished early


def _in_place_step_fn(table, seen, spare):
    """The torch step of :func:`_step_fn` updating its state in place, as
    the decode step writes its caches, with ``spare`` its state's twin;
    ``seen`` collects where each step's state lay."""
    def step(last, position, state):
        seen.append(state["acc"].data_ptr())
        lp = table[position][last] + (state["acc"] / 8.0)[:, None]
        state["acc"].add_(last)
        return lp, state
    step.spare = spare
    return step


@pytest.mark.parametrize("only_best", [True, False])
@pytest.mark.parametrize("ends", ["some beams", "every beam"])
def test_beam_search_with_a_spare_matches_jax_over_two_states(only_best,
                                                              ends):
    table = _table()
    if ends == "every beam":  # EOS first from step 2: an early stop
        table[2:, :, EOS] += 20.0
    start = np.array([1, 5, 9], np.int32)
    acc0 = np.zeros(B * K, np.float32)
    jsearch = JaxBeamSearch(EOS, max_steps=STEPS, beam_size=K)
    jpreds, jscores = jsearch.search(
        jnp.asarray(start), _step_fn(jnp.asarray(table)),
        {"acc": jnp.asarray(acc0)}, only_return_best=only_best)

    search = AutoRegressiveBeamSearch(EOS, max_steps=STEPS, beam_size=K)
    table_t = torch.from_numpy(table)
    plain = search.search(torch.from_numpy(start), _step_fn(table_t),
                          {"acc": torch.from_numpy(acc0)},
                          only_return_best=only_best)
    state, spare = {"acc": torch.zeros(B * K)}, {"acc": torch.empty(B * K)}
    for _ in range(2):  # two calls over the same two states
        seen = []
        state["acc"].zero_()
        preds, scores = search.search(
            torch.from_numpy(start), _in_place_step_fn(table_t, seen, spare),
            state, only_return_best=only_best)
        assert np.array_equal(preds.numpy(), np.asarray(jpreds))
        assert np.array_equal(scores.numpy(), np.asarray(jscores))
        assert torch.equal(preds, plain[0]) and torch.equal(scores, plain[1])
        # steps 0 and 1 on the caller's state, then one and the other
        a, b = state["acc"].data_ptr(), spare["acc"].data_ptr()
        assert seen == [a, a] + [b if i % 2 == 0 else a
                                 for i in range(len(seen) - 2)]
    assert (len(seen) < STEPS) == (ends == "every beam")


@pytest.mark.parametrize("prefix_mode", ["reference", "sos"])
def test_captions_with_and_without_a_spare_match_jax(tiny, prefix_mode):
    cfg, jm, variables, model, batch = tiny
    steps = cfg.MODEL.DECODER.MAX_DECODING_STEPS
    jdecoder = JaxBeamSearch(cfg.DATA.EOS_INDEX, steps,
                             cfg.MODEL.DECODER.BEAM_SIZE)
    ref = jax_caption_fn(jm, jdecoder, cfg.DATA.SOS_INDEX,
                         prefix_mode)(variables, jnp.asarray(batch["image"]))
    decoder = AutoRegressiveBeamSearch(cfg.DATA.EOS_INDEX, steps,
                                       cfg.MODEL.DECODER.BEAM_SIZE)
    fn = make_caption_fn(model, decoder, cfg.DATA.SOS_INDEX, prefix_mode)
    images = torch.from_numpy(batch["image"])
    search, spares = decoder.search, []

    def without_spare(start, step_fn, state, **kwargs):
        spares.append(step_fn.spare)
        return search(start, lambda *a: step_fn(*a), state, **kwargs)
    with_spare = fn(images)
    decoder.search = without_spare
    without = fn(images)
    assert spares[0] is not None
    assert torch.equal(with_spare, without)
    assert np.array_equal(with_spare.numpy(), np.asarray(ref))


@pytest.mark.parametrize("prefix_mode", ["reference", "sos"])
def test_captions_stop_early_alike_with_and_without_a_spare(tiny,
                                                            prefix_mode):
    cfg, _, _, model, batch = tiny
    model = copy.deepcopy(model)
    with torch.no_grad():  # EOS first for every beam from the second step
        model.textual.output.bias[cfg.DATA.EOS_INDEX] += 30.0
    steps = cfg.MODEL.DECODER.MAX_DECODING_STEPS
    decoder = AutoRegressiveBeamSearch(cfg.DATA.EOS_INDEX, steps,
                                       cfg.MODEL.DECODER.BEAM_SIZE)
    fn = make_caption_fn(model, decoder, cfg.DATA.SOS_INDEX, prefix_mode)
    images = torch.from_numpy(batch["image"])
    search, calls = decoder.search, []

    def counted(start, step_fn, state, keep_spare):
        def step(*args):
            calls[-1] += 1
            return step_fn(*args)
        calls.append(0)
        if keep_spare:
            step.spare = step_fn.spare
        return search(start, step, state)
    decoder.search = lambda *a: counted(*a, keep_spare=True)
    with_spare = fn(images)
    decoder.search = lambda *a: counted(*a, keep_spare=False)
    without = fn(images)
    assert torch.equal(with_spare, without)
    assert (with_spare == cfg.DATA.EOS_INDEX).all()
    assert calls[0] == calls[1] < steps


def test_topk_breaks_ties_toward_the_lowest_index():
    from virtex_tpu_torch.utils.beam_search import topk
    x = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0]])
    values, indices = topk(x, 4)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert indices.tolist() == np.asarray(ref_i).tolist() == [[1, 2, 4, 0]]
    assert values.tolist() == np.asarray(ref_v).tolist()


# -- captions end to end -------------------------------------------------------
@pytest.mark.parametrize("prefix_mode", ["reference", "sos"])
def test_captions_match_jax_token_for_token(tiny, prefix_mode):
    cfg, jm, variables, model, batch = tiny
    steps = cfg.MODEL.DECODER.MAX_DECODING_STEPS
    jdecoder = JaxBeamSearch(cfg.DATA.EOS_INDEX, steps,
                             cfg.MODEL.DECODER.BEAM_SIZE)
    ref = jax_caption_fn(jm, jdecoder, cfg.DATA.SOS_INDEX,
                         prefix_mode)(variables, jnp.asarray(batch["image"]))
    decoder = AutoRegressiveBeamSearch(cfg.DATA.EOS_INDEX, steps,
                                       cfg.MODEL.DECODER.BEAM_SIZE)
    ours = make_caption_fn(model, decoder, cfg.DATA.SOS_INDEX, prefix_mode)(
        torch.from_numpy(batch["image"]))
    assert tuple(ours.shape) == (4, steps)
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def test_caption_fn_refuses_more_steps_than_positions(tiny):
    _, _, _, model, _ = tiny
    with pytest.raises(ValueError, match="positional"):
        make_caption_fn(model, AutoRegressiveBeamSearch(2, max_steps=9))
