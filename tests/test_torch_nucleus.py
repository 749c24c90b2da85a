"""The port's nucleus sampling (virtex_tpu_torch.utils.nucleus_sampling and
the nucleus branch of ``make_caption_fn``) against the JAX package's, on
the CPU.

- the drop set of :func:`topp_drop` against ``_topp_drop`` on random
  logits with planted ties, at p 0.5, 0.9 and 0.99;
- the search token for token against ``AutoRegressiveNucleusSampling``
  at p 1e-4, where the nucleus holds only the top token and a draw is
  deterministic; the repetition guard and the EOS latch; the support law
  by counting draws;
- captions of a tiny forward-captioning model against the JAX
  ``make_caption_fn`` at p 1e-4, token for token.

Randomness is never compared bit for bit: JAX draws from threefry, the
port from a ``torch.Generator``. Where the guard has removed the whole
nucleus, every logit is −1e18 and both sides take token 0: both draw by
Gumbel-max in fp32, and noise of O(10) vanishes in the rounding of 1e18.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (
    caption_batch,
    drawn_variables,
    port_model,
    tiny_config,
)
from virtex_tpu.engine.captioner import make_caption_fn as jax_caption_fn
from virtex_tpu.factories import PretrainingModelFactory
from virtex_tpu.utils.nucleus_sampling import (
    AutoRegressiveNucleusSampling as JaxNucleus,
)
from virtex_tpu.utils.nucleus_sampling import _topp_drop
from virtex_tpu_torch.config import ModelSpec
from virtex_tpu_torch.engine.captioner import make_caption_fn
from virtex_tpu_torch.factories import CaptionDecoderFactory
from virtex_tpu_torch.utils.nucleus_sampling import (
    AutoRegressiveNucleusSampling,
    topp_drop,
)

EOS = 2


def _generator(seed):
    return torch.Generator().manual_seed(seed)


# -- the drop set --------------------------------------------------------------
def _tied_logits(rng, rows, vocab):
    """Logits with planted ties: rounded to 0.25 (many equal values, some at
    the nucleus boundary), a few rows with one value throughout, and rows
    whose top value is shared."""
    x = np.round(rng.randn(rows, vocab) * 2.0 * 4) / 4
    x[:4] = 0.5                      # uniform rows: the tie is the boundary
    x[4:8, :3] = x[4:8].max(axis=1, keepdims=True)   # tied top tokens
    return x.astype(np.float32)


def _boundary_rows(logits, p, margin=1e-6):
    """Rows where some token's mass sorted strictly before it (float64,
    descending, ties by index) lies within ``margin`` of ``p``. There the
    two sides may round the comparison differently (``_topp_drop``'s
    docstring), so these rows are not compared."""
    order = np.argsort(-logits, axis=1, kind="stable")
    x = np.take_along_axis(logits.astype(np.float64), order, axis=1)
    probs = np.exp(x - x[:, :1])
    probs /= probs.sum(axis=1, keepdims=True)
    before = np.cumsum(probs, axis=1) - probs
    return (np.abs(before - p) < margin).any(axis=1)


@pytest.mark.parametrize("p", [0.5, 0.9, 0.99])
def test_drop_set_matches_jax(p):
    rng = np.random.RandomState(int(p * 100))
    logits = _tied_logits(rng, 256, 203)
    ref = np.asarray(_topp_drop(jnp.asarray(logits), p))
    ours = topp_drop(torch.from_numpy(logits), p).numpy()
    skip = _boundary_rows(logits, p)
    assert skip.sum() <= 8               # the comparison covers most rows
    assert np.array_equal(ours[~skip], ref[~skip])
    assert not ours[:, :1].all()         # the top token is never dropped
    assert (~ours).sum(axis=1).min() >= 1


# -- the search against the JAX search ------------------------------------------
V = 12


def _table(rng, self_loops=()):
    """Logits by previous token, (V, V): row r's top token is never r,
    except for the rows in ``self_loops``; EOS is the top token of row 5."""
    table = rng.randn(V, V).astype(np.float32)
    for r in range(V):
        top = (r + 1 + rng.randint(V - 1)) % V if r not in self_loops else r
        if r == 5:
            top = EOS
        table[r, top] = table[r].max() + 1.0 + rng.rand()
    return table


def _searches(table, start, p, steps, seed=0):
    """(port predictions, JAX predictions, port step count) with a step
    function that both sides share."""
    calls = []

    def port_step(last, position, state):
        calls.append(position)
        return torch.from_numpy(table)[last], state

    def jax_step(last, position, state):
        return jnp.asarray(table)[last], state

    ours, _ = AutoRegressiveNucleusSampling(EOS, steps, p).search(
        torch.as_tensor(start), port_step, {}, _generator(seed))
    ref, _ = JaxNucleus(EOS, steps, p).search(
        jnp.asarray(start, jnp.int32), jax_step, {}, jax.random.PRNGKey(seed))
    return ours.numpy(), np.asarray(ref), len(calls)


def test_search_matches_jax_token_for_token():
    """p 1e-4: the nucleus is the top token alone, and no top token repeats
    the previous one, so each step is the table's argmax on both sides."""
    table = _table(np.random.RandomState(0))
    start = np.array([0, 1, 3, 4, 7, 8, 9, 10, 11, 6])
    ours, ref, _ = _searches(table, start, 1e-4, 9)
    assert ours.shape == (len(start), 9)
    assert np.array_equal(ours, ref)
    want = start.copy()
    for t in range(9):   # the argmax chain, latched at EOS after the first
        latched = (want == EOS) & (t > 0)
        want = np.where(latched, EOS, table[want].argmax(axis=1))
        assert np.array_equal(ours[:, t], want), t


def test_repetition_guard():
    """Where the nucleus is the previous token alone, the guard leaves every
    logit at −1e18 and both sides take token 0; with two tokens in the
    nucleus the guard forces the other one."""
    rng = np.random.RandomState(1)
    table = _table(rng, self_loops=(3,))
    ours, ref, _ = _searches(table, np.array([3]), 1e-4, 1)
    assert ours[0, 0] == ref[0, 0] == 0
    # nucleus {3, 7} at p 0.9: 3 → 7 → 3 → ... whatever the draws
    logits = np.full((V, V), -10.0, np.float32)
    logits[:, 3], logits[:, 7] = 5.0, 4.9
    for seed in range(5):
        ours, ref, _ = _searches(logits, np.array([3, 7]), 0.9, 6, seed)
        assert np.array_equal(ours[0], [7, 3] * 3)
        assert np.array_equal(ours[1], [3, 7] * 3)
        assert np.array_equal(ours, ref)


def test_eos_latch_and_early_stop():
    """A row that emits EOS keeps emitting it, and the search stops once
    every row has (the start token is not a finished row)."""
    logits = np.full((V, V), -10.0, np.float32)
    logits[:, EOS] = 10.0
    logits[EOS, 4] = 20.0        # after EOS the step would say 4 ...
    ours, ref, calls = _searches(logits, np.array([EOS, 1]), 0.9, 8)
    # ... and does so at step 0 (a start token is never latched), but from
    # step 1 on the latch holds EOS
    want = np.full((2, 8), EOS)
    want[0, 0] = 4
    assert np.array_equal(ours, want)
    assert np.array_equal(ours, ref)
    # steps 0 and 1; step 2 is launched before the host finds all
    # latched, and its logits are dropped
    assert calls == 3


def test_support_law():
    """Every draw lies in the nucleus, and the frequencies are the
    renormalised probabilities. Probabilities 0.4, 0.25, 0.15, 0.1, ...;
    at p 0.75 the nucleus is the first three (mass before the fourth:
    0.8), renormalised 0.5, 0.3125, 0.1875. 40000 draws: each frequency
    has a standard deviation <= 2.5e-3, so a bound of 0.015 is 6 sigma."""
    probs = np.array([0.4, 0.25, 0.15, 0.1, 0.05, 0.03, 0.015, 0.005])
    logits = np.log(probs).astype(np.float32)[None]
    n = 40000

    def step(last, position, state):
        return torch.from_numpy(logits).expand(last.shape[0], -1), state

    start = torch.full((n,), 7)
    draws, _ = AutoRegressiveNucleusSampling(EOS, 1, 0.75).search(
        start, step, None, _generator(3))
    counts = np.bincount(draws[:, 0].numpy(), minlength=8)
    assert counts[3:].sum() == 0
    want = probs[:3] / probs[:3].sum()
    assert np.abs(counts[:3] / n - want).max() <= 0.015


def test_draws_follow_the_generator():
    table = np.random.RandomState(2).randn(V, V).astype(np.float32)

    def step(last, position, state):
        return torch.from_numpy(table)[last], state

    sampler = AutoRegressiveNucleusSampling(EOS, 10, 0.9)
    start = torch.arange(V)
    a, _ = sampler.search(start, step, None, _generator(5))
    b, _ = sampler.search(start, step, None, _generator(5))
    c, _ = sampler.search(start, step, None, _generator(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        sampler.search(start, step, None, None)


# -- captions end to end -------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_captioning():
    """Forward captioning at ``tiny_config`` size (resnet18 at 64²,
    L1_H128_A4_F256, 10k vocabulary, 8 positions), weights drawn from a
    numpy seed with a zero output bias, so that the image and the prefix
    decide the top token. The tied output projection favours the token
    just read, which the guard then turns into token 0."""
    cfg = tiny_config(model_name="captioning")
    jm = PretrainingModelFactory.from_config(cfg)
    batch = caption_batch(6, 64, cfg.DATA.MAX_CAPTION_LENGTH,
                          cfg.DATA.VOCAB_SIZE, seed=4)
    variables = drawn_variables(jm, batch, seed=4)
    spec = ModelSpec.from_config(cfg)
    return cfg, jm, variables, port_model(spec, variables), batch["image"]


def test_captions_match_jax_token_for_token(tiny_captioning):
    """p 1e-4 makes each step the top token, or token 0 where that repeats
    the previous token, on both sides. Position 0 holds SOS throughout, as
    in training (never rebased, whatever ``prefix_mode`` says)."""
    cfg, jm, variables, model, images = tiny_captioning
    steps = cfg.DATA.MAX_CAPTION_LENGTH - 1
    ref = jax_caption_fn(jm, JaxNucleus(EOS, steps, 1e-4),
                         cfg.DATA.SOS_INDEX)(variables, jnp.asarray(images),
                                             jax.random.PRNGKey(0))
    spec = ModelSpec(model_name="captioning", decoder_name="nucleus_sampling",
                     nucleus_size=1e-4, max_decoding_steps=steps)
    decoder = CaptionDecoderFactory.from_spec(spec)
    assert isinstance(decoder, AutoRegressiveNucleusSampling)
    caption = make_caption_fn(model, decoder, cfg.DATA.SOS_INDEX,
                              prefix_mode="reference")
    ours = caption(torch.from_numpy(images), _generator(0))
    assert tuple(ours.shape) == (len(images), steps)
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    # the captions are not all alike: the check sees the prefix positions
    assert len({tuple(row) for row in ours.tolist()}) > 1
    with pytest.raises(ValueError, match="Generator"):
        caption(torch.from_numpy(images))
