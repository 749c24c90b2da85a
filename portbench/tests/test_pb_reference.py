r"""
The plain reference held to the program at a tiny size on the CPU, in
fp32: the bicaptioning loss and gradients with dropout (the draws replayed
in the program's order), the optimizer chain, beam search and its scores,
the decode path's view of the decoder, the decay mask and the attention
keep mask.

    python -m pytest portbench/tests -q --noconftest
"""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import checks, harness, inputs
from portbench.kinds import common
from portbench.reference import beam, model as ref
from portbench.reference.optim import Chain, decays
from portbench.reference.philox import keep_mask
from portbench.tests import tiny


def fp32_config(dropout=0.1):
    cfg = tiny.tiny_config()["config"]
    cfg = copy.deepcopy(cfg)
    cfg["DTYPE"] = "float32"
    cfg["MODEL"]["TEXTUAL"]["DROPOUT"] = dropout
    return cfg


def port_model(cfg, seed=5):
    from virtex_tpu_torch.config import Config
    model = common.build_model(Config(None, harness.overrides(cfg)), "cpu")
    w = inputs.draw_weights(common.parameter_shapes(model), seed, "cpu")
    common.load_weights(model, w)
    return model, w


def batch_of(cfg, seed=5):
    D = cfg["DATA"]
    return inputs.train_batch(seed, 0, [3, 5, 7, 10], D["IMAGE_CROP_SIZE"],
                              D["MAX_CAPTION_LENGTH"], D["VOCAB_SIZE"],
                              "cpu")


def test_train_loss_and_gradients_match_the_program():
    cfg = fp32_config()
    model, w = port_model(cfg)
    batch = batch_of(cfg)
    gen = torch.Generator().manual_seed(11)
    model.train()
    out = model(batch, generator=gen)
    out["loss"].backward()
    params = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    gen = torch.Generator().manual_seed(11)
    loss = ref.bicaptioning_loss(params, checks.dims_of(cfg), batch, gen)[0]
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want, got = float(loss.detach()), float(out["loss"].detach())
    assert abs(got - want) <= 1e-5 * want
    # fp32 in other orders: the head's gradients agree to ~1e-6; layer4's
    # BatchNorm at 64² normalises 16 values a channel, where a last-bit
    # difference flips ReLUs and moves its gradients by ~3e-3.
    for n, p in model.named_parameters():
        err = float((p.grad - grads[n]).norm() / (grads[n].norm() + 1e-12))
        assert err < (1e-2 if "cnn" in n else 1e-4), n


def test_dropout_draws_matter():
    """Another dropout stream moves the reference's loss far more than the
    comparison above allows, so that test holds the draws' order."""
    cfg = fp32_config()
    _, w = port_model(cfg)
    batch = batch_of(cfg)
    d = checks.dims_of(cfg)
    a = ref.bicaptioning_loss(w, d, batch, torch.Generator().manual_seed(11))
    b = ref.bicaptioning_loss(w, d, batch, torch.Generator().manual_seed(12))
    assert abs(float(a[0]) - float(b[0])) > 1e-4 * float(a[0])


def test_optimizer_chain_matches_the_program():
    from virtex_tpu_torch.config import Config
    from virtex_tpu_torch.factories import OptimizerFactory
    cfg = fp32_config()
    model, w = port_model(cfg)
    opt = OptimizerFactory.from_config(Config(None, harness.overrides(cfg)),
                                       model.named_parameters())
    state = opt.state_dict()
    state["step_count"] = state["lookahead_count"] = 9998
    opt.load_state_dict(state)
    params = {n: t.clone() for n, t in w.items()}
    chain = Chain(params, checks.hyper_of(cfg), start=9998)
    gen = torch.Generator().manual_seed(3)
    named = dict(model.named_parameters())
    for _ in range(7):  # through the warmup's end and a Lookahead sync
        grads = {n: torch.randn(p.shape, generator=gen) * 0.3
                 for n, p in named.items()}
        for n, p in named.items():
            p.grad = grads[n].clone()
        opt.step()
        chain.step(params, grads)
        worst = max(float((named[n].detach() - params[n]).abs().max())
                    for n in named)
        assert worst < 1e-6


def test_decay_rule_matches_the_program():
    from virtex_tpu_torch.config import Config
    from virtex_tpu_torch.optim.optimizer import decay_mask
    cfg = fp32_config()
    with torch.device("meta"):
        from virtex_tpu_torch.factories import PretrainingModelFactory
        model = PretrainingModelFactory.from_config(
            Config(None, harness.overrides(cfg)), "meta")
    named = list(model.named_parameters())
    mask = decay_mask(named)
    no_decay = cfg["OPTIM"]["NO_DECAY"]
    assert all(decays(n, no_decay) == mask[n] for n, _ in named)
    assert not all(mask.values()) and any(mask.values())


def test_keep_mask_matches_the_kernels_rule():
    from virtex_tpu_torch.ops.attention import philox_keep_reference
    for seed in (0, 7, 2**31 - 2):
        a = keep_mask(seed, 2, 3, 5, 7, 0.1, "cpu")
        b = philox_keep_reference(seed, 2, 3, 5, 7, 0.1, device="cpu")
        assert torch.equal(a, b)


def _toy_table(V=12, eos=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(V, V, generator=gen) * 2.0
    table[:, eos] += 1.0
    return torch.log_softmax(table, dim=-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_matches_the_program(seed):
    from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch
    table = _toy_table(seed=seed)
    B, K, steps, sos, eos = 3, 4, 8, 1, 2
    search = AutoRegressiveBeamSearch(eos, steps, K)
    start = torch.full((B,), sos, dtype=torch.long)
    preds, _ = search.search(start, lambda last, t, s: (table[last], s),
                                  [torch.zeros(B * K)])
    next_fn = lambda tokens: table[tokens[:, -1]]  # noqa: E731
    mine = beam.beam_search(next_fn, B, K, steps, sos, eos, "cpu")
    assert torch.equal(mine, preds)
    assert float(beam.token_gaps(next_fn, preds, sos, eos, K).max()) == 0.0
    altered = preds.clone()
    altered[:, 1] = (altered[:, 1] + 5) % table.shape[0]
    assert float(beam.token_gaps(next_fn, altered, sos, eos, K).max()) > 0


def test_token_gaps_refuse_a_token_after_eos():
    table = _toy_table()
    next_fn = lambda tokens: table[tokens[:, -1]]  # noqa: E731
    first = int(table[1].argmax())
    ok = torch.tensor([[first, 2, 2, 2]])
    bad = torch.tensor([[first, 2, 7, 2]])
    assert float(beam.token_gaps(next_fn, ok, 1, 2, 4)[0, 2:].max()) == 0.0
    assert float(beam.token_gaps(next_fn, bad, 1, 2, 4).max()) > 1e17


def test_captions_match_the_programs_decode_path():
    """The program's cached beam search in fp32 gives the captions of the
    reference's uncached one, from the same weights and statistics."""
    from virtex_tpu_torch.config import Config, ModelSpec
    from virtex_tpu_torch.engine.captioner import make_caption_fn
    from virtex_tpu_torch.factories import CaptionDecoderFactory
    cfg = fp32_config(dropout=0.0)
    model, w = port_model(cfg, seed=8)
    images = inputs.images(8, 0, 3, cfg["DATA"]["IMAGE_CROP_SIZE"], "cpu")
    stats: dict = {}
    ref.resnet50(w, images, train=False, calib=stats)
    w.update(stats)
    common.load_weights(model, stats)
    spec = ModelSpec.from_config(Config(None, harness.overrides(cfg)))
    fn = make_caption_fn(model, CaptionDecoderFactory.from_spec(spec),
                         spec.sos_index, spec.prefix_mode)
    served = fn(images)
    run = type("R", (), {"config_file": {"config": cfg}})()
    gaps = checks.caption_gaps(run, w, images, served, "cpu")
    assert float(gaps.max()) < 1e-4
