"""The port's checkpoints (virtex_tpu_torch.engine.checkpointing,
train_state, Optimizer.state_dict) on the CPU.

- Saved at step 3 in the middle of a Lookahead cycle (k 5) with dropout on,
  loaded into a fresh model and optimizer, two more steps equal an
  unbroken run's bit for bit (the CPU runs are deterministic).
- Pruning, the rolling best, and its heal after a crash, as
  tests/test_engine.py holds the JAX package's manager.
- The model part loads into the JAX package through
  load_torch_checkpoint, and a state dict from export_virtex_checkpoint
  loads into the port with strict=True, with equal values.
- Every load refuses a pickle that torch.load(weights_only=True) refuses.
"""
import copy
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401 (an autouse fixture)
    caption_batch,
    one_torch_thread,
    torch_batch,
)
from virtex_tpu_torch.config import ModelSpec, OptimSpec
from virtex_tpu_torch.engine.checkpointing import (
    CheckpointManager,
    apply_backbone_weight_init,
    load_model_variables,
    read_checkpoint,
)
from virtex_tpu_torch.engine.train_state import TrainState, step_seed
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.factories import PretrainingModelFactory
from virtex_tpu_torch.optim.optimizer import build_optimizer

SPEC = ModelSpec(model_name="bicaptioning",
                 visual_name="torchvision::resnet18", visual_feature_size=512,
                 textual_name="transdec_postnorm::L1_H64_A2_F128",
                 textual_dropout=0.1, dtype="float32", vocab_size=300,
                 max_caption_length=8, image_size=32)
OPTIM = OptimSpec(warmup_steps=2, num_iterations=10)  # Lookahead k 5
ACCUM, MICRO, STEPS, SAVE_AT = 2, 2, 5, 3


def _state(seed=0, spec=SPEC, optim=OPTIM):
    torch.manual_seed(seed)
    model = PretrainingModelFactory.from_spec(spec, device="cpu")
    return TrainState(model, build_optimizer(model.named_parameters(),
                                             optim))


def _batches():
    out = []
    for s in range(STEPS):
        b = torch_batch(caption_batch(MICRO * ACCUM, SPEC.image_size,
                                      SPEC.max_caption_length,
                                      SPEC.vocab_size, seed=s))
        out.append({k: v.reshape((ACCUM, MICRO) + v.shape[1:])
                    for k, v in b.items()})
    return out


def _train(state, batches, first, last):
    """Steps first..last, each with its generator seeded by step_seed, as
    the pretraining CLI runs them."""
    gen = torch.Generator()
    step = make_train_step(state.model, state.optimizer, ACCUM, gen)
    metrics = {}
    for i in range(first, last + 1):
        gen.manual_seed(step_seed(0, i))
        metrics[i] = step(batches[i - 1])
        state.iteration = i
    return metrics


def _flat(state):
    opt = state.optimizer.state_dict()
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for key in ("trace", "slow"):
        out.update({f"{key}.{n}": t for n, t in opt[key].items()})
    return out, {k: v for k, v in opt.items() if not isinstance(v, dict)}


def test_resume_mid_lookahead_equals_an_unbroken_run(tmp_path):
    batches = _batches()
    unbroken = _state()
    ref = _train(unbroken, batches, 1, STEPS)

    first = _state()
    _train(first, batches, 1, SAVE_AT)
    assert first.optimizer.lookahead_count == SAVE_AT  # mid cycle of 5
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.step(first, loader_state={"items_consumed": 12})

    resumed = _state(seed=1)  # other initial weights, all overwritten
    assert mgr.load(path, resumed) == SAVE_AT
    got = _train(resumed, batches, SAVE_AT + 1, STEPS)
    for i in range(SAVE_AT + 1, STEPS + 1):
        for k in ref[i]:
            assert torch.equal(got[i][k], ref[i][k]), (i, k)
    a, a_counts = _flat(unbroken)
    b, b_counts = _flat(resumed)
    assert a_counts == b_counts
    assert a_counts["lookahead_count"] == STEPS
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the Lookahead sync at step 5 happened in the resumed run: the weights
    # landed on the slow copy (p + (slow - p), within an fp32 rounding)
    params = dict(resumed.model.named_parameters())
    for name, slow in resumed.optimizer.lookahead_slow_params().items():
        torch.testing.assert_close(slow, params[name].detach(), rtol=0,
                                   atol=1e-6)


def test_step_seed_is_a_function_of_seed_and_iteration():
    assert step_seed(0, 4) == step_seed(0, 4)
    assert len({step_seed(s, i) for s in range(3) for i in range(50)}) == 150
    assert all(0 <= step_seed(0, i) < 2**63 for i in range(10))


@pytest.mark.parametrize("name", ["sgd", "adamw"])
@pytest.mark.parametrize("lookahead", [True, False])
def test_optimizer_state_dict_round_trip(name, lookahead):
    import dataclasses
    optim = dataclasses.replace(OPTIM, optimizer_name=name,
                                lookahead_use=lookahead)
    spec = dataclasses.replace(SPEC, textual_dropout=0.0)
    state = _state(spec=spec, optim=optim)
    first, second = _batches()[:2]
    step = make_train_step(state.model, state.optimizer, ACCUM)
    step(first)
    twin = _state(seed=1, spec=spec, optim=optim)
    twin.model.load_state_dict(state.model.state_dict())
    twin.optimizer.load_state_dict(
        copy.deepcopy(state.optimizer.state_dict()))
    twin_step = make_train_step(twin.model, twin.optimizer, ACCUM)
    assert torch.equal(step(second)["loss"], twin_step(second)["loss"])
    for (n, p), (_, q) in zip(state.model.named_parameters(),
                              twin.model.named_parameters()):
        assert torch.equal(p, q), n
    slow = state.optimizer.lookahead_slow_params()
    if not lookahead:
        assert all(slow[n] is p for n, p in state.model.named_parameters())


def test_optimizer_state_dict_refuses_a_mismatch():
    state = _state()
    saved = state.optimizer.state_dict()
    other = _state(optim=OptimSpec(optimizer_name="adamw"))
    with pytest.raises(ValueError, match="optimizer is"):
        other.optimizer.load_state_dict(saved)
    renamed = dict(saved, trace={f"x.{k}": v
                                 for k, v in saved["trace"].items()})
    with pytest.raises(ValueError, match="names differ"):
        state.optimizer.load_state_dict(renamed)
    no_slow = {k: v for k, v in saved.items() if k != "slow"}
    with pytest.raises(ValueError, match="needs"):
        state.optimizer.load_state_dict(no_slow)


@pytest.fixture(scope="module")
def saved_state():
    return _state()


def test_prune_and_best(tmp_path, saved_state):
    mgr = CheckpointManager(str(tmp_path), keep_recent=2)
    for it, metric in ((1, 0.5), (2, 0.9), (3, 0.7)):
        saved_state.iteration = it
        mgr.step(saved_state, metric=metric)
    entries = set(os.listdir(tmp_path))
    assert "checkpoint_1.pth" not in entries  # pruned
    assert {"checkpoint_2.pth", "checkpoint_3.pth", "checkpoint_best.pth",
            "best.json"} <= entries
    assert not any(e.endswith(".tmp") for e in entries)
    assert mgr.best_metric == 0.9
    assert read_checkpoint(str(tmp_path / "checkpoint_best.pth"))[
        "iteration"] == 2
    with open(tmp_path / "best.json") as f:
        assert json.load(f) == {"iteration": 2, "metric": 0.9}
    assert mgr.latest() == str(tmp_path / "checkpoint_3.pth")
    assert CheckpointManager(str(tmp_path / "empty")).latest() is None


def test_best_metric_survives_resume(tmp_path, saved_state):
    mgr = CheckpointManager(str(tmp_path), keep_recent=5)
    saved_state.iteration = 1
    mgr.step(saved_state, metric=0.9)
    mgr2 = CheckpointManager(str(tmp_path), keep_recent=5)
    assert mgr2.load(mgr2.latest(), _state(seed=2)) == 1
    assert mgr2.best_metric == pytest.approx(0.9)
    saved_state.iteration = 2
    mgr2.step(saved_state, metric=0.5)  # worse: not the best
    assert read_checkpoint(str(tmp_path / "checkpoint_best.pth"))[
        "iteration"] == 1


def test_best_checkpoint_healed_after_a_crash(tmp_path, saved_state):
    mgr = CheckpointManager(str(tmp_path), keep_recent=5)
    saved_state.iteration = 1
    mgr.step(saved_state, metric=0.7)
    saved_state.iteration = 2
    mgr.step(saved_state, metric=0.9)
    # a crash between the save of 2 and its best copy: the best file and
    # its sidecar still hold iteration 1
    saved_state.iteration = 1
    ckpt1 = read_checkpoint(mgr.path(1))
    torch.save(ckpt1, mgr.path("best"))
    with open(tmp_path / "best.json", "w") as f:
        json.dump({"iteration": 1, "metric": 0.7}, f)
    mgr2 = CheckpointManager(str(tmp_path), keep_recent=5)
    assert mgr2.load(mgr2.latest(), _state(seed=2)) == 2
    assert mgr2.best_metric == pytest.approx(0.9)
    assert read_checkpoint(mgr2.path("best"))["iteration"] == 2
    with open(tmp_path / "best.json") as f:
        assert json.load(f)["iteration"] == 2


def test_loader_position_rides_in_the_checkpoint(tmp_path, saved_state):
    class Loader:
        def load_state_dict(self, s):
            self.state = s
    mgr = CheckpointManager(str(tmp_path))
    saved_state.iteration = 4
    mgr.step(saved_state, loader_state={"items_consumed": 1024})
    loader = Loader()
    mgr.load(mgr.latest(), _state(seed=2), loader=loader)
    assert loader.state == {"items_consumed": 1024}


def test_model_part_loads_into_the_jax_package(tmp_path, saved_state):
    from virtex_tpu.utils.checkpoint_convert import (
        convert_virtex_checkpoint,
        load_torch_checkpoint,
    )
    saved_state.iteration = 7
    path = CheckpointManager(str(tmp_path)).step(saved_state)
    sd = load_torch_checkpoint(path)
    own = saved_state.model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    variables = convert_virtex_checkpoint(sd)
    assert "backward_transformer" in variables["params"]["textual"]


def test_a_jax_export_loads_into_the_port_strictly():
    import jax
    import jax.numpy as jnp

    from tests.torch_parity import drawn_variables
    from virtex_tpu.config import Config
    from virtex_tpu.factories import PretrainingModelFactory as JaxFactory
    from virtex_tpu.utils.checkpoint_convert import export_virtex_checkpoint
    cfg = Config(override_list=[
        "MODEL.NAME", "bicaptioning",
        "MODEL.VISUAL.NAME", SPEC.visual_name,
        "MODEL.VISUAL.FEATURE_SIZE", SPEC.visual_feature_size,
        "MODEL.TEXTUAL.NAME", SPEC.textual_name,
        "DATA.VOCAB_SIZE", SPEC.vocab_size,
        "DATA.MAX_CAPTION_LENGTH", SPEC.max_caption_length, "DTYPE",
        "float32"])
    batch = caption_batch(2, 32, SPEC.max_caption_length, SPEC.vocab_size,
                          seed=0)
    variables = drawn_variables(JaxFactory.from_config(cfg), batch, seed=0)
    exported = export_virtex_checkpoint(variables)
    model = PretrainingModelFactory.from_spec(SPEC, device="cpu")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in exported.items()}, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(exported[k]),
                                      err_msg=k)
    del jax, jnp


def test_partial_load_keeps_what_does_not_match(tmp_path, saved_state):
    import dataclasses
    path = CheckpointManager(str(tmp_path)).step(saved_state)
    linear = dataclasses.replace(SPEC, model_name="token_classification",
                                 textual_name="none")
    torch.manual_seed(5)
    model = PretrainingModelFactory.from_spec(linear, device="cpu")
    before = copy.deepcopy(model.state_dict())
    kept = load_model_variables(path, model)
    # the linear head's weight is (vocab, 512), the transformer head's tied
    # one (vocab, 64); the two output biases match in name and shape
    assert kept == ["textual.output.weight"]
    src = saved_state.model.state_dict()
    for k, v in model.state_dict().items():
        want = before[k] if k in kept else src[k]
        assert torch.equal(v, want), k


def test_backbone_weight_init_modes(tmp_path, saved_state):
    path = CheckpointManager(str(tmp_path)).step(saved_state)
    src = saved_state.model.visual.state_dict()
    visual = _state(seed=3).model.visual
    apply_backbone_weight_init(visual, "random", None)
    assert not torch.equal(visual.cnn.conv1.weight, src["cnn.conv1.weight"])
    apply_backbone_weight_init(visual, "virtex", path)
    for k, v in visual.state_dict().items():
        assert torch.equal(v, src[k]), k

    tv = {k[len("cnn."):]: v.clone() + 1 for k, v in src.items()}
    tv["fc.weight"], tv["fc.bias"] = torch.zeros(10, 512), torch.zeros(10)
    torch.save({"state_dict": tv}, tmp_path / "tv.pth")
    apply_backbone_weight_init(visual, "torchvision", str(tmp_path / "tv.pth"))
    assert torch.equal(visual.cnn.conv1.weight, src["cnn.conv1.weight"] + 1)
    del tv["layer1.0.conv1.weight"]
    torch.save(tv, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="missing"):
        apply_backbone_weight_init(visual, "torchvision",
                                   str(tmp_path / "partial.pth"))
    with pytest.raises(ValueError, match="unsupported"):
        apply_backbone_weight_init(visual, "imagenet", None)


class _Payload:
    """Unpickling this calls os.getcwd: a stand-in for code execution."""

    def __reduce__(self):
        return (os.getcwd, ())


def test_a_pickle_that_runs_code_is_refused(tmp_path, saved_state):
    evil = tmp_path / "checkpoint_9.pth"
    torch.save({"model": {"x": _Payload()}, "iteration": 9}, evil)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(pickle.UnpicklingError, match="Weights only"):
        mgr.load(str(evil), _state(seed=2))
    with pytest.raises(pickle.UnpicklingError):
        load_model_variables(str(evil), saved_state.model)
    with pytest.raises(pickle.UnpicklingError):
        apply_backbone_weight_init(saved_state.model.visual, "virtex",
                                   str(evil))
