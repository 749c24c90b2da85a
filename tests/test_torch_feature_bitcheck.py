"""The port's feature bit-check (``virtex_tpu_torch/scripts/
feature_bitcheck.py``) against the JAX package on one ``.pth``.

Each of the five pretext tasks of ``configs/task_ablations`` at a tiny size
(resnet18 at 64², one layer of H128 A4 F256, B 2) gets a ``.pth`` drawn
from a numpy seed (``feature_bitcheck.write_checkpoint``); the JAX
package's model loads it through its model zoo and computes the eval
grid, the train-mode loss and its components and d(loss)/d(image)
(``tests/torch_bitcheck_jax.py``, once per task for the module), and the
port's script, on the CPU, must hold its own results to those at its
gates. The committed golden ``tests/fixtures/torch_bitcheck_golden.npz``
(``python tests/torch_bitcheck_jax.py --golden`` rewrites it) is what
``chip_smoke.py`` holds the card to: the port matches it here, the drawn
files match its sha256, and the JAX side still gives it.

Measured here (largest per-element error over the five tasks): grid
5.2e-5 of its channel's scale (gate 1e-3), losses 3.2e-7 (gate 1e-5),
d(loss)/d(image) 2.4e-5 (gate 5e-3), except token classification, where
one ReLU input of layer3 lies 2.8e-7 from zero and falls on the other side
in JAX: 1.48e-2 as computed, 1.2e-5 with that unit on JAX's side.

A loaded tensor that is wrong must fail the check: the q and k row blocks
of one ``in_proj_weight`` swapped, and the grid's lowest-magnitude nonzero
channel of layer4's last BatchNorm scaled by 1.5 (weight and bias), or
its running variance by 1.5. The JAX script's ``_rel_diff`` (one global
scale) passes that channel's grid at its 1e-3, and passes every check of
the running-variance case.
"""
import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from tests import torch_bitcheck_jax as tj
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from virtex_tpu_torch.scripts import feature_bitcheck as fb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = list(tj.GOLDEN_TASKS)
IDS = [os.path.splitext(os.path.basename(c))[0] for c in CONFIGS]
# The JAX side rerun against the committed golden: one CPU, one program.
RERUN_TOL = 1e-6


def golden() -> dict:
    with np.load(tj.GOLDEN) as f:
        return {k: f[k] for k in f.files}


def golden_task(config: str) -> str:
    """The golden's task name (``MODEL.NAME``) of ``config``."""
    g = golden()
    (task,) = [k.split("/")[0] for k in g
               if k.endswith("/config") and str(g[k]) == config]
    return task


def run(config, pth, *extra, overrides=None):
    """The port's script on the CPU; returns its exit code and output."""
    overrides = tj.GOLDEN_TASKS[config] if overrides is None else overrides
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fb.main(["--config", os.path.join(REPO, config),
                      "--config-override", *overrides,
                      "--checkpoint-path", str(pth), "--device", "cpu",
                      "--seed", str(tj.GOLDEN_SEED),
                      "--batch-size", str(tj.GOLDEN_BATCH), *extra])
    print(out.getvalue())
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Per config: the drawn ``.pth``, its sha256, and the JAX side's npz
    on it."""
    tmp = tmp_path_factory.mktemp("bitcheck")
    out = {}
    for i, (config, overrides) in enumerate(tj.GOLDEN_TASKS.items()):
        pth = tmp / f"task{i}.pth"
        sha = fb.write_checkpoint(os.path.join(REPO, config), overrides,
                                  tj.GOLDEN_SEED, str(pth))
        task, results = tj.jax_results(
            os.path.join(REPO, config), overrides, str(pth),
            tj.GOLDEN_BATCH, tj.GOLDEN_SEED)
        npz = tmp / f"task{i}_jax.npz"
        np.savez(npz, **tj.entries(task, results, config, overrides,
                                   tj.GOLDEN_SEED, tj.GOLDEN_BATCH))
        out[config] = {"pth": pth, "sha": sha, "task": task, "npz": npz,
                       "results": results}
    return out


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_port_matches_the_jax_package(config, jax_side, tmp_path):
    side = jax_side[config]
    mine = tmp_path / "port.npz"
    rc, out = run(config, side["pth"], "--write", str(mine), "--against",
                  str(side["npz"]))
    assert rc == 0, out
    assert f"feature_bitcheck: PASS — {side['task']} on cpu" in out
    with np.load(mine) as f:
        task = side["task"]
        errors = {k: fb.channel_error(f[f"{task}/{k}"], v)
                  for k, v in side["results"].items()}
    print(f"{task}: largest error per key against JAX: "
          + ", ".join(f"{k} {e:.3e}" for k, e in sorted(errors.items())))
    assert errors[fb.GRID] <= fb.GRID_TOL
    assert max(e for k, e in errors.items()
               if k not in (fb.GRID, fb.DIMAGE)) <= fb.LOSS_TOL


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_port_matches_the_golden(config, tmp_path):
    task, g = golden_task(config), golden()
    assert [str(v) for v in g[f"{task}/overrides"]] == tj.GOLDEN_TASKS[config]
    pth = tmp_path / "golden.pth"
    sha = fb.write_checkpoint(os.path.join(REPO, config),
                              tj.GOLDEN_TASKS[config], int(g[f"{task}/seed"]),
                              str(pth))
    assert sha == str(g[f"{task}/checkpoint_sha256"])
    rc, out = run(config, pth, "--against", tj.GOLDEN)
    assert rc == 0, out


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_jax_side_still_gives_the_golden(config, jax_side):
    side, g = jax_side[config], golden()
    task = side["task"]
    assert side["sha"] == str(g[f"{task}/checkpoint_sha256"])
    stored = {k[len(task) + 1:] for k in g if k.startswith(task + "/")}
    assert set(side["results"]) == stored - {
        "config", "overrides", "seed", "batch_size", "checkpoint_sha256"}
    for key, value in side["results"].items():
        assert fb.channel_error(value, g[f"{task}/{key}"]) <= RERUN_TOL, key


def _rel_diff():
    """``scripts/feature_bitcheck.py``'s metric (it imports nothing at
    module level)."""
    spec = importlib.util.spec_from_file_location(
        "jax_feature_bitcheck", os.path.join(REPO, "scripts",
                                             "feature_bitcheck.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._rel_diff


def _low_channel(grid) -> int:
    """The grid's nonzero channel of the smallest max |value|."""
    scale = np.abs(grid).max(axis=(0, 1, 2))
    return int(np.argmin(np.where(scale > 0, scale, np.inf)))


def _perturbed(kind, state, grid):
    state = {k: v.clone() for k, v in state.items()}
    if kind == "qk_swap":
        name = "textual.transformer.layers.0.self_attn.in_proj_weight"
        w = state[name]
        h = w.shape[1]
        state[name] = torch.cat([w[h:2 * h], w[:h], w[2 * h:]])
        return state
    c = _low_channel(grid)
    leaves = (("weight", "bias") if kind == "bn_channel_scale"
              else ("running_var",))
    for leaf in leaves:
        state[f"visual.cnn.layer4.1.bn2.{leaf}"][c] *= 1.5
    return state


@pytest.mark.parametrize("kind", ["qk_swap", "bn_channel_scale",
                                  "bn_channel_variance"])
def test_a_wrong_tensor_fails(kind, jax_side, tmp_path):
    config = CONFIGS[0]   # bicaptioning
    side = jax_side[config]
    state = torch.load(side["pth"], weights_only=True)["model"]
    bad = tmp_path / "bad.pth"
    torch.save({"model": _perturbed(kind, state,
                                    side["results"][fb.GRID])}, bad)
    mine = tmp_path / "port.npz"
    rc, out = run(config, bad, "--write", str(mine), "--against",
                  str(side["npz"]))
    assert rc == 1, out
    assert "feature_bitcheck: FAIL" in out
    if kind == "qk_swap":
        assert "[FAIL] training loss" in out
        return
    assert "[FAIL] layer4 grid" in out
    rel_diff, task = _rel_diff(), side["task"]
    with np.load(mine) as f:
        old = {k: rel_diff(f[f"{task}/{k}"], v)
               for k, v in side["results"].items()}
    print(f"{kind}: _rel_diff per key {old}")
    assert old[fb.GRID] <= 1e-3
    if kind == "bn_channel_variance":   # train mode reads no running stat
        assert all(old[k] <= 1e-3 for k in old if k != fb.DIMAGE)
        assert old[fb.DIMAGE] <= 5e-3


def _port_model(config, pth):
    from virtex_tpu_torch.model_zoo import model_zoo
    return model_zoo.get(os.path.join(REPO, config), pretrained=True,
                         checkpoint_path=str(pth),
                         overrides=tj.GOLDEN_TASKS[config]
                         + fb.FORCED_OVERRIDES, device="cpu")


def test_stored_relu_sides_are_replayed(jax_side, tmp_path):
    """A set the port writes holds the side of every train-mode ReLU input
    near zero; a run whose nearest one falls on the other side fails the
    input gradient as computed and passes with the stored sides taken."""
    config = CONFIGS[3]   # token classification
    pth = jax_side[config]["pth"]
    cpu = torch.device("cpu")
    model, cfg = _port_model(config, pth)
    probe = fb.ReluSides()
    fb.compute(model, cfg, tj.GOLDEN_BATCH, tj.GOLDEN_SEED, cpu, probe)
    call, unit, _ = min(probe.near_zero(fb.RELU_MARGIN),
                        key=lambda u: abs(u[2]))
    model, cfg = _port_model(config, pth)
    flipped = fb.ReluSides(flips=[(call, unit)])
    results = fb.compute(model, cfg, tj.GOLDEN_BATCH, tj.GOLDEN_SEED, cpu,
                         flipped)
    assert flipped.changed == 1
    stored = tmp_path / "stored.npz"
    fb.write(str(stored), cfg.MODEL.NAME, results, {
        "config": np.array(config),
        "overrides": np.array(tj.GOLDEN_TASKS[config], dtype=str),
        "seed": np.array(tj.GOLDEN_SEED),
        "batch_size": np.array(tj.GOLDEN_BATCH),
        **{fb.SIDES + k: v for k, v in flipped.sides().items()}})
    rc, out = run(config, pth, "--against", str(stored))
    assert rc == 0, out
    assert "[FAIL] d(loss)/d(image): err=" in out
    assert "[PASS] d(loss)/d(image) (the stored sides of" in out
    assert "1 of them against this run's" in out


def test_a_checkpoint_that_does_not_fit_fails(jax_side, tmp_path):
    side = jax_side[CONFIGS[0]]
    state = torch.load(side["pth"], weights_only=True)["model"]
    state.pop("textual.transformer.layers.0.linear1.weight")
    state["visual.cnn.fc.weight"] = torch.zeros(3)
    bad = tmp_path / "bad.pth"
    torch.save({"model": state}, bad)
    rc, out = run(CONFIGS[0], bad, "--against", str(side["npz"]))
    assert rc == 1
    assert "missing textual.transformer.layers.0.linear1.weight" in out
    assert "unexpected visual.cnn.fc.weight" in out


def test_stored_set_of_another_seed_fails(jax_side, tmp_path):
    config = CONFIGS[3]   # token classification
    side = jax_side[config]
    rc, out = run(config, side["pth"], "--seed", "0", "--against",
                  str(side["npz"]))
    assert rc == 1
    assert "[FAIL] seed" in out


def test_nothing_to_do_is_refused():
    with pytest.raises(SystemExit) as e:
        fb.main(["--config", "x.yaml", "--checkpoint-path", "x.pth"])
    assert e.value.code == 2


def test_no_card_raises_for_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fb.main(["--config", CONFIGS[0], "--checkpoint-path", "x.pth",
                 "--against", "x.npz"])
