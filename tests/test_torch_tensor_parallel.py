"""Tensor parallelism of the textual head in the PyTorch port on the CPU:
gloo processes on a ``(data, model)`` grid of (1, 2) and (2, 2) against
the port at ``model`` 1 and the JAX package's ``(data, model)`` mesh.

The ranks run ``tests/torch_dist_worker.py tp`` (torch and the port only)
as in ``tests/test_torch_distributed.py``. One spawn per grid serves:

- (a) two train steps (global micro-batch 8 × accum 2, fp32, dropout 0)
  from rank 0's weights against the port at ``model`` 1 on the same global
  batches: the losses and ``grad_norm``, the first step's gradients
  gathered to full names, and the full state after the second step, each
  element within a tolerance of its tensor's scale; the first step's
  all-reduces by kind;
- (b) the same steps against the JAX ``make_train_step`` over
  ``create_mesh(data, model)`` at ``test_torch_distributed.py``'s
  tolerances;
- (c) two steps at dropout 0.1: every replicated parameter and buffer
  bit-equal over the model group after each;
- (e) a checkpoint written at ``model`` 2 holds full tensors, and a run
  resumes from it at ``model`` 1 and from a ``model`` 1 one at ``model``
  2, as an unbroken run goes on.

Then ``pretrain_virtex`` at ``PARALLEL.MODEL`` 2 on two ranks: it trains
with dropout, validates, writes full checkpoints on rank 0 that a
``model`` 1 model loads, and a resumed run is bit-equal to the unbroken
one.

In one process: (d) the shard table against ``_TP_RULES`` through the
weight bridge's names, the refusal of an indivisible layout, and the
grid's groups.
"""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_distributed import (
    CONFIG,
    _micro,
    _pretrain_args,
    _pretrain_overrides,
    _step_overrides,
    run_ranks,
)
from tests.torch_dist_worker import _tp_resume_check, _tp_step_check
from tests.torch_parity import (
    caption_batch,
    jax_variables,
    one_torch_thread,  # noqa: F401 (autouse)
    rel_err,
)
from virtex_tpu_torch.parallel import Mesh
from virtex_tpu_torch.parallel.mesh import (
    TP_RULES,
    check_divisible,
    create_mesh,
    shard_state_dict,
    tp_split,
)

GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
TEXTUAL = "transdec_postnorm::L1_H64_A4_F128"
MICRO, ACCUM, STEPS, IMAGE = 8, 2, 2, 64
# (a): the port at model 2 against model 1. fp32 sums of the shards'
# partials in another order; the ResNet's gradients move more where a
# last-bit difference flips a ReLU (tests/test_torch_distributed.py).
TOL, VISUAL_TOL, LOSS_RTOL = 1e-5, 1e-4, 1e-6
ONE = Mesh(data=1, rank=0, group=None)


def _overrides():
    return _step_overrides() + ["MODEL.TEXTUAL.NAME", TEXTUAL]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the port at model 1 in this process, and each grid's
    ranks."""
    from virtex_tpu.config import Config as JaxConfig
    from virtex_tpu.factories import PretrainingModelFactory as JaxModels
    from virtex_tpu_torch.utils.weights import state_dict_from_flax

    tmp = tmp_path_factory.mktemp("tp")
    cfg = JaxConfig(override_list=_overrides())
    batches = [caption_batch(MICRO * ACCUM, IMAGE,
                             cfg.DATA.MAX_CAPTION_LENGTH, cfg.DATA.VOCAB_SIZE,
                             seed=20 + s) for s in range(STEPS)]
    variables = jax_variables(JaxModels.from_config(cfg), batches[0], seed=1,
                              output_bias_std=1.0)
    step = {"overrides": _overrides(), "accum": ACCUM,
            "state_dict": state_dict_from_flax(variables),
            "batches": [_micro(b) for b in batches]}
    one = {"step": _tp_step_check(step, ONE)}
    _tp_resume_check(dict(step, save_dir=str(tmp / "m1")), ONE)
    specs = {name: {"grid": grid, "step": step}
             for name, grid in GRIDS.items()}
    specs["1x2"]["resume"] = {"save_dir": str(tmp / "m2"), "resume_from":
                              str(tmp / "m1" / "checkpoint_1.pth")}
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as pool:
        futures = {name: pool.submit(run_ranks, "tp", spec, tmp / name,
                                     world=spec["grid"][0] * spec["grid"][1])
                   for name, spec in specs.items()}
        ranks = {name: f.result() for name, f in futures.items()}
    one["resume"] = _tp_resume_check(dict(
        step, resume_from=str(tmp / "m2" / "checkpoint_1.pth")), ONE)
    return {"cfg": cfg, "variables": variables, "step": step, "one": one,
            "ranks": ranks, "tmp": tmp}


def _close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for name, ref in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == int(ref), (what, name)
            continue
        t = VISUAL_TOL if name.startswith("visual.") else tol
        err = rel_err(got[name], ref, float(ref.abs().max()) + 1e-12)
        assert err <= t, (what, name, err)


def _metrics_close(got, want, rtol):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= rtol * abs(v), (k, got, want)


@pytest.mark.parametrize("grid", GRIDS)
def test_train_step_on_the_grid_matches_the_port_at_model_1(runs, grid):
    one = runs["one"]["step"]
    ranks = [r["step"] for r in runs["ranks"][grid]]
    data, model = GRIDS[grid]
    for r in ranks:
        # every rank reports the same metrics and holds the same full state
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        _metrics_close(got, want, LOSS_RTOL)
    _close(ranks[0]["grads"], one["grads"], TOL, "grads")
    _close(ranks[0]["state"], one["state"], TOL, "state")
    opt = ranks[0]["optimizer"]
    assert opt["step_count"] == STEPS
    _close(opt["slow"], one["optimizer"]["slow"], TOL, "slow")
    # The momentum holds the second step's raw gradients. With the batch
    # split over data ranks, the ResNet's flip ReLUs there (a last-bit
    # difference; tests/test_torch_distributed.py): the first step's
    # gradients and the parameters above hold it.
    trace = {k: v for k, v in one["optimizer"]["trace"].items()
             if data == 1 or not k.startswith("visual.")}
    _close({k: opt["trace"][k] for k in trace}, trace, TOL, "trace")
    # Per micro-step: resnet18's 20 BatchNorm layers and the two losses'
    # denominators over the data group; in each of the two decoders the
    # inputs of four column-split blocks (self-attention, cross-attention's
    # x and visual tokens, FFN) in the backward and three row-split sums in
    # the forward; per step one gradient, one clip-norm and one metrics
    # all-reduce. No gather in a step.
    n = ACCUM
    assert ranks[0]["counts"] == {
        "bn_stats": 20 * n, "bn_sums": 20 * n, "loss_count": 2 * n,
        "tp_copy": 2 * 4 * n, "tp_reduce": 2 * 3 * n, "grads": 1,
        "grad_norm": 1, "metrics": 1}
    assert data * model == len(ranks)


def _jax_mesh_steps(cfg, variables, batches, data, model):
    from virtex_tpu.engine.train_state import TrainState
    from virtex_tpu.engine.trainer import make_train_step, place_state
    from virtex_tpu.factories import OptimizerFactory
    from virtex_tpu.factories import PretrainingModelFactory as JaxModels
    from virtex_tpu.parallel import create_mesh as jax_create_mesh
    from virtex_tpu.parallel import shard_batch as jax_shard_batch
    from virtex_tpu_torch.utils.weights import state_dict_from_flax

    mesh = jax_create_mesh(data=data, model=model,
                           devices=jax.devices()[:data * model])
    jm = JaxModels.from_config(cfg)
    tx = OptimizerFactory.from_config(cfg, variables["params"])
    state = place_state(TrainState.create(
        variables["params"], variables["batch_stats"], tx), mesh)
    step = make_train_step(jm, tx, mesh=mesh, donate=False, jit=True,
                           accum_steps=ACCUM)
    metrics = []
    with mesh:
        for b in batches:
            state, m = step(state, jax_shard_batch(b, mesh, micro=True),
                            jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    return metrics, state_dict_from_flax(final)


@pytest.mark.parametrize("grid", GRIDS)
def test_train_step_on_the_grid_matches_the_jax_mesh(runs, grid):
    data, model = GRIDS[grid]
    ref, ref_final = _jax_mesh_steps(runs["cfg"], runs["variables"],
                                     runs["step"]["batches"], data, model)
    got = runs["ranks"][grid][0]["step"]
    for step, (a, r) in enumerate(zip(got["metrics"], ref)):
        assert set(a) == set(r)
        for k in ("loss", "captioning_forward", "captioning_backward"):
            assert abs(a[k] - r[k]) <= 1e-5 * abs(r[k]), (step, k, a, r)
        assert abs(a["grad_norm"] - r["grad_norm"]) \
            <= 1e-3 * r["grad_norm"], (step, a, r)
    final = got["state"]
    assert sorted(final) == sorted(ref_final)
    for name, ref_value in ref_final.items():
        if name.endswith("num_batches_tracked"):
            assert int(final[name]) == STEPS * ACCUM, name
            continue
        ref_value = ref_value.numpy()
        scale = float(np.abs(ref_value).max()) + 1e-12
        tol = 1e-2 if name.startswith("visual.") else 1e-4
        assert rel_err(final[name], ref_value, scale) <= tol, name


@pytest.mark.parametrize("grid", GRIDS)
def test_replicated_tensors_stay_bit_equal_over_the_model_group_with_dropout(
        runs, grid):
    data, model = GRIDS[grid]
    ranks = runs["ranks"][grid]
    for d in range(data):
        group = [ranks[d * model + m]["dropout"] for m in range(model)]
        assert all(g["metrics"] == group[0]["metrics"] for g in group)
        for step in range(STEPS):
            first = group[0]["states"][step]
            for other in group[1:]:
                split = 0
                for name, v in other["states"][step].items():
                    if tp_split(name) is None:
                        assert torch.equal(v, first[name]), (step, name)
                    else:  # another shard (a zero bias may equal its twin)
                        split += not torch.equal(v, first[name])
                assert split >= 2 * 4, step  # two decoders' split weights
    # the ranks of a data group hold one shard and take one update
    for m in range(model):
        for d in range(1, data):
            last = ranks[d * model + m]["dropout"]["states"][-1]
            for name, v in ranks[m]["dropout"]["states"][-1].items():
                assert torch.equal(v, last[name]), (m, d, name)


def test_a_checkpoint_resumes_across_model_sizes(runs):
    """checkpoint_1 written at model 2 holds the full tensors of the
    model-1 run's checkpoint_1 (within the grid's tolerance); the second
    step resumed from it at model 1 equals the unbroken model-2 run's, and
    the model-2 ranks resumed from the model-1 checkpoint equal the
    unbroken model-1 run's."""
    from virtex_tpu_torch.engine.checkpointing import read_checkpoint

    tmp = runs["tmp"]
    m1 = read_checkpoint(str(tmp / "m1" / "checkpoint_1.pth"))
    m2 = read_checkpoint(str(tmp / "m2" / "checkpoint_1.pth"))
    assert m2["iteration"] == m1["iteration"] == 1
    _close(m2["model"], m1["model"], TOL, "checkpoint")
    for key in ("trace", "slow"):
        _close(m2["optimizer"][key], m1["optimizer"][key], TOL, key)
    unbroken_m2 = runs["ranks"]["1x2"][0]["step"]
    unbroken_m1 = runs["one"]["step"]
    resumed_m1 = runs["one"]["resume"]
    _metrics_close(resumed_m1["metrics"], unbroken_m2["metrics"][1],
                   LOSS_RTOL)
    _close(resumed_m1["state"], unbroken_m2["state"], TOL, "resumed at 1")
    for r in runs["ranks"]["1x2"]:
        _metrics_close(r["resume"]["metrics"], unbroken_m1["metrics"][1],
                       LOSS_RTOL)
        _close(r["resume"]["state"], unbroken_m1["state"], TOL,
               "resumed at 2")


def test_pretrain_at_model_2_trains_validates_saves_and_resumes(tmp_path):
    from tests.utils_fixtures import make_fake_coco, make_tokenizer
    from virtex_tpu_torch.config import Config, ModelSpec
    from virtex_tpu_torch.engine.checkpointing import read_checkpoint
    from virtex_tpu_torch.factories import PretrainingModelFactory

    root = make_fake_coco(str(tmp_path / "coco"), n_images=8)
    ov = _pretrain_overrides(root, make_tokenizer(tmp_path).model_path,
                             iters=4) + ["PARALLEL.MODEL", "2"]
    run, again = tmp_path / "run", tmp_path / "resumed"

    def args(path, *extra):
        out = _pretrain_args(path, ov, *extra)
        out[out.index("--checkpoint-every") + 1] = "2"
        return out

    out = run_ranks("cli", {"script": "pretrain_virtex",
                            "args": args(run)}, tmp_path / "unbroken")
    r0, r1 = (o["result"] for o in out)
    assert r0["losses"] == r1["losses"] and r0["val"] == r1["val"]
    assert sorted(r0["val"]) == [2, 4]
    assert all(np.isfinite(list(r0["losses"].values())))
    assert out[1]["writes"] == []
    assert {"tp_copy", "tp_reduce", "grad_norm", "tp_gather"} \
        <= set(out[0]["all_reduce_counts"])
    # full tensors: a model-1 model loads them as they are
    ckpt = read_checkpoint(str(run / "checkpoint_4.pth"))
    model = PretrainingModelFactory.from_spec(ModelSpec.from_config(
        Config(CONFIG, ov)), device="cpu")
    model.load_state_dict(ckpt["model"], strict=True)
    resumed = run_ranks("cli", {"script": "pretrain_virtex", "args": args(
        again, "--resume-from", str(run / "checkpoint_2.pth"))},
        tmp_path / "resumed_out")
    assert resumed[0]["result"]["losses"] == {i: r0["losses"][i]
                                              for i in (3, 4)}
    b = read_checkpoint(str(again / "checkpoint_4.pth"))
    for k, v in ckpt["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in ckpt["optimizer"].items():
        if isinstance(v, dict):
            for n, t in v.items():
                assert torch.equal(t, b["optimizer"][k][n]), (k, n)


# -- in one process ------------------------------------------------------------
def test_the_shard_table_splits_what_tp_rules_split(runs):
    """Every JAX parameter that ``param_sharding`` splits at model 2 is
    split in the port, on the same axis, and nothing else is."""
    from jax.sharding import PartitionSpec as P

    from virtex_tpu.parallel.mesh import param_sharding
    from virtex_tpu_torch.utils.weights import flax_name_map

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                             ("data", "model"))
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: specs.__setitem__(".".join(
            str(getattr(k, "key", k)) for k in path), s.spec),
        param_sharding(runs["variables"]["params"], mesh))
    # A JAX spec → the port's split: flax kernels are (in, out), torch
    # weights (out, in); a split output is the port's rows (packed by q,
    # k and v in in_proj_*).
    want_axis = {P(None, "model"): "rows", P("model"): "rows",
                 P("model", None): "cols", P(): None}
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    params = [n for n in runs["step"]["state_dict"]
              if not n.endswith(buffers) and n != "textual.output.weight"
              and (not n.startswith("backward_textual.")
                   or ".transformer." in n)]
    split = 0
    for name, jax_names in flax_name_map(params).items():
        wants = {want_axis[specs[j]] for j in jax_names}
        assert len(wants) == 1, (name, jax_names)
        got = tp_split(name)
        want = wants.pop()
        if got == "qkv":
            assert len(jax_names) == 3 and want == "rows", name
        else:
            assert got == want, (name, got, want)
        split += got is not None
    # per decoder: q/k/v kernel and bias of two attentions, their outputs'
    # kernels, the FFN's intermediate kernel and bias and output kernel;
    # two decoders (forward and backward)
    assert split == 2 * (2 * 2 + 2 + 3)
    assert len(TP_RULES) == 4


def test_shard_state_dict_cuts_the_packed_projection_by_heads():
    H, m = 8, 2
    w = torch.arange(3 * H * 2, dtype=torch.float32).view(3 * H, 2)
    name = "textual.transformer.layers.0.self_attn.in_proj_weight"
    shards = [shard_state_dict({name: w}, Mesh(data=1, rank=r, group=None,
                                               model=m))[name]
              for r in range(m)]
    for r, s in enumerate(shards):
        assert s.shape == (3 * H // m, 2)
        for i in range(3):  # q, k and v rows of heads [r·H/m, (r+1)·H/m)
            rows = slice(i * H + r * H // m, i * H + (r + 1) * H // m)
            block = slice(i * H // m, (i + 1) * H // m)
            assert torch.equal(s[block], w[rows])
    bias = "textual.transformer.layers.0.linear2.bias"
    assert shard_state_dict({bias: w}, Mesh(1, 1, None, model=2))[bias] is w


def test_indivisible_layouts_are_refused_by_name():
    check_divisible({"attention_heads": 16, "feedforward_size": 4096}, 2)
    with pytest.raises(ValueError, match="attention heads 4 is not "
                       "divisible by 3"):
        check_divisible({"attention_heads": 4, "feedforward_size": 12}, 3)
    with pytest.raises(ValueError, match="feed-forward size 30 is not "
                       "divisible by 4"):
        check_divisible({"attention_heads": 4, "feedforward_size": 30}, 4)
    with pytest.raises(ValueError, match="PARALLEL.MODEL = 2: the model "
                       "axis must divide"):
        create_mesh(model=2)
    assert Mesh(data=2, rank=3, group=None, model=2).data_rank == 1
    assert Mesh(data=2, rank=3, group=None, model=2).model_rank == 1


def test_decode_refuses_a_sharded_layer():
    from virtex_tpu_torch.modules.transformer import MultiHeadAttention
    attn = MultiHeadAttention(16, 4, 0.0, torch.float32)
    attn.shards = 2
    x = torch.zeros(1, 1, 16)
    with pytest.raises(ValueError, match="sharded 2 ways"):
        attn.project_kv(x)
    with pytest.raises(ValueError, match="publishes its model group"):
        attn(x, x)

