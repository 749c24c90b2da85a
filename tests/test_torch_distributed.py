"""Data parallelism in the PyTorch port on the CPU: two gloo processes
against the JAX package's ``data`` mesh on the suite's virtual CPU devices.

The ranks run ``tests/torch_dist_worker.py`` (torch and the port only) as
subprocesses that join over torchrun's environment on a port taken by
binding port 0. One spawn of ``checks`` serves the op and train-step
parity checks:

- ``bn_train`` forward and backward against the JAX ``bn_train`` under an
  8-device mesh (``tests/test_kernel_mesh.py``'s recipe, Pallas in
  interpret mode): dx, dγ, dβ (the ranks' local sums added), mean, var;
- the "batch" sampler at stride 4 against the JAX module on the sharded
  global batch, the prefix on rank 0 alone (rank 1 holds none of it) and
  a batch too small to sample;
- a 2-rank train step (accum 2, fp32, dropout 0) against the JAX
  ``make_train_step`` over ``create_mesh(data=2)`` on the same global
  batches laid out by ``shard_batch(micro=True)``, at
  ``test_torch_train_step.py``'s tolerances, rank 1 starting from other
  weights that the broadcast replaces;
- its remat twin's step, bit-equal to it;
- each rank's dropout stream.

Then the CLIs at world size 2: ``pretrain_virtex`` (loader shards, rank 0's
checkpoints, ``items_consumed`` per host, a resumed run bit-equal to the
unbroken one), ``clf_linear`` (the fine-tune, BatchNorm synced) and
``eval_captioning`` against their world-1 runs.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist_worker import local_rows
from tests.torch_parity import (
    caption_batch,
    jax_variables,
    one_torch_thread,  # noqa: F401 (autouse)
    rel_err,
)
from tests.utils_fixtures import make_fake_coco, make_tokenizer
from virtex_tpu_torch.engine.train_state import step_seed
from virtex_tpu_torch.ops import _mesh
from virtex_tpu_torch.ops.batchnorm import bn_backward_dx_reference
from virtex_tpu_torch.parallel import Mesh, create_mesh
from virtex_tpu_torch.parallel import shard_batch
from virtex_tpu_torch.utils import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "_base_bicaptioning_R_50_L1_H1024.yaml")
PROBE = os.path.join(REPO, "configs", "downstream", "imagenet_clf.yaml")
WORLD, EPS = 2, 1e-5
# The train step: global micro-batch 8 (4 per rank) x accum 2, 2 steps.
MICRO, ACCUM, STEPS, IMAGE = 8, 2, 2, 64
# The sampler's two cases: B 32 (div 4: a prefix of 8 images, all on rank
# 0) and B 8 (div 1: exact statistics), NHWC (B, 4, 4, 16).
SAMPLER_BATCHES = (32, 8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: str, spec: dict, out, world: int = WORLD,
              timeout: float = 600) -> list:
    """``world`` ranks of ``tests.torch_dist_worker <job>``; each rank's
    output, in rank order."""
    os.makedirs(out, exist_ok=True)
    spec = dict(spec, out=str(out))
    path = os.path.join(out, "spec.pt")
    torch.save(spec, path)
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_worker", job, path],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for r, (p, log) in enumerate(procs):
            rc = p.wait(timeout=timeout)
            log.close()
            with open(os.path.join(out, f"rank{r}.log")) as f:
                assert rc == 0, f"rank {r} exited {rc}:\n{f.read()[-4000:]}"
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the JAX side --------------------------------------------------------------
@pytest.fixture
def interpret_mode(monkeypatch):
    import functools

    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax_mesh(n):
    from jax.sharding import Mesh as JaxMesh
    return JaxMesh(np.array(jax.devices()[:n]).reshape(n, 1),
                   ("data", "model"))


def _bn_spec():
    rng = np.random.RandomState(0)
    return {"x": (3 * rng.randn(16, 8, 8, 128) + 1).astype(np.float32),
            "w": rng.randn(16, 8, 8, 128).astype(np.float32),
            "scale": (1 + 0.2 * rng.randn(128)).astype(np.float32),
            "bias": (0.1 * rng.randn(128)).astype(np.float32), "eps": EPS}


def _sampler_spec(B):
    rng = np.random.RandomState(B)
    C = 16
    return {"x": (2 * rng.randn(B, 4, 4, C) + 0.5).astype(np.float32),
            "w": rng.randn(B, 4, 4, C).astype(np.float32),
            "state": {"weight": (1 + 0.2 * rng.randn(C)).astype(np.float32),
                      "bias": (0.1 * rng.randn(C)).astype(np.float32),
                      "running_mean": (0.1 * rng.randn(C)).astype(np.float32),
                      "running_var": rng.uniform(0.5, 1.5, C).astype(
                          np.float32),
                      "num_batches_tracked": torch.tensor(0)}}


def _step_overrides():
    from tests.torch_parity import tiny_config
    base = tiny_config()
    return ["MODEL.NAME", base.MODEL.NAME,
            "MODEL.VISUAL.NAME", base.MODEL.VISUAL.NAME,
            "MODEL.VISUAL.FEATURE_SIZE", base.MODEL.VISUAL.FEATURE_SIZE,
            "MODEL.TEXTUAL.NAME", base.MODEL.TEXTUAL.NAME,
            "DATA.MAX_CAPTION_LENGTH", base.DATA.MAX_CAPTION_LENGTH,
            "DTYPE", "float32", "MODEL.TEXTUAL.DROPOUT", 0.0,
            "OPTIM.WARMUP_STEPS", 1, "OPTIM.LOOKAHEAD.STEPS", 2]


def _micro(batch):
    return {k: v.reshape((ACCUM, v.shape[0] // ACCUM) + v.shape[1:])
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    """The ranks' outputs, and the inputs they were given."""
    from virtex_tpu.config import Config as JaxConfig
    from virtex_tpu.factories import PretrainingModelFactory as JaxModels
    from virtex_tpu_torch.utils.weights import state_dict_from_flax

    overrides = _step_overrides()
    cfg = JaxConfig(override_list=overrides)
    batches = [caption_batch(MICRO * ACCUM, IMAGE,
                             cfg.DATA.MAX_CAPTION_LENGTH, cfg.DATA.VOCAB_SIZE,
                             seed=10 + s) for s in range(STEPS)]
    variables = jax_variables(JaxModels.from_config(cfg), batches[0], seed=0,
                              output_bias_std=1.0)
    spec = {"bn": _bn_spec(),
            "sampler": [_sampler_spec(B) for B in SAMPLER_BATCHES],
            "step": {"overrides": overrides, "accum": ACCUM,
                     "state_dict": state_dict_from_flax(variables),
                     "batches": [_micro(b) for b in batches]},
            "dropout": {"seed": 7, "iteration": 3}}
    out = run_ranks("checks", spec, tmp_path_factory.mktemp("checks"))
    return spec, out, cfg, variables


def test_bn_train_on_two_ranks_matches_the_jax_mesh(checks, interpret_mode):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from virtex_tpu.ops import batchnorm as JBN
    from virtex_tpu.ops._mesh import wrap_step_fn

    spec, out, _, _ = checks
    s = spec["bn"]
    x, w = jnp.asarray(s["x"]), jnp.asarray(s["w"])
    scale, bias = jnp.asarray(s["scale"]), jnp.asarray(s["bias"])

    def loss(x, sc, b):
        y, _, _ = JBN.bn_train(x, sc, b, EPS, jnp.float32, True)
        return jnp.sum(y * w)

    def stats(x):
        return JBN.bn_train(x, scale, bias, EPS, jnp.float32, True)

    mesh = _jax_mesh(8)
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    with mesh:
        dx, dscale, dbias = wrap_step_fn(
            jax.jit(jax.grad(loss, argnums=(0, 1, 2))), mesh)(xs, scale, bias)
        y, mean, var = wrap_step_fn(jax.jit(stats), mesh)(xs)
    ranks = [o["bn"] for o in out]
    got = {"dx": torch.cat([r["dx"] for r in ranks]),
           "y": torch.cat([r["y"] for r in ranks]),
           # the local sums; the train step's gradient all-reduce adds them
           "dscale": sum(r["dscale"] for r in ranks),
           "dbias": sum(r["dbias"] for r in ranks)}
    want = {"dx": dx, "y": y, "dscale": dscale, "dbias": dbias}
    for k, ref in want.items():
        ref = np.asarray(ref)
        assert rel_err(got[k], ref, float(np.abs(ref).max())) <= 1e-5, k
    # Both ranks hold the global statistics (8 ranks' worth in JAX).
    for r in ranks:
        assert rel_err(r["mean"], np.asarray(mean), 1e-3) <= 1e-5
        assert rel_err(r["var"], np.asarray(var), 1e-3) <= 1e-5
    # One all-reduce of the forward's statistics, one of K4's sums.
    assert out[0]["bn"]["all_reduce_counts"] == {"bn_stats": 1, "bn_sums": 1}
    # The local sums alone are not the gradient: each is about half of it.
    assert rel_err(ranks[0]["dscale"], np.asarray(dscale),
                   float(np.abs(np.asarray(dscale)).max())) > 1e-2


@pytest.mark.parametrize("case", range(len(SAMPLER_BATCHES)),
                         ids=[f"B{b}" for b in SAMPLER_BATCHES])
def test_sampler_at_stride_4_on_two_ranks_matches_the_jax_module(checks,
                                                                 case):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from virtex_tpu.modules.normalization import SubsampledBatchNorm

    spec, out, _, _ = checks
    s = spec["sampler"][case]
    st = s["state"]
    module = SubsampledBatchNorm(momentum=0.9, epsilon=EPS,
                                 dtype=jnp.float32, stat_stride=4)
    w = jnp.asarray(s["w"])

    def loss(x, params):
        y, upd = module.apply({"params": params,
                               "batch_stats": {"mean": st["running_mean"],
                                               "var": st["running_var"]}},
                              x, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    params = {"scale": jnp.asarray(st["weight"]),
              "bias": jnp.asarray(st["bias"])}
    mesh = _jax_mesh(WORLD)
    xs = jax.device_put(jnp.asarray(s["x"]), NamedSharding(mesh, P("data")))
    with mesh:
        (_, (y, stats)), (dx, dp) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(xs, params)
    ranks = out[0]["sampler"][case], out[1]["sampler"][case]
    got = {"y": torch.cat([r["y"] for r in ranks]),
           "dx": torch.cat([r["dx"] for r in ranks]),
           "dscale": sum(r["dscale"] for r in ranks),
           "dbias": sum(r["dbias"] for r in ranks)}
    want = {"y": y, "dx": dx, "dscale": dp["scale"], "dbias": dp["bias"]}
    for k, ref in want.items():
        ref = np.asarray(ref)
        assert rel_err(got[k], ref, float(np.abs(ref).max())) <= 1e-5, k
    # The statistics' all-reduce, and its backward's; no K4.
    assert ranks[1]["all_reduce_counts"] == {"bn_stats": 2}
    for r in ranks:
        assert rel_err(r["running_mean"], np.asarray(stats["mean"]),
                       1e-3) <= 1e-5
        assert rel_err(r["running_var"], np.asarray(stats["var"]),
                       1e-3) <= 1e-5


def _run_jax_mesh_steps(cfg, variables, batches):
    from virtex_tpu.engine.train_state import TrainState
    from virtex_tpu.engine.trainer import make_train_step as jax_train_step
    from virtex_tpu.engine.trainer import place_state
    from virtex_tpu.factories import OptimizerFactory
    from virtex_tpu.factories import PretrainingModelFactory as JaxModels
    from virtex_tpu.parallel import create_mesh as jax_create_mesh
    from virtex_tpu.parallel import shard_batch as jax_shard_batch
    from virtex_tpu_torch.utils.weights import state_dict_from_flax

    mesh = jax_create_mesh(data=WORLD, model=1,
                           devices=jax.devices()[:WORLD])
    jm = JaxModels.from_config(cfg)
    tx = OptimizerFactory.from_config(cfg, variables["params"])
    state = place_state(TrainState.create(
        variables["params"], variables["batch_stats"], tx), mesh)
    step = jax_train_step(jm, tx, mesh=mesh, donate=False, jit=True,
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


def test_two_rank_train_step_matches_the_jax_data_mesh(checks):
    spec, out, cfg, variables = checks
    ref, ref_final = _run_jax_mesh_steps(cfg, variables,
                                         spec["step"]["batches"])
    got = [o["step"] for o in out]
    # Every rank takes the same update and reports the same metrics.
    assert got[0]["metrics"] == got[1]["metrics"]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    for step, (a, r) in enumerate(zip(got[0]["metrics"], ref)):
        assert set(a) == set(r)
        for k in ("loss", "captioning_forward", "captioning_backward"):
            assert abs(a[k] - r[k]) <= 1e-5 * abs(r[k]), (step, k, a, r)
        assert abs(a["grad_norm"] - r["grad_norm"]) \
            <= 1e-3 * r["grad_norm"], (step, a, r)
    final = got[0]["state"]
    assert sorted(final) == sorted(ref_final)
    for name, ref_value in ref_final.items():
        if name.endswith("num_batches_tracked"):
            assert int(final[name]) == STEPS * ACCUM, name
            continue
        ref_value = ref_value.numpy()
        scale = float(np.abs(ref_value).max()) + 1e-12
        tol = 1e-2 if name.startswith("visual.") else 1e-4
        assert rel_err(final[name], ref_value, scale) <= tol, name
    # Per micro-step, in each of resnet18's 20 BatchNorm layers the
    # forward statistics and K4's sums, and the denominators of the two
    # caption losses; per step one gradient and one metrics all-reduce.
    n = STEPS * ACCUM
    assert got[0]["all_reduce_counts"] == {
        "bn_stats": 20 * n, "bn_sums": 20 * n, "loss_count": 2 * n,
        "grads": STEPS, "metrics": STEPS}


def test_remat_step_on_two_ranks_equals_the_plain_step(checks):
    """The recomputation runs in autograd's thread, where the published
    group must be set again: its BatchNorm takes the global statistics the
    first forward took, and the step's bits are the plain step's."""
    _, out, _, _ = checks
    for o in out:
        plain, remat = o["remat"]["plain"], o["remat"]["remat"]
        for k, v in plain["state"].items():
            assert torch.equal(v, remat["state"][k]), k
        # the recomputed blocks all-reduce their statistics once more: the
        # 19 BatchNorm layers of resnet18's residual blocks (not the
        # stem's), in each micro-step
        assert remat["counts"]["bn_stats"] \
            == plain["counts"]["bn_stats"] + 19 * ACCUM
        assert {k: v for k, v in remat["counts"].items() if k != "bn_stats"} \
            == {k: v for k, v in plain["counts"].items() if k != "bn_stats"}


def test_step_seed_of_rank_0_is_the_single_process_seed_and_ranks_differ(
        checks):
    _, out, _, _ = checks
    for it in (0, 1, 17):
        want = int(np.random.SeedSequence((7, it)).generate_state(
            1, np.uint64)[0] >> 1)
        assert step_seed(7, it) == step_seed(7, it, rank=0) == want
        assert step_seed(7, it, rank=1) != want
    gen = torch.Generator().manual_seed(step_seed(7, 3))
    single = int(torch.randint(2**31 - 1, (), generator=gen))
    d0, d1 = out[0]["dropout"], out[1]["dropout"]
    assert d0["seed"] == single != d1["seed"]
    assert not torch.equal(d0["keep"], d1["keep"])
    assert 0.8 < float(d0["keep"].float().mean()) < 1.0


# -- in one process ------------------------------------------------------------
def test_dx_reference_with_m_total_matches_jax_on_the_doubled_batch(
        interpret_mode):
    """Stage 2's plain version on one half of a batch, with the sums of the
    whole and ``m_total`` its count, against the JAX dx of the whole."""
    from virtex_tpu.ops import batchnorm as JBN
    from virtex_tpu_torch.ops.batchnorm import bn_backward_sums_reference

    s = _bn_spec()
    x, w = jnp.asarray(s["x"]), jnp.asarray(s["w"])
    scale, bias = jnp.asarray(s["scale"]), jnp.asarray(s["bias"])

    def loss(x):
        y, _, _ = JBN.bn_train(x, scale, bias, EPS, jnp.float32, True)
        return jnp.sum(y * w)

    dx = np.asarray(jax.grad(loss)(x))
    xt = torch.from_numpy(s["x"]).permute(0, 3, 1, 2)
    dy = torch.from_numpy(s["w"]).permute(0, 3, 1, 2) \
        * torch.from_numpy(s["scale"])[None, :, None, None]
    mean = xt.mean((0, 2, 3))
    var = (xt.square().mean((0, 2, 3)) - mean.square()).clamp(min=0.0)
    rstd = 1.0 / torch.sqrt(var + EPS)
    sums = bn_backward_sums_reference(dy, xt, mean, rstd)
    half = slice(0, 8)
    M = 8 * 8 * 8
    got = bn_backward_dx_reference(
        dy[half], xt[half], mean, rstd, torch.ones(128), sums,
        m_total=2 * M).permute(0, 2, 3, 1)
    scale_ = float(np.abs(dx).max())
    assert rel_err(got, dx[half], scale_) <= 1e-5
    # the local count gives dx terms twice too large
    local = bn_backward_dx_reference(
        dy[half], xt[half], mean, rstd, torch.ones(128), sums
    ).permute(0, 2, 3, 1)
    assert rel_err(local, dx[half], scale_) > 1e-2
    with pytest.raises(ValueError, match="m_total"):
        bn_backward_dx_reference(dy[half], xt[half], mean, rstd,
                                 torch.ones(128), sums, m_total=M - 1)


def test_without_a_group_everything_is_one_process():
    assert not torch.distributed.is_initialized()
    assert distributed.initialize(backend="gloo") is False
    assert (distributed.get_world_size(), distributed.get_rank()) == (1, 0)
    assert distributed.is_master_process()
    distributed.synchronize()
    assert distributed.average_across_processes(2.5) == 2.5
    assert distributed.average_across_processes({"a": 1.0}) == {"a": 1.0}
    assert distributed.broadcast_object("x") == "x"
    assert distributed.gather_objects([1]) == [[1]]
    assert distributed.device_mem_usage_mb() == 0.0
    assert distributed.default_backend("cuda:0") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"
    mesh = create_mesh()
    assert mesh == Mesh(data=1, rank=0, group=None)
    assert _mesh.active_group() is None
    count = torch.tensor(0.0)
    assert float(_mesh.mean_denominator(count)) == 1.0
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize(num_processes=2, backend="gloo")


def test_shard_batch_lays_out_micro_steps_and_local_rows_takes_a_shard():
    batch = {"a": np.arange(16).reshape(8, 2)}
    mesh = Mesh(data=2, rank=1, group=None)
    rows = local_rows(batch, mesh)
    assert rows["a"].tolist() == batch["a"][4:].tolist()
    micro = batch["a"].reshape(2, 4, 2)
    assert local_rows({"a": micro}, mesh, micro=True)["a"].tolist() \
        == micro[:, 2:].tolist()
    out = shard_batch(rows, torch.device("cpu"), accum=2)
    assert tuple(out["a"].shape) == (2, 2, 2)
    # micro-step j of a rank is its rows of global micro-step j
    assert out["a"][1].tolist() == batch["a"][6:8].tolist()
    assert tuple(shard_batch(rows, torch.device("cpu"))["a"].shape) == (4, 2)
    with pytest.raises(ValueError, match="micro-steps"):
        shard_batch(rows, torch.device("cpu"), accum=3)
    with pytest.raises(ValueError, match="does not shard"):
        local_rows({"a": np.zeros((3, 1))}, mesh)


@pytest.mark.parametrize("key,value,mesh_message,message", [
    # the flagship's 16 heads do not split 3 ways: refused by name before
    # the mesh, which at world 1 refuses any model axis but 1
    ("PARALLEL.MODEL", 3, "PARALLEL.MODEL = 3: the model axis",
     "PARALLEL.MODEL = 3: the textual head's attention heads 16"),
    ("PARALLEL.DATA", 4, "PARALLEL.DATA = 4: the data axis",
     "PARALLEL.DATA = 4: the data axis"),
])
def test_parallel_keys_the_port_does_not_run_are_refused(tmp_path, key,
                                                          value, mesh_message,
                                                          message):
    from tests.test_torch_config import CONFIGS
    from virtex_tpu_torch.config import Config
    from virtex_tpu_torch.scripts.pretrain_virtex import main
    from virtex_tpu_torch.utils.common import common_parser

    with pytest.raises(ValueError, match=mesh_message):
        create_mesh(**{key.split(".")[1].lower(): value})
    with pytest.raises(ValueError, match=message):
        main(common_parser().parse_args(
            ["--config", CONFIG, "--serialization-dir", str(tmp_path),
             "--device", "cpu", "--config-override", key, str(value)]))
    # what configs/ sets, -1 and 1, and every virtex config there, still
    # run (the files tests/test_torch_config.py loads)
    assert create_mesh(-1, 1).data == create_mesh(1, 1).data == 1
    for path in CONFIGS:
        c = Config(path)
        assert create_mesh(c.PARALLEL.DATA, c.PARALLEL.MODEL).data == 1


# -- the CLIs at world size 2 --------------------------------------------------
def _pretrain_overrides(root, tokenizer, iters=6):
    return ["DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tokenizer,
            "DATA.VOCAB_SIZE", "300", "DATA.IMAGE_CROP_SIZE", "64",
            "DATA.MAX_CAPTION_LENGTH", "16",
            "MODEL.VISUAL.NAME", "torchvision::resnet18",
            "MODEL.VISUAL.FEATURE_SIZE", "512",
            "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H64_A2_F128",
            "MODEL.TEXTUAL.DROPOUT", "0.1",
            "DTYPE", "float32", "OPTIM.BATCH_SIZE", "8",
            "OPTIM.GRAD_ACCUM_STEPS", "2", "OPTIM.NUM_ITERATIONS", str(iters),
            "OPTIM.WARMUP_STEPS", "0", "OPTIM.LR_DECAY_NAME", "none",
            "OPTIM.LR", "0.01", "OPTIM.CNN_LR", "0.01",
            "OPTIM.LOOKAHEAD.STEPS", "4"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_coco")
    root = make_fake_coco(str(tmp / "coco"), n_images=8)
    return tmp, root, make_tokenizer(tmp).model_path


def _pretrain_args(run, overrides, *extra):
    return ["--config", CONFIG, "--serialization-dir", str(run),
            "--checkpoint-every", "3", "--log-every", "1", "--device", "cpu",
            "--cpu-workers", "1", *extra, "--config-override", *overrides]


@pytest.fixture(scope="module")
def pretrain_world_2(coco):
    tmp, root, tokenizer = coco
    ov = _pretrain_overrides(root, tokenizer)
    run = tmp / "run"
    out = run_ranks("cli", {"script": "pretrain_virtex",
                            "args": _pretrain_args(run, ov)}, tmp / "unbroken")
    return run, ov, out


def test_pretrain_at_world_2_shards_the_loader_as_the_jax_cli(coco,
                                                              pretrain_world_2):
    from virtex_tpu.config import Config as JaxConfig
    from virtex_tpu.data.loader import DataLoader as JaxLoader
    from virtex_tpu.factories import PretrainingDatasetFactory as JaxDatasets

    _, ov, out = pretrain_world_2
    jcfg = JaxConfig(CONFIG, list(ov))
    jds = JaxDatasets.from_config(jcfg, split="train")
    ids = [o["ids"] for o in out]
    assert len(ids[0]) == len(ids[1]) == 6
    for it in range(6):   # one epoch per batch: the shards are disjoint
        assert not set(ids[0][it]) & set(ids[1][it]), it
    for r in range(WORLD):
        loader = iter(JaxLoader(jds, 4, shuffle=True, num_workers=0,
                                seed=jcfg.RANDOM_SEED, infinite=True,
                                num_shards=WORLD, shard_index=r))
        want = [np.asarray(next(loader)["image_id"]).tolist()
                for _ in range(6)]
        assert ids[r] == want, r


def test_pretrain_at_world_2_saves_on_rank_0_and_resumes_bit_for_bit(
        coco, pretrain_world_2):
    from virtex_tpu_torch.engine.checkpointing import read_checkpoint

    tmp, _, _ = coco
    run, ov, out = pretrain_world_2
    r0, r1 = (o["result"] for o in out)
    assert r0["losses"] == r1["losses"] and r0["val"] == r1["val"]
    assert all(np.isfinite(list(r0["losses"].values())))
    assert out[1]["writes"] == []
    assert sorted(os.path.basename(p) for p in out[0]["writes"]) == [
        "checkpoint_3.pth", "checkpoint_6.pth"]
    assert {"log-rank0.txt", "log-rank1.txt", "checkpoint_best.pth",
            "best.json"} <= set(os.listdir(run))
    for it in (3, 6):  # per host: 4 images an iteration
        ckpt = read_checkpoint(str(run / f"checkpoint_{it}.pth"))
        assert ckpt["loader"] == {"items_consumed": it * 4}

    again = tmp / "resumed"
    resumed = run_ranks("cli", {"script": "pretrain_virtex", "args":
                                _pretrain_args(again, ov, "--resume-from",
                                               str(run / "checkpoint_3.pth"))},
                        tmp / "resumed_out")
    assert resumed[0]["result"]["losses"] == {
        i: r0["losses"][i] for i in range(4, 7)}
    assert resumed[0]["result"]["val"][6] == r0["val"][6]
    a = read_checkpoint(str(run / "checkpoint_6.pth"))
    b = read_checkpoint(str(again / "checkpoint_6.pth"))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["optimizer"].items():
        if isinstance(v, dict):
            for n, t in v.items():
                assert torch.equal(t, b["optimizer"][k][n]), (k, n)


def _colour_imagenet(root, per_class):
    """{split}/{wnid}/*.JPEG whose class is its colour."""
    import cv2
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        for c, colour in enumerate([(220, 40, 40), (40, 200, 60),
                                    (40, 60, 220)]):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                img = np.clip(np.asarray(colour, np.float32)
                              + rng.randint(-30, 31, (72, 96, 3)), 0, 255)
                cv2.imwrite(os.path.join(d, f"{i}.JPEG"),
                            img.astype(np.uint8)[:, :, ::-1])
    return root


def test_clf_linear_fine_tune_at_world_2_equals_world_1(tmp_path):
    """The fine-tune (BatchNorm synced) on a train split of one global
    batch: each iteration's global batch holds the same images in the same
    order at world 1 and 2, so the runs compute one thing."""
    from virtex_tpu_torch.scripts import clf_linear

    root = _colour_imagenet(str(tmp_path / "imagenet"), per_class=2)

    def args(run):
        return ["--down-config", PROBE, "--serialization-dir", str(run),
                "--weight-init", "random", "--checkpoint-every", "2",
                "--log-every", "1", "--cpu-workers", "1", "--device", "cpu",
                "--down-config-override", "DATA.ROOT", root,
                "DATA.IMAGE_CROP_SIZE", "64", "MODEL.VISUAL.NAME",
                "torchvision::resnet18", "MODEL.VISUAL.FROZEN", "false",
                "OPTIM.BATCH_SIZE", "6", "OPTIM.NUM_ITERATIONS", "3",
                "OPTIM.LR", "0.01"]

    one = clf_linear.main(clf_linear.build_parser().parse_args(
        args(tmp_path / "one")))
    two = run_ranks("cli", {"script": "clf_linear",
                            "args": args(tmp_path / "two")},
                    tmp_path / "two_out")
    # top-1 (%): the mean of the ranks' top-1 over 3 val images each, the
    # world-1 run's over all 6
    assert two[0]["result"]["value"] == two[1]["result"]["value"]
    assert abs(two[0]["result"]["value"] - one["value"]) <= 1e-9
    assert sorted(two[0]["result"]["top1"]) == sorted(one["top1"]) == [2]
    assert abs(two[0]["result"]["top1"][2] - one["top1"][2]) <= 1e-9
    for it, loss in one["losses"].items():   # bf16 backbone
        assert abs(two[0]["result"]["losses"][it] - loss) <= 2e-2 * abs(loss)
    # 20 BatchNorm layers of resnet18, each synced in its forward and
    # between K4's two stages, on every rank
    counts = two[1]["all_reduce_counts"]
    assert counts["bn_stats"] == counts["bn_sums"] == 20 * 3
    assert counts["grads"] == counts["metrics"] == 3


def test_eval_captioning_at_world_2_equals_world_1(coco, pretrain_world_2):
    from virtex_tpu_torch.scripts import eval_captioning

    tmp, _, _ = coco
    run, ov, _ = pretrain_world_2

    def args(out, batch="4"):
        return ["--config", CONFIG, "--serialization-dir", str(out),
                "--checkpoint-path", str(run / "checkpoint_6.pth"),
                "--batch-size", batch, "--cpu-workers", "1", "--device",
                "cpu", "--calc-metrics", "--output",
                str(out / "preds.json"), "--config-override", *ov,
                "MODEL.DECODER.BEAM_SIZE", "3",
                "MODEL.DECODER.MAX_DECODING_STEPS", "10"]

    parser = eval_captioning.build_parser()
    one = eval_captioning.main(parser.parse_args(args(tmp / "eval_one")))
    two = run_ranks("cli", {"script": "eval_captioning",
                            "args": args(tmp / "eval_two")},
                    tmp / "eval_two_out")
    got = two[0]["result"]
    assert got["predictions"] == one["predictions"]
    assert len(one["predictions"]) == 8
    assert got["metrics"] == one["metrics"]
    # rank 1 captioned the second block and returned it
    assert two[1]["result"]["predictions"] == one["predictions"][4:]
    with open(tmp / "eval_two" / "preds.json") as f:
        assert json.load(f) == one["predictions"]
    with pytest.raises(AssertionError, match="must be divisible"):
        run_ranks("cli", {"script": "eval_captioning",
                          "args": args(tmp / "eval_bad", batch="3")},
                  tmp / "eval_bad_out")
