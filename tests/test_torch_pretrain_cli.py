"""The port's pretraining entry point
(virtex_tpu_torch.scripts.pretrain_virtex) end to end on the CPU: the base
config with a tiny model (resnet18 at 64², L1_H64), a fake COCO tree and
its tokenizer, 6 iterations of 4 images in 2 micro-batches, validating and
saving every 3.

- The loss falls.
- A run resumed from checkpoint_3 equals the unbroken run bit for bit
  (losses, validation, final checkpoint): the CPU is deterministic.
- ``--resume-from latest`` with no checkpoint starts fresh; run as
  ``python -m``.
- ``--device cuda`` without a card raises: nothing falls back to the CPU.
- The validation sweep equals the JAX CLI's on the same weights and data.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import drawn_variables, port_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.utils_fixtures import make_fake_coco, make_tokenizer
from virtex_tpu_torch.config import Config, ModelSpec
from virtex_tpu_torch.data.loader import DataLoader
from virtex_tpu_torch.engine.checkpointing import read_checkpoint
from virtex_tpu_torch.engine.evaluation import make_eval_step
from virtex_tpu_torch.factories import PretrainingDatasetFactory
from virtex_tpu_torch.native import DataPlane
from virtex_tpu_torch.scripts.pretrain_virtex import main, validate
from virtex_tpu_torch.utils.common import common_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "_base_bicaptioning_R_50_L1_H1024.yaml")
ITERS = 6


def _overrides(root, tokenizer, iters=ITERS):
    return ["DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tokenizer,
            "DATA.VOCAB_SIZE", "300", "DATA.IMAGE_CROP_SIZE", "64",
            "DATA.MAX_CAPTION_LENGTH", "16",
            "MODEL.VISUAL.NAME", "torchvision::resnet18",
            "MODEL.VISUAL.FEATURE_SIZE", "512",
            "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H64_A2_F128",
            "DTYPE", "float32", "OPTIM.BATCH_SIZE", "4",
            "OPTIM.GRAD_ACCUM_STEPS", "2", "OPTIM.NUM_ITERATIONS", str(iters),
            "OPTIM.WARMUP_STEPS", "0", "OPTIM.LR_DECAY_NAME", "none",
            "OPTIM.LR", "0.01", "OPTIM.CNN_LR", "0.01",
            "OPTIM.LOOKAHEAD.STEPS", "4"]


def _args(run, data, *extra, every=3):
    return ["--config", CONFIG, "--serialization-dir", str(run),
            "--checkpoint-every", str(every), "--log-every", "1",
            "--device", "cpu",
            "--cpu-workers", "2", *extra, "--config-override", *data]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pretrain")
    root = make_fake_coco(str(tmp / "coco"), n_images=8)
    return tmp, _overrides(root, make_tokenizer(tmp).model_path)


@pytest.fixture(scope="module")
def unbroken(data):
    tmp, ov = data
    run = tmp / "run"
    return run, main(common_parser().parse_args(_args(run, ov)))


def test_training_runs_validates_saves_and_the_loss_falls(unbroken):
    run, result = unbroken
    losses = [result["losses"][i] for i in range(1, ITERS + 1)]
    assert all(np.isfinite(losses))
    # two batches of 4 cycle through the 8 training images
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert sorted(result["val"]) == [3, 6]
    assert all(np.isfinite(v["loss"]) for v in result["val"].values())
    assert result["iteration"] == ITERS and result["start_iteration"] == 0
    assert {"checkpoint_3.pth", "checkpoint_6.pth", "checkpoint_best.pth",
            "best.json", "log-rank0.txt", "pretrain_config.yaml"} <= set(
                os.listdir(run))
    ckpt = read_checkpoint(str(run / "checkpoint_6.pth"))
    assert ckpt["iteration"] == ITERS
    assert ckpt["loader"] == {"items_consumed": ITERS * 4}


def test_resume_from_iteration_3_equals_the_unbroken_run(data, unbroken):
    tmp, ov = data
    run, result = unbroken
    again = tmp / "resumed"
    resumed = main(common_parser().parse_args(_args(
        again, ov, "--resume-from", str(run / "checkpoint_3.pth"))))
    assert resumed["start_iteration"] == 3
    assert resumed["losses"] == {i: result["losses"][i]
                                 for i in range(4, ITERS + 1)}
    assert resumed["val"][6] == result["val"][6]
    a = read_checkpoint(str(run / "checkpoint_6.pth"))
    b = read_checkpoint(str(again / "checkpoint_6.pth"))
    for part in ("model", "optimizer"):
        for k, v in a[part].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    assert torch.equal(t, b[part][k][n]), (part, k, n)
            elif torch.is_tensor(v):
                assert torch.equal(v, b[part][k]), (part, k)
            else:
                assert v == b[part][k], (part, k)


def test_resume_latest_without_a_checkpoint_starts_fresh(data):
    tmp, ov = data
    run = tmp / "latest"
    ov = _overrides(*ov[1:4:2], iters=2)
    out = subprocess.run(
        [sys.executable, "-m", "virtex_tpu_torch.scripts.pretrain_virtex",
         *_args(run, ov, "--resume-from", "latest", every=2)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no checkpoint yet, starting fresh" in out.stdout + out.stderr
    assert "checkpoint_2.pth" in os.listdir(run)


def test_no_card_raises_instead_of_falling_back(data, tmp_path, monkeypatch):
    _, ov = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tmp_path, ov)
    args[args.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(common_parser().parse_args(args))
    with pytest.raises(NotImplementedError, match="one process"):
        main(common_parser().parse_args(_args(tmp_path, ov,
                                              "--num-processes", "2")))


@pytest.mark.parametrize("batch", [4, 3])
def test_validation_sweep_matches_the_jax_cli(data, batch):
    """``validate`` against the JAX CLI's sweep (``scripts/pretrain_virtex.py``:
    the mean over its val loader's batches, which drops a short one) on
    fake COCO's 8 val images, from the same drawn weights in fp32, within
    1e-5 relative. With batches of 4 the two are the same sum. With batches
    of 3 the port also validates the last 2 images, so it equals the JAX
    eval step's metrics over the JAX loader's batches with the short one
    kept, each weighed by its images."""
    import jax.numpy as jnp
    from virtex_tpu.config import Config as JaxConfig
    from virtex_tpu.data.loader import DataLoader as JaxLoader
    from virtex_tpu.engine.train_state import TrainState
    from virtex_tpu.engine.trainer import make_eval_step as jax_eval_step
    from virtex_tpu.factories import OptimizerFactory
    from virtex_tpu.factories import PretrainingDatasetFactory as JaxDatasets
    from virtex_tpu.factories import PretrainingModelFactory as JaxModels

    _, ov = data
    ov = list(ov)
    ov[ov.index("OPTIM.BATCH_SIZE") + 1] = str(batch)
    jcfg, cfg = JaxConfig(CONFIG, ov), Config(CONFIG, ov)
    jds = JaxDatasets.from_config(jcfg, split="val")

    def jax_batches(drop_last):
        return list(JaxLoader(jds, batch, shuffle=False, num_workers=0,
                              infinite=False, drop_last=drop_last))

    jm = JaxModels.from_config(jcfg)
    variables = drawn_variables(jm, jax_batches(True)[0], seed=0,
                                output_bias_std=1.0)
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              OptimizerFactory.from_config(
                                  jcfg, variables["params"]))
    step = jax_eval_step(jm)

    def jax_metrics(b):
        return {k: float(v) for k, v in step(
            state, {k: jnp.asarray(v) for k, v in b.items()}).items()}

    cli = [jax_metrics(b) for b in jax_batches(True)]
    cli = {k: float(np.mean([m[k] for m in cli])) for k in cli[0]}
    sizes = [len(b["image"]) for b in jax_batches(False)]
    kept = [jax_metrics(b) for b in jax_batches(False)]
    weighed = {k: sum(n * m[k] for n, m in zip(sizes, kept)) / sum(sizes)
               for k in kept[0]}

    model = port_model(ModelSpec.from_config(cfg), variables)
    ds = PretrainingDatasetFactory.from_config(cfg, DataPlane("libjpeg"),
                                               "val")
    got = validate(model, make_eval_step(model), lambda: DataLoader(
        ds, batch, shuffle=False, background=False, infinite=False,
        drop_last=False), torch.device("cpu"), cfg)
    want = cli if batch == 4 else weighed
    assert sizes == ([4, 4] if batch == 4 else [3, 3, 2])
    assert set(got) == set(want) == {"loss", "captioning_forward",
                                     "captioning_backward"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)


def test_cycle_rebuilds_each_epoch():
    from virtex_tpu_torch.utils.common import cycle
    from virtex_tpu_torch.utils.timer import Timer
    stream = cycle(lambda epoch: iter([(epoch, 0), (epoch, 1)]), start_epoch=2)
    assert [next(stream) for _ in range(5)] == [(2, 0), (2, 1), (3, 0),
                                                (3, 1), (4, 0)]
    timer = Timer(start_from=5, total_iterations=10)
    timer.tic()
    assert timer.toc() >= 0 and timer.current_iter == 5
    assert timer.throughput(4) > 0 and "Iter 5" in timer.stats
