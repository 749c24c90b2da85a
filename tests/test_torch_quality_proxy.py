"""The port's end-to-end learning proof
(``virtex_tpu_torch/scripts/quality_proxy.py``) on the CPU:

- its learnable COCO against the JAX fixture's
  (``tests/utils_fixtures.py make_learnable_coco``) on the same seed;
- a multi-step trajectory of the port's train step against the JAX
  package's ``make_train_step``, with the proxy's optimizer (AdamW,
  warmup then cosine, no Lookahead, accumulation 2) on learnable batches,
  past the warmup, from one set of weights;
- the proxy end to end at a tiny size: its result line, and a run that
  misses the CIDEr gates exits 1.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    drawn_variables,
    one_torch_thread,
    port_model,
)
from tests.utils_fixtures import LEARNABLE_CLASSES as JAX_CLASSES
from tests.utils_fixtures import make_learnable_coco as jax_learnable_coco
from virtex_tpu.config import Config
from virtex_tpu.engine.train_state import TrainState
from virtex_tpu.engine.trainer import make_train_step as jax_train_step
from virtex_tpu.factories import OptimizerFactory, PretrainingModelFactory
from virtex_tpu_torch.config import ModelSpec, OptimSpec
from virtex_tpu_torch.data.tokenizers import train_tokenizer
from virtex_tpu_torch.engine.train_state import step_seed
from virtex_tpu_torch.engine.trainer import make_train_step
from virtex_tpu_torch.native import DataPlane
from virtex_tpu_torch.optim.optimizer import build_optimizer
from virtex_tpu_torch.scripts import quality_proxy as qp

# Each image's decoded channel means against its class colour, on the
# 0..255 scale: uniform noise of ±25 averages out over 160² pixels
# (measured ≤ 0.31); colour channels in the wrong order are off by up to
# 180. The port's JPEGs against the JAX fixture's (cv2, the same libjpeg
# settings: quality 95, 4:2:0), decoded by the same plane: mean |Δ|
# (measured 0: the two encoders wrote the same bytes).
COLOUR_TOL, FIXTURE_TOL = 1.0, 1.0


def test_learnable_coco_matches_the_jax_fixture(tmp_path):
    assert qp.LEARNABLE_CLASSES == JAX_CLASSES
    plane = DataPlane("libjpeg", threads=1)
    port_root = qp.make_learnable_coco(plane, str(tmp_path / "port"))
    jax_root = jax_learnable_coco(str(tmp_path / "jax"))
    for split, n in (("train", 240), ("val", 48)):
        path = os.path.join("annotations", f"captions_{split}2017.json")
        with open(os.path.join(port_root, path)) as f:
            port_ann = json.load(f)
        with open(os.path.join(jax_root, path)) as f:
            assert port_ann == json.load(f)
        assert len(port_ann["images"]) == n
        for i, entry in enumerate(port_ann["images"]):
            name = os.path.join(f"{split}2017", entry["file_name"])
            with open(os.path.join(port_root, name), "rb") as f:
                ours = plane.decode(f.read()).astype(np.float64)
            with open(os.path.join(jax_root, name), "rb") as f:
                theirs = plane.decode(f.read()).astype(np.float64)
            assert ours.shape == (160, 160, 3)
            rgb = np.asarray(qp.LEARNABLE_CLASSES[i % 6][0][::-1], float)
            assert np.abs(ours.mean((0, 1)) - rgb).max() <= COLOUR_TOL, name
            assert np.abs(ours - theirs).mean() <= FIXTURE_TOL, name


# -- the multi-step trajectory ------------------------------------------------
# 8 images a micro-step: at 32² layer4's BatchNorm normalizes 8 values a
# channel (at 2 or 4 the trajectories part within a few steps). The
# proxy's optimizer chain with LR 7e-3: at 1e-3 the H32 head's embeddings
# (N(0, 0.02²)) move too little in 40 steps to halve the loss.
MICRO, ACCUM, IMAGE, STEPS, WARMUP, MAX_LEN = 8, 2, 32, 40, 10, 12
LR = 0.007


def _config() -> Config:
    """The proxy's model at a micro size and its optimizer, fp32 without
    dropout."""
    return Config(override_list=[
        "MODEL.NAME", "bicaptioning",
        "MODEL.VISUAL.NAME", "torchvision::resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512,
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H32_A2_F64",
        "MODEL.TEXTUAL.DROPOUT", 0.0,
        "DTYPE", "float32",
        "DATA.VOCAB_SIZE", qp.PROXY_VOCAB,
        "DATA.MAX_CAPTION_LENGTH", MAX_LEN,
        "OPTIM.OPTIMIZER_NAME", "adamw", "OPTIM.LR", LR,
        "OPTIM.CNN_LR", LR, "OPTIM.WEIGHT_DECAY", 0.0001,
        "OPTIM.LOOKAHEAD.USE", False,
        "OPTIM.NUM_ITERATIONS", STEPS, "OPTIM.WARMUP_STEPS", WARMUP,
        "OPTIM.GRAD_ACCUM_STEPS", ACCUM,
    ])


def _learnable_batches(tokenizer, seed: int = 0):
    """STEPS batches in the accumulation layout (ACCUM, MICRO, ...): each
    image a class colour plus noise, normalized as the data plane's float
    output is, with its class's caption, [SOS] … [EOS], and the reversal."""
    rng = np.random.RandomState(seed)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    batches = []
    for _ in range(STEPS):
        n = MICRO * ACCUM
        classes = rng.randint(len(qp.LEARNABLE_CLASSES), size=n)
        rgb = np.asarray([qp.LEARNABLE_CLASSES[c][0][::-1] for c in classes],
                         np.float32)[:, None, None, :]
        pixels = np.clip(rgb + rng.randint(-qp.NOISE, qp.NOISE + 1,
                                           (n, IMAGE, IMAGE, 3)), 0, 255)
        tokens = np.zeros((n, MAX_LEN), np.int32)
        noitpac = np.zeros_like(tokens)
        lengths = np.zeros(n, np.int32)
        for i, c in enumerate(classes):
            row = [1, *tokenizer.encode(qp.LEARNABLE_CLASSES[c][1]), 2]
            lengths[i] = len(row)
            tokens[i, :len(row)] = row
            noitpac[i, :len(row)] = row[::-1]
        flat = {"image": ((pixels / 255.0 - mean) / std).astype(np.float32),
                "caption_tokens": tokens, "noitpac_tokens": noitpac,
                "caption_lengths": lengths}
        batches.append({k: v.reshape((ACCUM, MICRO) + v.shape[1:])
                        for k, v in flat.items()})
    return batches


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """Per-step losses of the JAX package's and the port's train steps from
    one set of weights on the same learnable batches."""
    tokenizer = train_tokenizer(
        [c for _, c in qp.LEARNABLE_CLASSES] * qp.TOKENIZER_REPEATS,
        str(tmp_path_factory.mktemp("tok") / "tok.json"),
        vocab_size=qp.PROXY_VOCAB)
    cfg = _config()
    batches = _learnable_batches(tokenizer)
    jm = PretrainingModelFactory.from_config(cfg)
    variables = drawn_variables(jm, {k: v[0] for k, v in batches[0].items()},
                                seed=0)

    tx = OptimizerFactory.from_config(cfg, variables["params"])
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              tx)
    step = jax_train_step(jm, tx, donate=False, jit=True, accum_steps=ACCUM)
    ref = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        ref.append(float(m["loss"]))

    model = port_model(ModelSpec.from_config(cfg), variables)
    opt = build_optimizer(model.named_parameters(), OptimSpec.from_config(cfg))
    port_step = make_train_step(model, opt, accum_steps=ACCUM)
    got = [float(port_step({k: torch.from_numpy(v) for k, v in b.items()})
                 ["loss"]) for b in batches]
    return np.asarray(got), np.asarray(ref)


# Per-step losses, relative: fp32 on both sides, sums in other orders and
# ReLU inputs within fp32 noise of zero (test_torch_train_step.py); AdamW
# scales each gradient to a step of ~LR, so a difference grows ~3x a step
# from 4e-7 at step 2 until it levels off near 1e-3 by step 9. The first
# steps, where AdamW's bias correction acts most, are held tight (measured
# ≤ 1.1e-5), all 40 (past the warmup, into the cosine) loosely (measured
# ≤ 9.1e-3). A wrong schedule, moment or correction moves the loss by
# more than either from the step it acts.
EARLY_STEPS, EARLY_RTOL, RTOL = 5, 1e-4, 2e-2


def test_multi_step_losses_match_jax(trajectories):
    got, ref = trajectories
    assert len(got) == STEPS
    np.testing.assert_allclose(got[:EARLY_STEPS], ref[:EARLY_STEPS],
                               rtol=EARLY_RTOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_dropout_streams_differ_over_the_proxy_run():
    """Every iteration reseeds the dropout generator from (seed,
    iteration) (``step_seed``, as ``pretrain_virtex`` does): over the
    proxy's 400 iterations no two share their first draw of a K1 seed (as
    ``modules/transformer.py`` draws it) or of a keep mask."""
    gen = torch.Generator()
    seeds, masks = set(), set()
    for it in range(1, qp.WIDTHS["proxy"]["iterations"] + 1):
        gen.manual_seed(step_seed(0, it))
        seeds.add(int(torch.randint(2**31 - 1, (), generator=gen)))
        masks.add(torch.rand(64, generator=gen).ge(0.1).numpy().tobytes())
    assert len(seeds) == len(masks) == qp.WIDTHS["proxy"]["iterations"]


def test_both_trajectories_learn(trajectories):
    for losses in trajectories:
        assert losses[-1] < 0.5 * losses[0], losses


# -- the proxy end to end at a tiny size --------------------------------------
TINY = ["DATA.IMAGE_CROP_SIZE", "32", "OPTIM.BATCH_SIZE", "8",
        "MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H32_A2_F64",
        "MODEL.DECODER.MAX_DECODING_STEPS", "8"]


def test_proxy_runs_end_to_end_and_fails_its_gates(tmp_path, capsys):
    rc = qp.main(["--device", "cpu", "--iterations", "3", "--cpu-workers",
                  "1", "--workdir", str(tmp_path), "--config-override",
                  *TINY])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    line = json.loads(lines[-1])
    # the JAX script's keys (tests/quality_proxy_smoke.py)
    assert list(line) == ["quality_proxy_smoke", "val_CIDEr",
                          "val_CIDEr_nucleus", "iterations",
                          "grad_accum_steps"]
    assert line["iterations"] == 3 and line["grad_accum_steps"] == 1
    assert 0.0 <= line["val_CIDEr"] < qp.BEAM_CIDER_GATE
    assert line["quality_proxy_smoke"] == "FAIL" and rc == 1
    assert os.path.isfile(tmp_path / "ser" / "checkpoint_3.pth")
    assert any(ln.startswith("[3/3] eval_captioning") for ln in lines)


@pytest.mark.parametrize("beam, nucleus, ok", [
    (100.0, 80.0, True), (99.99, 500.0, False), (500.0, 79.99, False)])
def test_the_cider_gates(beam, nucleus, ok):
    assert qp.passes(beam, nucleus) is ok


def test_no_card_raises_for_a_cuda_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qp.main(["--workdir", str(tmp_path)])
