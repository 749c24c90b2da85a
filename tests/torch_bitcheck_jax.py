"""The JAX package's side of the port's feature bit-check
(``virtex_tpu_torch/scripts/feature_bitcheck.py``): one ``.pth`` loaded
through ``virtex_tpu.model_zoo.model_zoo.get``, the port's inputs
(``bitcheck_inputs``, numpy only), and the JAX script's three checks
(``scripts/feature_bitcheck.py:224-266``: the eval grid before any
train-mode forward, the train-mode loss and its components, and
d(loss)/d(image)), written to an npz with the port's keys, so that the
port's ``--against`` holds its results to them.

    python tests/torch_bitcheck_jax.py \
        --config configs/task_ablations/bicaptioning_R_50_L1_H2048.yaml \
        --checkpoint-path bicaptioning_R_50_L1_H2048.pth --write jax.npz
    python -m virtex_tpu_torch.scripts.feature_bitcheck --device cpu \
        --config configs/task_ablations/bicaptioning_R_50_L1_H2048.yaml \
        --checkpoint-path bicaptioning_R_50_L1_H2048.pth --against jax.npz

``--golden`` rewrites ``tests/fixtures/torch_bitcheck_golden.npz``: the
five pretext tasks of ``configs/task_ablations`` at a tiny size (resnet18
at 64², one layer of H128 A4 F256, B 2), each on a ``.pth`` that
``feature_bitcheck.write_checkpoint`` draws from GOLDEN_SEED, with the
sha256 of the drawn arrays beside its results.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from virtex_tpu_torch.scripts import feature_bitcheck as fb  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "fixtures",
                      "torch_bitcheck_golden.npz")
GOLDEN_SEED = 12
GOLDEN_BATCH = 2
_TINY_VISUAL = ["MODEL.VISUAL.NAME", "torchvision::resnet18",
                "MODEL.VISUAL.FEATURE_SIZE", "512",
                "DATA.IMAGE_CROP_SIZE", "64"]
_TINY_TEXTUAL = ["MODEL.TEXTUAL.NAME", "transdec_postnorm::L1_H128_A4_F256"]
# config (relative to the repository) → overrides
GOLDEN_TASKS = {
    "configs/task_ablations/bicaptioning_R_50_L1_H2048.yaml":
        _TINY_VISUAL + _TINY_TEXTUAL,
    "configs/task_ablations/captioning_R_50_L1_H2048.yaml":
        _TINY_VISUAL + _TINY_TEXTUAL,
    "configs/task_ablations/masked_lm_R_50_L1_H2048.yaml":
        _TINY_VISUAL + _TINY_TEXTUAL,
    "configs/task_ablations/token_classification_R_50.yaml": _TINY_VISUAL,
    "configs/task_ablations/multilabel_classification_R_50.yaml":
        _TINY_VISUAL,
}


def jax_results(config: str, overrides: list, checkpoint: str,
                batch_size: int, seed: int):
    """The three checks of the JAX package's model on ``checkpoint``.
    Returns ``(task, results)`` with the port's result keys; the grid and
    ``dimage`` are NHWC."""
    import jax
    import jax.numpy as jnp

    from virtex_tpu.model_zoo import model_zoo

    model, variables, _C = model_zoo.get(
        os.path.abspath(config), pretrained=True, checkpoint_path=checkpoint,
        overrides=list(overrides) + fb.FORCED_OVERRIDES)
    images, batch = fb.bitcheck_inputs(_C, batch_size, seed)
    grid = jax.jit(lambda v, x: model.apply(
        v, x, method=lambda m, x: m.visual(x, train=False)))(
            variables, jnp.asarray(images))
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}

    def loss_fn(img):
        out = model.apply(variables, {**jbatch, "image": img}, train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})[0]
        return out["loss"], out["loss_components"]

    (loss, components), dimage = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jnp.asarray(images))
    results = {fb.GRID: grid, fb.LOSS: loss, fb.DIMAGE: dimage}
    for name, value in components.items():
        results[fb.COMPONENT + name] = value
    return _C.MODEL.NAME, {k: np.asarray(v, np.float32)
                           for k, v in results.items()}


def entries(task: str, results: dict, config: str, overrides: list,
            seed: int, batch_size: int) -> dict:
    """The npz entries of one task, as ``feature_bitcheck --write`` names
    them."""
    meta = {"config": np.array(config),
            "overrides": np.array([str(v) for v in overrides], dtype=str),
            "seed": np.array(seed), "batch_size": np.array(batch_size)}
    return {f"{task}/{k}": v for k, v in {**results, **meta}.items()}


def write_golden(path: str = GOLDEN) -> dict:
    """Draw each golden task's ``.pth``, run the JAX side on it and write
    the results of all five, with each drawn file's sha256, to ``path``."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for config, overrides in GOLDEN_TASKS.items():
            pth = os.path.join(tmp, "golden.pth")
            sha = fb.write_checkpoint(os.path.join(REPO, config), overrides,
                                      GOLDEN_SEED, pth)
            task, results = jax_results(os.path.join(REPO, config),
                                        overrides, pth, GOLDEN_BATCH,
                                        GOLDEN_SEED)
            out.update(entries(task, results, config, overrides,
                               GOLDEN_SEED, GOLDEN_BATCH))
            out[f"{task}/checkpoint_sha256"] = np.array(sha)
    np.savez_compressed(path, **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config")
    ap.add_argument("--config-override", nargs="*", default=[])
    ap.add_argument("--checkpoint-path")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--write", metavar="OUT.npz")
    ap.add_argument("--golden", action="store_true",
                    help=f"rewrite {os.path.relpath(GOLDEN, REPO)}")
    args = ap.parse_args(argv)
    if args.golden:
        write_golden()
        print(f"torch_bitcheck_jax: wrote {GOLDEN}")
        return 0
    if not (args.config and args.checkpoint_path and args.write):
        ap.error("--config, --checkpoint-path and --write are needed")
    task, results = jax_results(args.config, args.config_override,
                                args.checkpoint_path, args.batch_size,
                                args.seed)
    np.savez_compressed(args.write, **entries(
        task, results, args.config, args.config_override, args.seed,
        args.batch_size))
    print(f"torch_bitcheck_jax: wrote {len(results)} results of {task} to "
          f"{args.write}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
