r"""
The control at a tiny size on the CPU: the reference put in the program's
place in fp8 (and, for training, on half of each batch) reads above the
program on the numbers each cell compares. The cells' limits come from
the same readings on the card at the cells' own sizes (``python3 -m
portbench.control``, ``PERF.md``).
"""
from __future__ import annotations

import time

import pytest

from portbench import control, harness
from portbench.tests import tiny


def _run(root, workload, seed):
    a = harness.parse(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0"])
    return harness.resolve(a, root, "cpu", time.time())


@pytest.mark.parametrize("seed", [4294967311, 12])
def test_train_control_and_half_batch_read_above_the_program(seed,
                                                             tmp_path):
    root = tiny.write_root(str(tmp_path))
    run = _run(root, "tiny.train", seed)
    out = control._train(run, "cpu")
    for name in run.limits:
        prog = out["program"][name][0]
        assert out["half_batch"][name][0] > 3 * prog, name
    assert any(out["control"][n][0] > out["program"][n][0]
               for n in run.limits)
    assert out["norms"]["syncs"] == [False, False, True]


def test_caption_control_reads_above_the_program(tmp_path):
    root = tiny.write_root(str(tmp_path))
    out = control._caption(_run(root, "tiny.caption", 4294967311), "cpu")
    assert out["control"]["caption_gap"][0] >= out["program"][
        "caption_gap"][0]
