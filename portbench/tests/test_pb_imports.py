r"""
What the benchmark loads: each cell's set-up path, run in a fresh
interpreter, holds neither JAX nor the JAX package (top-level module names
compared whole, so the port, whose name begins with the JAX package's,
passes), and the plain reference imports nothing of the program.
"""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE = os.path.join(REPO, "portbench", "reference")


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=REPO, capture_output=True,
        text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.caption"])
def test_a_runs_set_up_loads_no_jax(workload, tmp_path):
    root = tiny.write_root(str(tmp_path))
    found = _modules_after(
        "from portbench import harness\n"
        f"harness.run(['--workload', {workload!r}, '--seed', '4294967311', "
        f"'--seconds', '0.5', '--trace', '0'], device='cpu', root={root!r})")
    assert "virtex_tpu_torch" in found
    assert not found & set(harness.FORBIDDEN)


def test_every_cells_driver_loads_no_jax():
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    code = "import importlib, json, time\nfrom portbench import harness\n"
    for cell in bench["workloads"]:
        code += (
            f"a = harness.parse(['--workload', {cell['name']!r}, '--seed', "
            "'1', '--seconds', '1'])\n"
            f"r = harness.resolve(a, {REPO!r}, 'cpu', time.time())\n"
            "d = importlib.import_module('portbench.kinds.' + "
            "r.traffic['kind'])\n"
            "r.config\n")
    code += ("import virtex_tpu_torch.engine.trainer, "
             "virtex_tpu_torch.engine.captioner, virtex_tpu_torch.factories\n")
    found = _modules_after(code)
    assert not found & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(REFERENCE, "*.py")):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("virtex_tpu_torch",) + harness.FORBIDDEN, (
                    path, name)
    found = _modules_after("import portbench.reference.model, "
                           "portbench.reference.optim, "
                           "portbench.reference.beam")
    assert "virtex_tpu_torch" not in found
    assert not found & set(harness.FORBIDDEN)
