r"""
The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to a cell is found by name: the configuration's
file (``configs/<config>.json``, named in ``BENCHMARK.json``), the traffic
mix (``traffic/<traffic>.json``, whose ``kind`` names the driver in
``kinds/``), the limits of its correctness check
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``), all under ``portbench/`` of the checkout's
root. A new cell, mix, configuration or metric is a
new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level module names the run's process must not hold once the window
# has closed: JAX and the JAX package (compared whole, so the port, whose
# name begins with the JAX package's, passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "virtex_tpu")


class Refused(Exception):
    """The run cannot measure: it prints no result and exits non-zero."""


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    root: str
    t_start: float
    cell: dict
    config_entry: dict
    config_file: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def config(self):
        """The program's ``Config`` of this cell: its defaults overridden by
        every key of the configuration file."""
        from virtex_tpu_torch.config import Config
        return Config(None, overrides(self.config_file["config"]))


def overrides(tree: dict, prefix: str = "") -> list:
    """A nested dict of configuration keys → the flat key/value list the
    program's ``Config`` takes."""
    out: list = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out += overrides(value, f"{prefix}{key}.")
        else:
            out += [f"{prefix}{key}", value]
    return out


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def resolve(args, root: str, device, t_start: float) -> Run:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        raise Refused(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    per_layer = [m for m in bench["per_layer"]
                 if cell["name"] in m["workloads"]]
    data = os.path.join(root, os.path.basename(HERE))
    limits_path = os.path.join(data, "limits", f"{cell['name']}.json")
    return Run(
        workload=cell["name"], seed=int(args.seed),
        seconds=float(args.seconds), trace=bool(int(args.trace)),
        device=device, root=root, t_start=t_start, cell=cell,
        config_entry=entry,
        config_file=load_json(os.path.join(root, entry["file"])),
        traffic=load_json(os.path.join(data, "traffic",
                                       f"{cell['traffic']}.json")),
        limits=load_json(limits_path), end_to_end=e2e, per_layer=per_layer)


def require_cards(chips: int) -> str:
    """The device the run measures on; refuses without enough cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} card(s), the cell asks "
                      f"for {chips}")
    return "cuda:0"


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernels build into ``build/kernels`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "portbench", sub)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr


def read_metric(name: str, trace, root: str) -> Optional[float]:
    """The per-layer metric ``name`` read from ``trace`` by its reader,
    ``portbench/metrics/<name>.py`` under ``root``; None where it finds
    nothing to read."""
    path = os.path.join(root, os.path.basename(HERE), "metrics",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(trace)
    return None if value is None else float(value)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    parser = argparse.ArgumentParser(
        prog="python3 -m portbench.run",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def run(argv=None, device=None, root=None, t_start: float = 0.0,
        driver_hook=None) -> Dict[str, Any]:
    """One run; returns the result line's object. ``device`` None: the
    card, refused without one. ``driver_hook(driver_module, run)`` lets a
    test break the timed path before the run starts."""
    args = parse(argv)
    root = os.path.abspath(root or os.getcwd())
    set_cache_dirs(root)
    if device is None:
        run_ = resolve(args, root, None, t_start)
        run_.device = require_cards(int(run_.cell["chips"]))
        print(f"card: {card_line()}", flush=True)
    else:
        run_ = resolve(args, root, device, t_start)
    driver = importlib.import_module(f"portbench.kinds.{run_.traffic['kind']}")
    if driver_hook is not None:
        driver_hook(driver, run_)
    out = driver.run(run_)
    units = {m["name"]: m["unit"] for m in run_.end_to_end + run_.per_layer}
    if run_.trace:
        metrics = {}
        for m in run_.per_layer:
            value = read_metric(m["name"], out["trace"], root)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in run_.end_to_end}
    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in out["checks"]}
    correct = bool(out["checks"]) and all(
        value <= limit for _, value, limit in out["checks"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if run_.trace:
        result["device"]["busy_s"] = out["trace"].busy_s
        result["device"]["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = checks
    return result
