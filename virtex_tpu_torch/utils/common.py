r"""
What the command-line scripts share: the argument parser, the run's set-up
(device, seeds, cuDNN flags, logging, the config dump), and ``cycle``.

Counterpart of ``virtex_tpu/utils/common.py``, without the JAX compile
cache and platform override. A script runs in one process on one device,
or as one of several processes, one per card, in a process group
(``utils/distributed.py``): started by torchrun, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, or
by the ``--coordinator-address``/``--num-processes``/``--process-id``
flags.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import sys
from typing import Any, Iterator

import numpy as np
import torch

from virtex_tpu_torch.config import Config
from virtex_tpu_torch.utils import distributed

logger = logging.getLogger("virtex_tpu_torch")


def common_parser(description: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", metavar="FILE",
                        help="Path to a config file.")
    parser.add_argument("--config-override", nargs="*", default=[],
                        help="Dotted-key value pairs overriding config.")
    parser.add_argument("--serialization-dir", default="/tmp/virtex_tpu_run",
                        help="Directory for checkpoints, logs, config dump.")
    parser.add_argument("--cpu-workers", type=int, default=4,
                        help="Threads of the data plane's OpenMP team, "
                             "which decodes and transforms each batch (0: "
                             "one per host core). The loader fetches in "
                             "one background thread either way.")
    parser.add_argument("--checkpoint-every", type=int, default=2000)
    parser.add_argument("--log-every", type=int, default=20)
    parser.add_argument("--resume-from", default=None,
                        help="Checkpoint path to resume training from, or "
                             "'latest' for the newest in the "
                             "serialization dir.")
    parser.add_argument("--device", default="cuda",
                        help="Device to train on (default: the card); "
                             "'cpu' runs on the CPU.")
    parser.add_argument("--coordinator-address", default=None,
                        help="The process group's rendezvous, host:port or "
                             "an init-method URL (file://...); torchrun's "
                             "environment is read without it.")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--profile-dir", default=None,
                        help="Write a torch.profiler trace of iterations "
                             "10-20 into this directory. The trace also "
                             "holds the program's spans (virtex::<name> "
                             "ranges), and the log gets one line of each "
                             "span's host and device ms per iteration.")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Trap NaNs in the backward pass "
                             "(torch.autograd anomaly mode; slow).")
    return parser


def common_setup(_C: Config, _A: argparse.Namespace,
                 job_type: str = "pretrain") -> torch.device:
    """Resolve the device (a CUDA device must exist: nothing falls back to
    the CPU), join the process group if the run has one (NCCL for a card,
    gloo for the CPU; a card's device is ``cuda:LOCAL_RANK``), seed python, numpy and torch with
    ``RANDOM_SEED`` on every rank (so the initial weights agree before the
    broadcast), set the cuDNN flags, log to ``log-rank<r>.txt`` in the
    serialization dir (and on rank 0 to stdout), and dump the config there
    from rank 0. Returns the device."""
    device = torch.device(_A.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {_A.device}: no CUDA device; pass "
                           "--device cpu to run on the CPU")
    distributed.initialize(
        _A.coordinator_address, _A.num_processes, _A.process_id,
        backend=distributed.default_backend(device))
    rank = distributed.get_rank()
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", distributed.get_local_rank())
        torch.cuda.set_device(device)
    os.makedirs(_A.serialization_dir, exist_ok=True)
    handlers = [logging.FileHandler(os.path.join(_A.serialization_dir,
                                                 f"log-rank{rank}.txt"))]
    if rank == 0:
        handlers.append(logging.StreamHandler(sys.stdout))
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
        handlers=handlers, force=True)
    random.seed(_C.RANDOM_SEED)
    np.random.seed(_C.RANDOM_SEED)
    torch.manual_seed(_C.RANDOM_SEED)
    torch.backends.cudnn.deterministic = bool(_C.CUDNN_DETERMINISTIC)
    torch.backends.cudnn.benchmark = bool(_C.CUDNN_BENCHMARK)
    if _A.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    logger.info(f"{job_type}: device {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + f", process {rank} of {distributed.get_world_size()}")
    logger.info(str(_C))
    if rank == 0:
        _C.dump(os.path.join(_A.serialization_dir,
                             f"{job_type}_config.yaml"))
    return device


def cycle(loader_factory, start_epoch: int = 0) -> Iterator[Any]:
    """Batches forever; ``loader_factory(epoch)`` builds one epoch's
    iterator."""
    epoch = start_epoch
    while True:
        yield from loader_factory(epoch)
        epoch += 1
