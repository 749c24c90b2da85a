r"""
The process group: one process per card, joined by ``torch.distributed``.

Counterpart of ``virtex_tpu/utils/distributed.py``. The JAX package lays
its devices out in a mesh and lets XLA insert the collectives; the port
runs one process per card, as torchrun starts them, and the collectives
are explicit: NCCL between CUDA devices, gloo between CPU processes. The
backend follows the device unless the caller names one; nothing switches
backends on its own, and a CUDA run never goes on without its group.

Without an initialised group every function here is the single-process
no-op: world size 1, rank 0, no barrier, the value itself.
:data:`all_reduce_counts` counts the calls of :func:`all_reduce_sum` and
:func:`all_gather` by what they carry, as the kernels count their
launches.

Under tensor parallelism the world is a ``data × model`` grid
(:func:`grid_groups`): the ``model`` ranks of one data shard are adjacent,
world rank ``d · model + m``, as the JAX package's ``create_mesh`` lays
its devices out, and each rank belongs to one data group (the ranks that
hold its shard of the model, one per data shard) and one model group (the
ranks that hold its data shard, one per shard of the model).
"""
from __future__ import annotations

import collections
import datetime
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

# all_reduce_sum's calls since import or the last reset, by ``what``.
all_reduce_counts: collections.Counter = collections.Counter()


def reset_all_reduce_counts() -> None:
    all_reduce_counts.clear()


def default_backend(device: Union[str, torch.device]) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, timeout_s: float = 600.0
               ) -> bool:
    """Join the process group, if this run has one; returns whether it
    does.

    The group comes from the arguments (``coordinator_address`` is
    ``host:port`` or an init-method URL such as ``file://<path>``) or else
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``). With neither, the run is one process and nothing is
    initialised. ``backend`` (``nccl`` or ``gloo``, see
    :func:`default_backend`) is used as given, and must be named."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is not None or coordinator_address is not None:
        if num_processes is None or process_id is None \
                or coordinator_address is None:
            raise ValueError("a multi-process run needs the coordinator "
                             "address, the number of processes and this "
                             "process's id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    elif "WORLD_SIZE" in env:
        url = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"process group backend {backend!r}: name nccl "
                         "or gloo")
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_local_rank() -> int:
    """The process's index among those of its host (torchrun's
    ``LOCAL_RANK``), 0 without it."""
    return int(os.environ.get("LOCAL_RANK", 0)) if dist.is_initialized() \
        else 0


def is_master_process() -> bool:
    """True for exactly one process, rank 0."""
    return get_rank() == 0


def synchronize() -> None:
    """A barrier across the processes."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if not dist.is_initialized():
        return obj
    held = [obj]
    dist.broadcast_object_list(held, src=0)
    return held[0]


def gather_objects(obj: Any) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order on rank 0, None elsewhere."""
    if not dist.is_initialized():
        return [obj]
    held = [None] * get_world_size() if get_rank() == 0 else None
    dist.gather_object(obj, held, dst=0)
    return held


def _collective_device() -> torch.device:
    """Where host values are staged for a collective: the current card
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensor: torch.Tensor, what: str,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """Sum ``tensor`` in place over the processes of ``group`` (the whole
    world by default) and return it; ordered on the current stream. Counts
    one call under ``what``. A failed collective raises."""
    all_reduce_counts[what] += 1
    if dist.is_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, what: str,
               group: Optional[dist.ProcessGroup] = None
               ) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (all of one shape) in the rank order of
    ``group``; counts one call under ``what``. Without a process group,
    ``[tensor]``."""
    all_reduce_counts[what] += 1
    if not dist.is_initialized():
        return [tensor]
    out = [torch.empty_like(tensor)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, tensor.contiguous(), group=group)
    return out


def grid_groups(data: int, model: int
                ) -> Tuple[dist.ProcessGroup, dist.ProcessGroup]:
    """This rank's data group and model group in a ``data × model`` grid
    of the world (world rank ``d · model + m``). Every rank creates every
    group, in one order, as ``dist.new_group`` requires."""
    if data * model != get_world_size():
        raise ValueError(f"a {data} x {model} grid of a world of "
                         f"{get_world_size()} ranks")
    rank = get_rank()
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return data_group, model_group


def average_across_processes(
        value: Union[float, Dict[str, float]]
) -> Union[float, Dict[str, float]]:
    """The mean over the processes of a host scalar, or of each value of a
    dict of them (every process passes the same keys)."""
    world = get_world_size()
    if world == 1:
        return value
    keys = sorted(value) if isinstance(value, dict) else None
    flat = [value[k] for k in keys] if keys is not None else [value]
    t = torch.tensor(flat, dtype=torch.float64, device=_collective_device())
    all_reduce_sum(t, "host")
    means = (t / world).tolist()
    return dict(zip(keys, means)) if keys is not None else means[0]


def device_mem_usage_mb() -> float:
    """The peak memory this process has allocated on its card, in MB; 0
    without a card."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**20
