"""Multi-process runtime: the process group, each rank's device, the global
scenario mesh and a process's slice of a global batch.

Port of ilqr_iterative_tasks_tpu/parallel/distributed.py on
``torch.distributed``. Each process is one rank; ``initialize_distributed``
joins it to the group once, before any collective. The backend is the
caller's: NCCL by default on the card, gloo on the CPU. NCCL takes one card
a rank and refuses two ranks on one card, so ranks that share a card pass
``backend="gloo"``, whose collectives take CUDA tensors too (staged through
the host). Scenarios never communicate: the scenario axis is data
parallelism, and the collectives are the gather of results at the end of a
sharded run (parallel/sharded_soa.py) and the kNN tuples of the meshed
safe set (parallel/sharded_safe_set.py).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0  # the group's rendezvous and collective timeout


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's rank among the ranks of its host: ``LOCAL_RANK``
    (torchrun sets it), else ``process_id``, else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_id is not None:
        return int(process_id)
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(process_id: Optional[int] = None) -> torch.device:
    """The rank's device: ``cuda:(local_rank % device_count)`` where CUDA
    is there, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda",
                        local_rank(process_id) % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_S
                           ) -> torch.device:
    """Join this process to the process group (idempotent); returns the
    rank's device, which becomes the current CUDA device.

    With no address, reads the ``env://`` variables that torchrun sets
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE). With one
    (``tcp://host:port`` or ``host:port``), ``num_processes`` and
    ``process_id`` are the world size and this rank. ``backend``: "nccl"
    (the default where CUDA is there) or "gloo" (the default on the CPU,
    and the one for ranks that share a card). NCCL asked for more ranks on
    a host (``LOCAL_WORLD_SIZE``, else the world) than it has visible cards
    raises ValueError before the group forms. ``timeout`` (s) bounds the
    rendezvous and every collective.
    """
    if dist.is_initialized():
        return rank_device()
    if coordinator_address is None:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an address needs num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
        init_method = (coordinator_address if "://" in coordinator_address
                       else "tcp://" + coordinator_address)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if on_host > cards:
            raise ValueError(
                f"NCCL with {on_host} ranks on a host of {cards} visible "
                f"card(s): NCCL takes one card a rank and refuses two ranks "
                f"on one card; pass backend='gloo' for ranks that share one")
    dev = rank_device(rank if coordinator_address is not None else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return dev


def global_scenario_mesh(axis_name: str = "scenario"):
    """1-D mesh over every rank of the group, in rank order, which torchrun
    makes host-major (a one-rank mesh where no group was joined)."""
    from ilqr_iterative_tasks_torch.parallel.mesh import make_mesh
    return make_mesh(None, axis_name)


def host_local_batch_slice(global_batch: int) -> slice:
    """The columns of a global scenario batch that this process owns:
    ``global_batch // world`` of them from ``rank * per`` (the whole batch
    where no group was joined)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // world
    return slice(rank * per, rank * per + per)


def build_kernels(mesh) -> None:
    """Build the CUDA kernels once for the ranks of ``mesh`` on a card: its
    first rank runs nvcc (a no-op where the library exists), the others
    wait at a barrier and then load what it built."""
    from ilqr_iterative_tasks_torch.ops import _build
    if mesh.ranks[0] == mesh.rank:
        _build.build()
    mesh.barrier()
    _build.library()
