"""
Multi-host runs: tiles across processes, planes on each process's cards.

Counterpart of ``aind_smartspim_destripe_tpu/parallel/distributed.py``.
Each process owns a disjoint round-robin share of a channel's tiles and
streams only their stores, so no image data crosses processes; the only
collective is :func:`global_stats`, the sum of a small host-side vector.
The processes meet through ``torch.distributed`` with the gloo backend over
TCP: only that vector crosses, on the host, so no device tensor ever leaves
its process and the workload needs no NCCL.

- :func:`initialize_distributed`: bring up the process group from explicit
  arguments or the ``DESTRIPE_COORDINATOR_ADDRESS`` /
  ``DESTRIPE_NUM_PROCESSES`` / ``DESTRIPE_PROCESS_ID`` variables (a no-op
  without them);
- :func:`assign_tiles`: the tiles this process owns;
- :func:`host_local_mesh`: this process's visible CUDA devices (a launcher
  running several processes on one host sets ``CUDA_VISIBLE_DEVICES`` per
  process);
- :func:`global_stats`: the sum of a small stats vector over processes.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh

__all__ = ["initialize_distributed", "rank", "world_size", "assign_tiles",
           "host_local_mesh", "global_stats"]


def rank() -> int:
    """This process's index; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes; 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Bring up the multi-host process group when configured; returns
    (process_index, process_count). Safe to call in single-process runs and
    again once the group is up.

    Configuration sources, in order: explicit arguments, then the
    ``DESTRIPE_COORDINATOR_ADDRESS`` (``host:port`` of process 0) /
    ``DESTRIPE_NUM_PROCESSES`` / ``DESTRIPE_PROCESS_ID`` environment
    variables set by the launcher on each host."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("DESTRIPE_COORDINATOR_ADDRESS")
        if coordinator_address:
            num_processes = int(os.environ.get("DESTRIPE_NUM_PROCESSES", "1"))
            process_id = int(os.environ.get("DESTRIPE_PROCESS_ID", "0"))
    if coordinator_address and not dist.is_initialized():
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id),
        )
    return rank(), world_size()


def assign_tiles(tiles: Sequence, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> List:
    """Deterministic round-robin tile ownership: process i takes tiles i,
    i+P, i+2P, ... of the tiles sorted by name."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    ordered = sorted(tiles, key=str)
    return [t for j, t in enumerate(ordered) if j % pc == pi]


def host_local_mesh() -> List[torch.device]:
    """The mesh of this process's visible CUDA devices (raises without
    one)."""
    return make_mesh(None)


def global_stats(values: np.ndarray) -> np.ndarray:
    """Sum a small per-process stats vector over all processes: an
    all-reduce of a CPU tensor over gloo. Identity in single-process
    runs."""
    values = np.asarray(values)
    if world_size() == 1:
        return values
    t = torch.from_numpy(np.array(values, copy=True))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()
