"""Multi-host initialisation and per-node scene sharding: the port's
counterpart of the JAX package's ``parallel/dist.py``.

``initialize_distributed`` joins this process to the world's process group
(NCCL on a card, gloo on the CPU) from explicit arguments or the
environment: JAX's ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
``PROCESS_ID``, or ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``.  A single process is left as it is.

A JAX process drives every chip of its host; a PyTorch rank drives one
device, so the port's "process" of scene sharding is the node:
``node_index() = rank // LOCAL_WORLD_SIZE`` and ``host_shard`` splits
scenes round-robin over nodes.  ``torchrun`` sets ``LOCAL_WORLD_SIZE``, and
so does ``parallel.mesh.RankPool`` (its ranks share one node); a process
started without it is a node of its own, as a JAX process is a host.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Initialise the default process group when this is one of several
    processes; a no-op for a single process or an initialised group.
    ``coordinator_address`` is ``host:port`` (rank 0 listens there)."""
    if dist.is_initialized():
        return
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if address is None:
        return  # a single process
    world = num_processes or int(env.get("NUM_PROCESSES") or env.get("WORLD_SIZE") or 1)
    rank = process_id if process_id is not None else int(
        env.get("PROCESS_ID") or env.get("RANK") or 0)
    if world <= 1:
        return
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=f"tcp://{address}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def node_index() -> int:
    """This rank's node: ``rank // LOCAL_WORLD_SIZE`` (0 for one node)."""
    return (dist.get_rank() if dist.is_initialized() else 0) // _local_world()


def node_count() -> int:
    """The number of nodes: ``world_size // LOCAL_WORLD_SIZE``."""
    return max(1, (dist.get_world_size() if dist.is_initialized() else 1) // _local_world())


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """Deterministic round-robin shard of a list across nodes (scene
    sharding): the items ``i`` with ``i % count == index``."""
    pi = node_index() if process_index is None else process_index
    pc = node_count() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]
