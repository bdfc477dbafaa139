"""Joining the ranks into one process group (counterpart of
``percivaltts_tpu/parallel/distributed.py``).

The JAX package has two data-parallel runtimes: one process over its local
devices, and ``jax.distributed`` joining processes across hosts. In the
port they are one code path: one process per device, launched by
``python -m torch.distributed.run --nproc-per-node N`` (on each host),
joined by :func:`initialize`. Every rank iterates the same deterministic
global batch sequence (the same dataset order, shuffle seed and bucket
bounds) and ships only its own rows to its device, so the collectives of
every step line up across the ranks.

So the JAX module's multi-process helpers are the one-process ones of
``mesh.py``: ``global_batch`` and ``global_stacked_batch`` are
``shard_batch`` and ``shard_stacked_batch``, ``replicate_state_global`` is
``replicate_state`` (a broadcast, whether the ranks share a host or not),
and ``_local_rows`` is ``Mesh.rows``.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it fails
TIMEOUT = timedelta(minutes=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group; a no-op when this process has joined one.

    Arguments left None are read from ``torch.distributed.run``'s
    environment: ``MASTER_ADDR``/``MASTER_PORT`` (the coordinator, as
    ``host:port`` or an ``init_method`` URL such as ``file:///path``),
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. Outside the launcher a
    process joins a group of one on a free local port; on a host with more
    than one visible card that raises instead, since one process would
    train on one card. ``backend``: ``"nccl"`` when a card is visible,
    else ``"gloo"``; an NCCL rank first selects its card, ``LOCAL_RANK``."""
    if dist.is_initialized():
        return
    env = os.environ
    launched = "WORLD_SIZE" in env or num_processes is not None
    if not launched and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise RuntimeError(
            f"{n} cards are visible and no launcher started this process: run one process "
            f"per card with python -m torch.distributed.run --nproc-per-node {n} -m "
            "percivaltts_tpu_torch.cli train --mesh ...")
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world == 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise ValueError(f"{world} processes need a coordinator address (MASTER_ADDR, "
                             "MASTER_PORT)")
    init_method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT)


def process_info() -> Dict[str, int]:
    """This process's place in the group, under the JAX package's keys:
    one device a process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
