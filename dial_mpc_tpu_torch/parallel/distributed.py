"""Process-group set-up for the sample-sharded planner.

PyTorch runs one process per device (JAX runs one process over many), so a
sharded run is a group of processes, each with its own card, started by
``torchrun``::

    torchrun --nproc-per-node 4 -m dial_mpc_tpu_torch.core.runner --example unitree_go2_trot

Call :func:`init_distributed` once per process before building the planner;
the sample mesh (``sharded.global_sample_mesh``) then spans every process and
``ShardedMBDPI`` shards ``Nsample`` over them. A single process needs no
set-up. The planner's reductions are ``all_reduce`` collectives alone, so
nothing else changes with the group's size. The actuation side (sim or real
robot) stays one process on one host, attached through the shm bus to rank 0.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dial_mpc_tpu_torch.envs.base_env import require_device

# the backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, device="cuda"):
    """Join the process group; a no-op for a single process with no address.

    Unset arguments fall back to the variables ``torchrun`` sets:
    ``MASTER_ADDR``/``MASTER_PORT`` (as ``env://``), ``WORLD_SIZE`` and
    ``RANK``. ``coordinator_address`` is an ``init_method`` URL
    (``tcp://host:port`` or ``file://path``). The backend is NCCL for a
    ``cuda`` device and gloo for ``cpu``, with no switch between them: a
    ``cuda`` device without a card raises. On ``cuda`` the process takes the
    card ``LOCAL_RANK`` (default 0). Returns whether a group was started.
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = "env://"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes in (None, 1) and coordinator_address is None:
        return False  # single process

    device = require_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device type {device.type!r}")
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        BACKENDS[device.type], init_method=coordinator_address, world_size=num_processes or 1,
        rank=process_id or 0,
    )
    return True


def world_size() -> int:
    """The group's size; 1 where no group was started."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 where no group was started."""
    return dist.get_rank() if dist.is_initialized() else 0

