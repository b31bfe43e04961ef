"""The process group of a multi-device restore: one process per device.

Counterpart of the serving half of ``mgldvsr_tpu/parallel/mesh.py``
(``make_mesh`` and ``init_multihost``). Launch one process per card with
``torchrun --nproc_per_node=N``, which puts ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in each process's
environment; :func:`init_group` reads them. Without ``torchrun``, set the
three ranks yourself and pass a ``file://`` init method on a file system
every process sees.

The backend follows the device: NCCL for CUDA (rank r runs on
``cuda:{LOCAL_RANK}``), gloo for the CPU. A CUDA request where CUDA or NCCL
is missing raises; it never carries on in gloo or on the CPU.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

# subgroups of the first n ranks, by n; dist.new_group is collective, so
# every rank makes them in the same order and keeps them until destroy()
_subgroups: dict = {}


def init_group(device: torch.device | str, init_method: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device.

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (default ``RANK``) come from
    the environment; ``init_method`` defaults to ``env://`` (``torchrun``'s
    ``MASTER_ADDR`` and ``MASTER_PORT``). ``timeout`` bounds every
    collective, a barrier where other ranks are still restoring included."""
    device = torch.device(device)
    try:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"init_group: {e.args[0]} is not set; launch with torchrun or set "
                           f"RANK and WORLD_SIZE") from None
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_group: a CUDA device was asked for and none is available")
        if not dist.is_nccl_available():
            raise RuntimeError("init_group: a CUDA device was asked for and this PyTorch has "
                               "no NCCL")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_group: no backend for device {device}")
    dist.init_process_group(backend, init_method=init_method or "env://", timeout=timeout,
                            world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None)
    return device


def destroy() -> None:
    """Leave the process group (and forget its subgroups)."""
    _subgroups.clear()
    dist.destroy_process_group()


def rank(group=None) -> int:
    """This process's rank in ``group`` (the whole world by default)."""
    return dist.get_rank(group)


def world(group=None) -> int:
    """The number of ranks in ``group`` (the whole world by default)."""
    return dist.get_world_size(group)


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; under NCCL on this rank's card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def subgroup(n: int):
    """The group of ranks 0..n-1. Every rank must call this with the same n
    in the same order (``dist.new_group`` is collective); ranks outside get
    a handle they must not use. The whole world is the default group."""
    if not 1 <= n <= world():
        raise ValueError(f"subgroup: {n} ranks of a world of {world()}")
    if n == world():
        return dist.group.WORLD
    if n not in _subgroups:
        _subgroups[n] = dist.new_group(list(range(n)))
    return _subgroups[n]
