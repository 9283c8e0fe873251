"""Multi-process initialisation.

Port of ``mlp_ppo_2ply_multi_tpu/parallel/distributed.py``. The reference's
distributed runtime is single-machine multiprocessing with pickle transport
(SURVEY.md §2.2/§5.8); here it is one process per rank in a
``torch.distributed`` process group, NCCL between cards and gloo on the CPU.
Call ``init()`` once per process before building a mesh; ``global_mesh``
then lays the {data, model} mesh over every rank.

Runs of several processes start under torchrun, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the
counterparts of ``JAX_PROCESS_ID`` & co.):

    torchrun --nproc-per-node 2 -m mlp_ppo_2ply_multi_tpu_torch.apps.train \\
        --device cpu --data 2 ...

Importing this module touches no device and imports nothing of the package
(``global_mesh`` imports ``parallel.sharding`` when called).
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join the process group. With no arguments it reads torchrun's
    environment and is a no-op for a single process; ``world_size=1`` makes
    a group of one rank (on a free localhost port unless ``init_method`` or
    ``MASTER_ADDR`` says otherwise). The backend is NCCL for a ``cuda``
    ``device`` and gloo for the CPU unless ``backend`` is given. Returns
    True when this call made the group (the caller ends it with
    ``shutdown()``), False when there was one already or none is needed."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    if world_size is None and init_method is None and world <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise RuntimeError("no MASTER_ADDR: start the ranks under torchrun, or pass "
                               "init_method")
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The group's size, or torchrun's ``WORLD_SIZE`` (1 without it)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device: torch.device) -> torch.device:
    """``device`` with this rank's card: ``cuda:LOCAL_RANK`` modulo the
    cards present, for a ``cuda`` device given without an index."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(model: int = 1):
    """A {data, model} mesh over every rank of the group: data = world /
    model."""
    import torch.distributed as dist

    from mlp_ppo_2ply_multi_tpu_torch.parallel import sharding

    return sharding.make_mesh(dist.get_world_size() // model, model)


def is_coordinator() -> bool:
    """True on the rank that owns metrics and checkpoint writes: rank 0 of
    the group, or torchrun's ``RANK`` 0 before one exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0
