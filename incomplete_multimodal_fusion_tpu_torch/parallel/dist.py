"""Process-group bring-up and rank helpers (JAX package parallel/dist.py;
reference pretraining/utils/dist.py:18-159).

``init_distributed_mode`` joins the process group that torchrun describes
in the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) or that the caller names: NCCL on the
card, gloo when the caller asks for the CPU (or for gloo). Without those
variables and at world size 1 it does nothing, as the JAX package's does on
one host. ``collect_results`` is ``all_gather_object``; ``save_on_master``
gates an ad-hoc save to rank 0.
"""
from __future__ import annotations

import builtins
import os
import socket
from typing import Any, Optional

import torch
import torch.distributed as dist


def init_distributed_mode(device: str = "cuda", backend: Optional[str] = None,
                          init_method: Optional[str] = None, world_size: Optional[int] = None,
                          rank: Optional[int] = None) -> bool:
    """Joins the process group; returns True when one is running after the
    call. ``device`` 'cuda' takes NCCL and sets this process's card to
    ``LOCAL_RANK`` (default the rank modulo the cards); 'cpu' takes gloo.
    ``backend`` overrides the choice (gloo on CUDA tensors: several ranks on
    one card). ``init_method`` defaults to the environment's
    ``MASTER_ADDR`` / ``MASTER_PORT``; a failed join raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    if world_size <= 1 and init_method is None and "RANK" not in env:
        return False  # 'Not using distributed mode' (dist.py:80-84)
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    kwargs = {}
    if torch.device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            **kwargs)
    return True


def free_port() -> int:
    """A free TCP port on localhost (a one-process group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def print_main(*args, **kwargs) -> None:
    """Rank-0-only print (setup_for_distributed, dist.py:18-30)."""
    if is_main_process():
        builtins.print(*args, **kwargs)


def collect_results(local: Any) -> Any:
    """The list of every rank's ``local`` in rank order
    (collect_results_cpu, dist.py:96-159); ``local`` itself on one process."""
    if get_world_size() == 1:
        return local
    out = [None] * get_world_size()
    dist.all_gather_object(out, local)
    return out


def save_on_master(save_fn, *args, **kwargs) -> None:
    """Rank-0-gated save (dist.py:56-59)."""
    if is_main_process():
        save_fn(*args, **kwargs)


def destroy() -> None:
    """Leaves the process group, where one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
