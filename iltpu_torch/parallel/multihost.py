"""Process-group initialisation and cross-process means: the port of
`iltpu/parallel/multihost.py`.

iltpu connects its per-host processes with `jax.distributed.initialize`,
after which one mesh spans them. The port runs one process (a rank) a
device, so the process group IS the mesh (`iltpu_torch.parallel.data`):
`initialize_multihost` joins this process to it through
`torch.distributed.init_process_group`, NCCL on the card and gloo on the
CPU. A rank on the card takes `cuda:<local rank>`, made current before the
group starts. `process_allreduce_mean` is the mean of a host value over the
processes (evaluation returns, say).

A failed rendezvous or collective raises; nothing falls back.
"""

import inspect
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's device index on its host: `LOCAL_RANK` (torchrun and
    `python -m iltpu_torch.train` set it), else the group rank, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def init_group(backend: str, rank: int, world_size: int, device: Optional[torch.device] = None,
               **where) -> None:
    """`init_process_group` with `where` (an `init_method` or a `store`).
    With NCCL, `device` (cuda:<local rank> by default) becomes the current
    card first and, where the installed torch takes it, the group's
    `device_id`."""
    kw = dict(where)
    if backend == "nccl":
        device = device if device is not None else torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kw["device_id"] = device
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> dict:
    """Join this process to the job's process group. Arguments default to
    the variables torchrun sets (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`); `coordinator_address` is an init method
    (`tcp://host:port`, `file:///path`; a bare `host:port` means tcp).
    `backend`: nccl where CUDA is available, else gloo. Returns iltpu's
    summary keys; a rank drives one device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    init = coordinator_address or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    init_group(backend, rank, world, init_method=init)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def process_allreduce_mean(x) -> np.ndarray:
    """Mean of a host scalar or array across processes (iltpu's: the mean
    of the gathered values over the process axis)."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, np.asarray(x))
    return np.mean(np.stack(gathered), axis=0)
