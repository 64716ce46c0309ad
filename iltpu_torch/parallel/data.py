"""Data parallel over `torch.distributed`: the port of `iltpu/parallel/data.py`.

iltpu shards each update's batch over a 1-D device mesh inside jit and lets
XLA insert the gradient all-reduce; the state stays replicated and every
batch mean is a global mean. The port keeps that contract with one process
(a rank) a device. The mesh is the process group (`DataMesh`). Every rank
holds the whole state and does the same work; only the gradient steps split
the batch. Rank r takes rows [r B/N, (r+1) B/N) of each leaf
(`shard_batch`) and takes its loss as the mean over them, and
`allreduce_mean_` makes each gradient the mean over the ranks. Over equal
shards that mean is the whole batch's mean-loss gradient. `allgather_rows`
brings per-row outputs back to the whole batch.

`param_shardings` is iltpu's rule for its tensor-parallel layout
(`parallel.shard_params`); `iltpu_torch.parallel.tensor` lays the train
state out by it.
"""

from typing import Any, List, NamedTuple, Optional

import numpy as np

import torch
import torch.distributed as dist

from iltpu_torch.parallel.multihost import init_group, local_rank
from iltpu_torch.utils.checkpoint import flatten, unflatten


class DataMesh(NamedTuple):
    group: Any  # the process group: every rank
    rank: int
    world_size: int
    axis: str
    device: torch.device  # this rank's


def make_mesh(num_devices: Optional[int] = None, axis: str = "data",
              device: Optional[torch.device] = None) -> DataMesh:
    """The 1-D mesh of every rank of the process group. Without a group,
    this process becomes a group of one (NCCL on a card, gloo on the CPU).

    `device` is this rank's: by default its card, cuda:<local rank>, under
    NCCL and the CPU under gloo. The mesh's devices are the group's ranks,
    one a rank, on every host (iltpu's `jax.devices()` after
    `jax.distributed.initialize`); under gloo two ranks may share a card.
    `num_devices`, null for all of them, must not pass that count
    (iltpu's AssertionError) and must equal it. Under NCCL the local rank
    must name one of this host's cards.

    Every rank runs one all-reduce before this returns: it makes NCCL's
    communicator, which a CUDA graph capture cannot do, and a group that
    does not work raises here."""
    if not dist.is_initialized():
        dev = torch.device(device) if device is not None else torch.device("cuda", local_rank())
        init_group("nccl" if dev.type == "cuda" else "gloo", 0, 1, dev, store=dist.HashStore())
    backend, world = dist.get_backend(), dist.get_world_size()
    if backend == "nccl" and local_rank() >= torch.cuda.device_count():
        raise ValueError(f"local rank {local_rank()} has no card of its own: this host has "
                         f"{torch.cuda.device_count()}")
    if device is None:
        device = torch.device("cuda", local_rank()) if backend == "nccl" else torch.device("cpu")
    n = world if num_devices is None else int(num_devices)
    assert n <= world, f"requested {n} devices, have {world}"
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks and the process group has "
                         f"{world}: start them with python -m iltpu_torch.train or torchrun")
    mesh = DataMesh(dist.group.WORLD, dist.get_rank(), world, axis, torch.device(device))
    ranks = torch.ones(1, device=mesh.device)
    dist.all_reduce(ranks, group=mesh.group)
    if int(ranks.item()) != world:
        raise RuntimeError(f"the first all-reduce over {world} ranks gave {ranks.item()}")
    return mesh


def shard_batch(batch: Any, mesh: DataMesh) -> Any:
    """This rank's rows [r B/N, (r+1) B/N) of every leaf with ndim >= 1 (a
    view), for a dict of leaves or one tensor; scalars and None stay as
    they are (iltpu's `constrain_batch`)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if batch is None or batch.dim() == 0:
        return batch
    rows, n = batch.shape[0], mesh.world_size
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} ranks")
    return batch.narrow(0, mesh.rank * (rows // n), rows // n)


def allreduce_mean_(tensors: List[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    """Each tensor (float32) replaced in place by its mean over the ranks,
    through ONE all-reduce of one flat buffer, whatever the number of
    tensors; `allreduce_mean_.launches` counts the all-reduces."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    allreduce_mean_.launches += 1
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors), [p.view_as(t) for p, t in zip(parts, tensors)])
    return tensors


allreduce_mean_.launches = 0


def allgather_rows(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's rows of `t`, in rank order: the whole batch."""
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def param_shardings(mesh: DataMesh, params: Any) -> Any:
    """iltpu's tensor-parallel rule (`iltpu/parallel/data.py:63-83`) for a
    nested dict, tuple or `Fields` of arrays or tensors: a leaf with ndim >=
    2 whose last axis the mesh divides (and is at least the mesh's size)
    shards that axis, and this rank holds its column block `[..., r c:(r+1)
    c]`, c = shape[-1] / N: the leaf's spec is that `slice`. Every other
    leaf is replicated: None. Returns the specs in `params`' structure."""
    n, r = mesh.world_size, mesh.rank

    def spec(leaf):
        shape = tuple(np.shape(leaf))
        if len(shape) >= 2 and shape[-1] % n == 0 and shape[-1] >= n:
            c = shape[-1] // n
            return slice(r * c, (r + 1) * c)
        return None

    return unflatten(params, [spec(leaf) for leaf in flatten(params)[0]])
