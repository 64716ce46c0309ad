from iltpu_torch.parallel.data import (
    DataMesh,
    allgather_rows,
    allreduce_mean_,
    make_mesh,
    shard_batch,
)
from iltpu_torch.parallel.multihost import initialize_multihost, local_rank, process_allreduce_mean

__all__ = [
    "DataMesh",
    "make_mesh",
    "shard_batch",
    "allreduce_mean_",
    "allgather_rows",
    "initialize_multihost",
    "local_rank",
    "process_allreduce_mean",
]
