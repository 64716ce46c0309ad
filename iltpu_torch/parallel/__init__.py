from iltpu_torch.parallel.data import (
    DataMesh,
    allgather_rows,
    allreduce_mean_,
    make_mesh,
    param_shardings,
    shard_batch,
)
from iltpu_torch.parallel.multihost import initialize_multihost, local_rank, process_allreduce_mean
from iltpu_torch.parallel.tensor import TensorLayout, allgather_blocks

__all__ = [
    "DataMesh",
    "make_mesh",
    "shard_batch",
    "allreduce_mean_",
    "allgather_rows",
    "param_shardings",
    "TensorLayout",
    "allgather_blocks",
    "initialize_multihost",
    "local_rank",
    "process_allreduce_mean",
]
