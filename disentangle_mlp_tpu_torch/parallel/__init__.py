from .mesh import (DATA_AXIS, Mesh, all_gather_rows, all_reduce_flat,
                   all_reduce_sum, broadcast_, make_mesh,
                   maybe_initialize_distributed, replicate, shard_batch,
                   spawn)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "maybe_initialize_distributed",
    "spawn",
    "replicate",
    "shard_batch",
    "all_reduce_flat",
    "all_reduce_sum",
    "broadcast_",
    "all_gather_rows",
]
