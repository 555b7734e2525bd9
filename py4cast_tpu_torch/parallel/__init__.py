"""Scale-out: process groups, the data axis and its collectives."""

from py4cast_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    all_gather_rows,
    all_reduce_grads,
    barrier,
    broadcast_object,
    distributed,
    is_main_process,
    main_process_first,
    make_mesh,
    maybe_init_distributed,
    shard_batch,
    to_host,
)

__all__ = [
    "Mesh", "MeshConfig", "all_gather_rows", "all_reduce_grads",
    "barrier", "broadcast_object", "distributed", "is_main_process", "main_process_first",
    "make_mesh", "maybe_init_distributed", "shard_batch", "to_host",
]
