"""Scale-out: process groups, the data axis, the spatial axis and their
collectives."""

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
from py4cast_tpu_torch.parallel.spatial import (
    Band,
    band_all_reduce,
    current_band,
    gather_lat,
    gather_rows,
    halo_rows,
    on_band,
    roll_rows,
)

__all__ = [
    "Band", "band_all_reduce", "current_band", "gather_lat", "gather_rows", "halo_rows",
    "on_band", "roll_rows",
    "Mesh", "MeshConfig", "all_gather_rows", "all_reduce_grads",
    "barrier", "broadcast_object", "distributed", "is_main_process", "main_process_first",
    "make_mesh", "maybe_init_distributed", "shard_batch", "to_host",
]
