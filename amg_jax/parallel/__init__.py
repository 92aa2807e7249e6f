from amg_jax.parallel.partition import assign_levels_to_devices, compute_level_work
from amg_jax.parallel.dist import (
    build_dist_hierarchy,
    make_row_mesh,
    pad_extended_layout,
    shard_hierarchy,
    shard_vector,
)
from amg_jax.parallel.grid import grid_parallel_solve, plan_grid_levels
from amg_jax.parallel.spcomm import HaloELL, build_halo_ell, comm_trace

__all__ = [
    "compute_level_work",
    "assign_levels_to_devices",
    "make_row_mesh",
    "shard_hierarchy",
    "shard_vector",
    "build_dist_hierarchy",
    "pad_extended_layout",
    "grid_parallel_solve",
    "plan_grid_levels",
    "HaloELL",
    "build_halo_ell",
    "comm_trace",
]
