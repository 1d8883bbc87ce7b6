"""Distribution layer: process grids of virtual ranks, block distributions
and the sharded at-rest form.

Port of ``dbcsr_tpu/dist/`` (the reference's ``src/dist/`` and the grid
half of ``src/mpi/``, SURVEY.md §2.1) without the split-complex emulation
of its sharded ops: the grid is an array of torch devices, one rank per
cell, with the process that holds each (``grid.py``), and every distributed
product runs the port's stack kernels rank by rank (``mm/cannon.py``,
``mm/summa.py``). After ``init_lib(distributed=True)`` the ranks are dealt
over the processes of a ``torch.distributed`` world and ``comm.py`` moves
pieces between them.
"""
from .distribution import (
    Distribution,
    block_cyclic_dist,
    dist_tile_bins,
    local_map,
    tile_aligned_dist,
    tile_dist_vector,
)
from .grid import AXIS_COL, AXIS_LAYER, AXIS_ROW, ProcessGrid
from .sharded import (
    ShardLayout,
    shard_layout,
    shard_store,
    unshard_store,
)
from .sharded_ops import (
    ShardedMatrix,
    build_sharded_add,
    build_sharded_hadamard,
    build_sharded_multiply,
    build_sharded_scale_by_vector,
    shard_matrix,
    sharded_add,
    sharded_block_norms,
    sharded_checkpoint_read,
    sharded_checkpoint_write,
    sharded_dot,
    sharded_filter,
    sharded_frobenius,
    sharded_function_of_elements,
    sharded_hadamard,
    sharded_maxabs,
    sharded_multiply,
    sharded_scale,
    sharded_scale_by_vector,
    sharded_trace,
)

__all__ = [
    "Distribution",
    "ProcessGrid",
    "ShardLayout",
    "ShardedMatrix",
    "shard_layout",
    "shard_store",
    "unshard_store",
    "shard_matrix",
    "sharded_multiply",
    "build_sharded_multiply",
    "sharded_add",
    "sharded_hadamard",
    "sharded_scale",
    "sharded_scale_by_vector",
    "sharded_function_of_elements",
    "sharded_trace",
    "sharded_dot",
    "sharded_frobenius",
    "sharded_maxabs",
    "sharded_block_norms",
    "sharded_checkpoint_write",
    "sharded_checkpoint_read",
    "sharded_filter",
    "build_sharded_add",
    "build_sharded_hadamard",
    "build_sharded_scale_by_vector",
    "block_cyclic_dist",
    "tile_aligned_dist",
    "tile_dist_vector",
    "dist_tile_bins",
    "local_map",
    "AXIS_ROW",
    "AXIS_COL",
    "AXIS_LAYER",
]
