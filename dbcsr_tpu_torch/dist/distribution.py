"""Block distributions: block-row/col → process-grid coordinate maps.

Copy of ``dbcsr_tpu/dist/distribution.py`` (numpy only; the grid is the
port's ``ProcessGrid`` of virtual ranks). Analog of
``dbcsr_distribution_type`` / ``dbcsr_distribution_new``
(``src/core/dbcsr_types.F:141-184``, ``src/dist/dbcsr_dist_methods.F:71-233``):
arbitrary user-supplied maps with a block-cyclic default, plus cached local
row/col orderings (the reference's ``local_rows``/``local_cols``) that
define each device's local element coordinate system for panel packing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.errors import dbcsr_assert
from .grid import ProcessGrid

__all__ = [
    "Distribution",
    "block_cyclic_dist",
    "LocalMap",
    "local_map",
    "tile_dist_vector",
    "tile_aligned_dist",
    "dist_tile_bins",
]


def tile_dist_vector(
    block_sizes: np.ndarray, nbins: int, tile: int
) -> np.ndarray:
    """Block→bin map that assigns whole TILE-ROWS round-robin to bins.

    Blocks straddling a tile boundary are assigned by the tile containing
    their first row; alignment then requires block boundaries to coincide
    with tile boundaries at bin changes — use :func:`dist_tile_bins` to
    verify. For typical chemistry block sizes (<= tile) built with
    block-cyclic tiling this yields perfectly tile-aligned distributions,
    the fast path of the Cannon packing (see ``mm/cannon.py``).
    """
    sizes = np.asarray(block_sizes, dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    return ((off // tile) % nbins).astype(np.int32)


def dist_tile_bins(
    dist_vec: np.ndarray, block_sizes: np.ndarray, tile: int,
    *, majority: bool = False,
) -> Optional[np.ndarray]:
    """Per-tile bin map of a block distribution.

    With ``majority=False``: the exact map if the distribution is
    TILE-ALIGNED (every tile's blocks live in one bin), else None.
    With ``majority=True``: always a map — each tile goes to the bin owning
    most of its rows. The tiled Cannon engine partitions work by TILE, so a
    block distribution is honored as its nearest tile-aligned form: the
    result is identical, only the per-device load shifts by the straddling
    blocks (the reference's block-atomic ownership is a placement choice,
    not a semantic one).
    """
    sizes = np.asarray(block_sizes, dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)])
    total = int(off[-1])
    ntiles = -(-total // tile)
    row_bins = np.repeat(
        np.asarray(dist_vec, dtype=np.int64), sizes
    )
    bins = np.empty(ntiles, dtype=np.int64)
    for t in range(ntiles):
        rb = row_bins[t * tile : (t + 1) * tile]
        u, counts = np.unique(rb, return_counts=True)
        if len(u) != 1 and not majority:
            return None
        bins[t] = u[np.argmax(counts)]
    return bins.astype(np.int32)


def tile_aligned_dist(grid, row_block_sizes, col_block_sizes, tile: int):
    """Tile-aligned 2-D distribution (the Cannon fast-path default)."""
    return Distribution(
        grid=grid,
        row_dist=tile_dist_vector(row_block_sizes, grid.nprow, tile),
        col_dist=tile_dist_vector(col_block_sizes, grid.npcol, tile),
    )


@dataclass(frozen=True)
class LocalMap:
    """Local indexing of one dimension for one grid coordinate bin.

    ``blocks`` — global block ids assigned to the bin, in ascending order
    (the local block order); ``elem_offset[b]`` — element offset of global
    block ``b`` inside the bin's concatenated element space (-1 if the
    block is not local); ``nelems`` — total local elements.
    """

    blocks: np.ndarray
    elem_offset: np.ndarray
    nelems: int


def local_map(dist_vec: np.ndarray, block_sizes: np.ndarray, nbins: int):
    """LocalMap per bin for one dimension (vectorized)."""
    dist_vec = np.asarray(dist_vec)
    sizes = np.asarray(block_sizes, dtype=np.int64)
    maps = []
    for p in range(nbins):
        blocks = np.flatnonzero(dist_vec == p)
        local_sizes = sizes[blocks]
        offsets = np.concatenate([[0], np.cumsum(local_sizes)])
        elem_offset = np.full(len(sizes), -1, dtype=np.int64)
        elem_offset[blocks] = offsets[:-1]
        maps.append(
            LocalMap(
                blocks=blocks.astype(np.int32),
                elem_offset=elem_offset,
                nelems=int(offsets[-1]),
            )
        )
    return maps


@dataclass(frozen=True)
class Distribution:
    """2-D distribution over a process grid."""

    grid: ProcessGrid
    row_dist: np.ndarray  # int32 [nblkrows] -> prow
    col_dist: np.ndarray  # int32 [nblkcols] -> pcol
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        dbcsr_assert(
            int(self.row_dist.max(initial=0)) < self.grid.nprow
            and int(self.col_dist.max(initial=0)) < self.grid.npcol,
            "distribution map exceeds grid",
        )

    def compatible_with(self, index) -> bool:
        return len(self.row_dist) == index.nblkrows and len(
            self.col_dist
        ) == index.nblkcols

    def transposed(self) -> "Distribution":
        return Distribution(
            grid=self.grid.transposed(),
            row_dist=self.col_dist,
            col_dist=self.row_dist,
        )

    def row_local_maps(self, row_block_sizes: np.ndarray):
        key = "row_local"
        if key not in self._cache:
            self._cache[key] = local_map(
                self.row_dist, row_block_sizes, self.grid.nprow
            )
        return self._cache[key]

    def col_local_maps(self, col_block_sizes: np.ndarray):
        key = "col_local"
        if key not in self._cache:
            self._cache[key] = local_map(
                self.col_dist, col_block_sizes, self.grid.npcol
            )
        return self._cache[key]


def block_cyclic_dist(
    grid: ProcessGrid, nblkrows: int, nblkcols: int
) -> Distribution:
    """Default round-robin distribution (the reference's usual choice)."""
    return Distribution(
        grid=grid,
        row_dist=(np.arange(nblkrows) % grid.nprow).astype(np.int32),
        col_dist=(np.arange(nblkcols) % grid.npcol).astype(np.int32),
    )
