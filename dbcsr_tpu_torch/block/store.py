"""Tile-store layout: the at-rest device representation of a matrix.

Copy of ``dbcsr_tpu/block/store.py`` (numpy only). A matrix's device data
is its own T×T tile store — a ``[n_tiles, T, T]`` tensor holding the dense
content of every tile that overlaps at least one stored block, zero
elsewhere. Every operation preserves that invariant: padding positions are
exactly 0. The multiply then needs no packing for 'N' orientation (the
store is the operand panel), a transposed operand costs one tile
permutation plus a per-tile transpose, and the result comes out directly
in C's store layout.

The element-granular flat layout (blocks contiguous, the reference's
``data_area``) survives on the host only, as the interchange format for
assembly and block access; ``StoreLayout.elem_dest`` converts between the
two with numpy.

Block-granular semantics on the device (validity masks) run through per-tile
INDICATOR matmuls built here: all tiles in tile-row ``tr`` share the
row→block-row indicator ``J[tr] ∈ {0,1}^{T×Amax}`` and all tiles in
tile-col ``tc`` share ``I[tc] ∈ {0,1}^{T×Bmax}``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.errors import dbcsr_assert
from .index import BCSRIndex

__all__ = ["StoreLayout", "store_layout", "block_tile_coords", "RowIndicators", "row_indicators"]


@dataclass(frozen=True)
class StoreLayout:
    """Tile layout of one matrix index at tile edge ``tile``. The tiles come
    from the blocks alone (a few numbers a block); the element map
    ``elem_dest`` (8 bytes an element) is built at its first use, so a
    layout that only places tiles does not keep it."""

    tile: int
    ntr: int  # tile rows of the full matrix
    ntc: int  # tile cols
    tile_coords: np.ndarray  # int32 [n_tiles, 2] (trow, tcol), row-major order
    index: BCSRIndex = field(repr=False, compare=False)

    @property
    def n_tiles(self) -> int:
        return len(self.tile_coords)

    def tile_keys(self) -> np.ndarray:
        """Row-major tile ids (sorted, since tile_coords is row-major)."""
        return (
            self.tile_coords[:, 0].astype(np.int64) * self.ntc
            + self.tile_coords[:, 1]
        )

    @property
    def elem_dest(self) -> np.ndarray:
        """int64 [nelems_flat]: flat-block element -> store position."""
        return self.index._cached(("store_elem_dest", self.tile), self._elem_dest)

    def _elem_dest(self) -> np.ndarray:
        from ..core.config import get_config

        nat = None
        if get_config().use_native_planner:
            from ..native import store_layout_native

            nat = store_layout_native(self.index, self.tile)
        if nat is not None:
            coords, elem_dest = nat[0], nat[1]
        else:
            from ..mm.pack import tile_panel_maps

            elem_dest, coords, _ = tile_panel_maps(self.index, self.tile, False)
            elem_dest = elem_dest.astype(np.int64)
        dbcsr_assert(np.array_equal(coords, self.tile_coords),
                     "element map and block tiles disagree")
        return elem_dest

    # -- host flat <-> store conversion ------------------------------------
    def store_from_flat(self, flat: np.ndarray) -> np.ndarray:
        """numpy scatter: flat block data -> [n_tiles, T, T] store."""
        if self.n_tiles == 0:
            return np.zeros((0, self.tile, self.tile), dtype=flat.dtype)
        out = np.zeros((self.n_tiles * self.tile * self.tile,), dtype=flat.dtype)
        out[self.elem_dest] = flat
        return out.reshape(self.n_tiles, self.tile, self.tile)

    def flat_from_store(self, store: np.ndarray) -> np.ndarray:
        """numpy gather: store -> flat block data."""
        return np.asarray(store).reshape(-1)[self.elem_dest]


def block_tile_coords(index: BCSRIndex, tile: int) -> np.ndarray:
    """int32 [n_tiles, 2]: the (trow, tcol) of every tile that some stored
    element lies in, row-major, from each block's tile span."""
    ntc = -(-index.nfullcols // tile)
    m, n = (x.astype(np.int64) for x in index.blk_shapes)
    keep = (m > 0) & (n > 0)
    r0 = index.row_offsets[index.blk_rows[keep]]
    c0 = index.col_offsets[index.col_idx[keep]]
    tr0, tr1 = r0 // tile, (r0 + m[keep] - 1) // tile
    tc0, tc1 = c0 // tile, (c0 + n[keep] - 1) // tile
    keys = []
    for dr in range(int((tr1 - tr0).max(initial=-1)) + 1):
        for dc in range(int((tc1 - tc0).max(initial=-1)) + 1):
            keys.append(np.minimum(tr0 + dr, tr1) * ntc + np.minimum(tc0 + dc, tc1))
    keys = np.unique(np.concatenate(keys)) if keys else np.zeros(0, dtype=np.int64)
    return np.stack([keys // ntc, keys % ntc], axis=1).astype(np.int32).reshape(-1, 2)


def store_layout(index: BCSRIndex, tile: int) -> StoreLayout:
    """Cached tile layout of ``index`` (orientation N)."""
    return index._cached(("store_layout", tile), lambda: StoreLayout(
        tile=tile, ntr=-(-index.nfullrows // tile), ntc=-(-index.nfullcols // tile),
        tile_coords=block_tile_coords(index, tile), index=index))


@dataclass(frozen=True)
class RowIndicators:
    """Row→block indicator tables for one dimension's block sizes.

    ``J`` — float32 [n_tile_rows, T, seg_max]: ``J[tr, i, a] = 1`` iff
    global row ``tr·T + i`` belongs to the ``a``-th block-row intersecting
    tile-row ``tr`` (0 for padding rows/segments).
    ``block_of_seg`` — int32 [n_tile_rows, seg_max]: global block-row id per
    segment (-1 padding).
    """

    J: np.ndarray
    block_of_seg: np.ndarray

    @property
    def seg_max(self) -> int:
        return self.J.shape[2]


def row_indicators(
    block_sizes: np.ndarray, tile: int, index: Optional[BCSRIndex] = None,
    cache_key: str = "row",
) -> RowIndicators:
    """Build (and cache on ``index``) the indicator tables for one
    dimension."""
    def mk():
        sizes = np.asarray(block_sizes, dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(sizes)])
        total = int(off[-1])
        ntr = -(-total // tile)
        blk_of_row = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
        blk_of_row = np.concatenate(
            [blk_of_row, np.full(ntr * tile - total, -1, dtype=np.int64)]
        ).reshape(ntr, tile)
        seg_max = 1
        segs = []
        for tr in range(ntr):
            u = np.unique(blk_of_row[tr])
            u = u[u >= 0]
            segs.append(u)
            seg_max = max(seg_max, len(u))
        J = np.zeros((ntr, tile, seg_max), dtype=np.float32)
        block_of_seg = np.full((ntr, seg_max), -1, dtype=np.int32)
        for tr, u in enumerate(segs):
            block_of_seg[tr, : len(u)] = u
            pos = np.searchsorted(u, blk_of_row[tr])
            valid = blk_of_row[tr] >= 0
            J[tr, np.arange(tile)[valid], pos[valid]] = 1.0
        return RowIndicators(J=J, block_of_seg=block_of_seg)

    if index is not None:
        return index._cached(("row_indicators", cache_key, tile), mk)
    return mk()
