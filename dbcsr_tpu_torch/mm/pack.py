"""Host-built maps between flat block data and the tile store.

The numpy half of ``dbcsr_tpu/mm/pack.py`` that the tile-store layout needs
when the native planner is unavailable (``block/store.py``): element
coordinates and the tile-panel scatter map. Both are cached on the index.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..block.index import BCSRIndex

__all__ = ["elem_coords", "tile_panel_maps"]


def elem_coords(index: BCSRIndex) -> Tuple[np.ndarray, np.ndarray]:
    """Global (row, col) element coordinates of every flat data element,
    int64 each, cached."""
    def mk():
        b = index.elem_to_blk.astype(np.int64)
        t = np.arange(index.nelems, dtype=np.int64) - index.blk_offset[b]
        bn = index.col_block_sizes[index.col_idx].astype(np.int64)[b]
        r_in = t // bn
        c_in = t - r_in * bn
        rows = index.row_offsets[index.blk_rows[b]] + r_in
        cols = index.col_offsets[index.col_idx[b]] + c_in
        return rows, cols

    return index._cached("elem_coords", mk)


def tile_panel_maps(
    index: BCSRIndex, tile: int, transpose: bool
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Maps for the tile-sparse layout ``[n_tiles, tile, tile]``.

    Returns (dest int32 [nelems] into the flattened tile store,
    tile_coords int32 [n_tiles, 2] = (tile_row, tile_col) per stored tile,
    (tile_rows_total, tile_cols_total)). Only tiles overlapped by at least
    one stored element exist.
    """
    key = ("tile_panel", tile, transpose)

    def mk():
        rows, cols = elem_coords(index)
        if transpose:
            rows, cols = cols, rows
            nrow, ncol = index.nfullcols, index.nfullrows
        else:
            nrow, ncol = index.nfullrows, index.nfullcols
        ntr = -(-nrow // tile)
        ntc = -(-ncol // tile)
        trow = rows // tile
        tcol = cols // tile
        tid = trow * ntc + tcol
        uniq, slot_of_elem = np.unique(tid, return_inverse=True)
        tile_coords = np.stack(
            [(uniq // ntc).astype(np.int32), (uniq % ntc).astype(np.int32)],
            axis=1,
        )
        dest = (
            slot_of_elem.astype(np.int64) * (tile * tile)
            + (rows - trow * tile) * tile
            + (cols - tcol * tile)
        )
        if dest.size and int(dest.max()) >= np.iinfo(np.int32).max:
            raise OverflowError("tile panel too large for int32 scatter map")
        return dest.astype(np.int32), tile_coords, (ntr, ntc)

    return index._cached(key, mk)
