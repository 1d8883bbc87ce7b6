"""Tile-store addressing, worked out from a block list alone.

A matrix at rest is a ``[n_tiles, T, T]`` store of the dense ``T × T`` tiles
of the element grid that overlap at least one stored block, in row-major
tile order, zero elsewhere. Element ``(r, c)`` of the matrix lies in tile
``(r // T, c // T)`` at ``(r % T, c % T)``. Both the data maker and the
reference address stores through this file, never through the program:
block by block (``positions``), or as dense rows of tiles (``dense_rows``,
``write_rows``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


def offsets(sizes: np.ndarray) -> np.ndarray:
    return np.concatenate(([0], np.cumsum(np.asarray(sizes, dtype=np.int64))))


@dataclass(frozen=True)
class Blocks:
    """A block list in row-major order with the block sizes of its axes."""

    rows: np.ndarray  # int64 block-row ids
    cols: np.ndarray  # int64 block-col ids
    row_sizes: np.ndarray  # int64 per block row
    col_sizes: np.ndarray  # int64 per block col

    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def keys(self) -> np.ndarray:
        return self.rows * len(self.col_sizes) + self.cols

    @property
    def m(self) -> np.ndarray:
        return self.row_sizes[self.rows]

    @property
    def k(self) -> np.ndarray:
        return self.col_sizes[self.cols]

    def classes(self) -> Dict[Tuple[int, int], np.ndarray]:
        """Block ids by shape ``(m, n)``, each id list in block order."""
        shape = self.m * (1 << 20) + self.k
        out = {}
        for s in np.unique(shape):
            out[(int(s >> 20), int(s & ((1 << 20) - 1)))] = np.flatnonzero(shape == s)
        return out


def tile_keys(b: Blocks, tile: int) -> np.ndarray:
    """Row-major ids ``trow · ntc + tcol`` of the tiles the blocks overlap."""
    ro, co = offsets(b.row_sizes), offsets(b.col_sizes)
    ntc = -(-int(co[-1]) // tile)
    r0, r1 = ro[b.rows] // tile, (ro[b.rows] + b.m - 1) // tile
    c0, c1 = co[b.cols] // tile, (co[b.cols] + b.k - 1) // tile
    span = int(max((r1 - r0).max(initial=0), (c1 - c0).max(initial=0)))
    keys = []
    for dr in range(span + 1):
        for dc in range(span + 1):
            tr, tc = np.minimum(r0 + dr, r1), np.minimum(c0 + dc, c1)
            keys.append(tr * ntc + tc)
    if not keys:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(keys))


def positions(b: Blocks, ids: np.ndarray, shape: Tuple[int, int], keys: np.ndarray,
              tile: int, device) -> torch.Tensor:
    """int64 ``[len(ids), m, n]`` flat store positions of the elements of
    blocks ``ids`` (all of shape ``(m, n)``) in the store whose row-major
    tile ids are ``keys``; every block's tiles have to be among them."""
    m, n = shape
    ro, co = offsets(b.row_sizes), offsets(b.col_sizes)
    ntc = -(-int(co[-1]) // tile)
    r = torch.as_tensor(ro[b.rows[ids]], device=device)[:, None] + torch.arange(m, device=device)
    c = torch.as_tensor(co[b.cols[ids]], device=device)[:, None] + torch.arange(n, device=device)
    key = (r // tile)[:, :, None] * ntc + (c // tile)[:, None, :]
    tk = torch.as_tensor(keys, device=device)
    slot = torch.searchsorted(tk, key.reshape(-1)).reshape(key.shape)
    if not len(keys) or bool((tk[slot.clamp(max=len(keys) - 1)] != key).any()):
        raise ValueError("a block lies in a tile that the store does not hold")
    return slot * (tile * tile) + (r % tile)[:, :, None] * tile + (c % tile)[:, None, :]


def tile_rows(keys: np.ndarray, ntc: int, t0: int, t1: int) -> Tuple[int, int]:
    """The slice of row-major tile ids ``keys`` whose tile rows lie in
    ``[t0, t1)``."""
    trow = keys // ntc
    return int(np.searchsorted(trow, t0)), int(np.searchsorted(trow, t1))


def dense_rows(store: torch.Tensor, keys: np.ndarray, ntc: int, t0: int, t1: int,
               dtype=None) -> torch.Tensor:
    """Tile rows ``[t0, t1)`` of a store as a dense ``[(t1-t0)·T, ntc·T]``
    matrix (zero where the store holds no tile)."""
    tile = store.shape[-1]
    lo, hi = tile_rows(keys, ntc, t0, t1)
    out = torch.zeros(((t1 - t0) * tile, ntc * tile), dtype=dtype or store.dtype,
                      device=store.device)
    if hi > lo:
        k = torch.as_tensor(keys[lo:hi], device=store.device)
        grid = out.view(t1 - t0, tile, ntc, tile).permute(0, 2, 1, 3)
        grid[k // ntc - t0, k % ntc] = store[lo:hi].to(out.dtype)
    return out


def write_rows(store: torch.Tensor, keys: np.ndarray, ntc: int, t0: int,
               rows: torch.Tensor) -> None:
    """The inverse of ``dense_rows``: the store's tiles in the tile rows
    that ``rows`` covers, read out of it."""
    tile = store.shape[-1]
    nr = rows.shape[0] // tile
    lo, hi = tile_rows(keys, ntc, t0, t0 + nr)
    if hi > lo:
        k = torch.as_tensor(keys[lo:hi], device=store.device)
        grid = rows.view(nr, tile, ntc, tile).permute(0, 2, 1, 3)
        store[lo:hi] = grid[k // ntc - t0, k % ntc].to(store.dtype)


def element_owner(sizes: np.ndarray, padded: int, device) -> torch.Tensor:
    """int64 ``[padded]``: the block of each element of an axis; elements
    past the last block belong to an extra block ``len(sizes)``."""
    owner = np.full(padded, len(sizes), dtype=np.int64)
    owner[:int(np.sum(sizes))] = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
    return torch.as_tensor(owner, device=device)


def block_sums(x: torch.Tensor, row_owner: torch.Tensor, col_owner: torch.Tensor,
               nrb: int, ncb: int) -> torch.Tensor:
    """``[nrb + 1, ncb + 1]`` sums of the dense ``x`` over the blocks that
    own its rows and columns (the last row and column: padding)."""
    per_col = torch.zeros((x.shape[0], ncb + 1), dtype=x.dtype, device=x.device)
    per_col.index_add_(1, col_owner, x)
    out = torch.zeros((nrb + 1, ncb + 1), dtype=x.dtype, device=x.device)
    out.index_add_(0, row_owner, per_col)
    return out
