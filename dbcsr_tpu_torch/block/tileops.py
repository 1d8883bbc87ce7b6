"""Tile-granular device operations on tile stores.

Port of the parts of ``dbcsr_tpu/block/tileops.py`` the local multiply
uses: store alignment by tile keys (``tile_align_map``, ``take_tiles``),
the block-validity mask built from per-tile indicator matmuls
(``valid_mask``), and the transposed store (``transpose_store``). Every
device operation moves whole T×T tiles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .index import BCSRIndex
from .store import row_indicators, store_layout

__all__ = [
    "tile_align_map",
    "TileGather",
    "tile_gather",
    "apply_tile_gather",
    "take_tiles",
    "TileBlockInfo",
    "tile_block_info",
    "block_mask_store",
    "valid_mask",
    "transpose_order",
    "transpose_store",
]


# ---------------------------------------------------------------------------
# store alignment
# ---------------------------------------------------------------------------

def tile_align_map(dst_keys: np.ndarray, src_keys: np.ndarray) -> np.ndarray:
    """For each destination tile key, the source slot holding it (or -1).
    Both key arrays must be sorted (row-major tile ids are)."""
    pos = np.searchsorted(src_keys, dst_keys)
    pos_c = np.minimum(pos, max(len(src_keys) - 1, 0))
    hit = (
        (src_keys[pos_c] == dst_keys)
        if len(src_keys)
        else np.zeros(len(dst_keys), dtype=bool)
    )
    return np.where(hit, pos_c, -1).astype(np.int32)


@dataclass(frozen=True)
class TileGather:
    """A tile-level gather with -1 sentinels, resolved once on the host:
    ``out[dst[i]] = store[src[i]]`` and every other output tile is 0."""

    n_out: int
    identity: bool
    complete: bool  # every output tile has a source (no -1)
    dst: torch.Tensor  # int64 [n_hit] output slots that receive a tile
    src: torch.Tensor  # int64 [n_hit] store slot each one comes from


def tile_gather(slot_map: np.ndarray, n_store: int, device) -> TileGather:
    slot_map = np.asarray(slot_map)
    identity = len(slot_map) == n_store and np.array_equal(
        slot_map, np.arange(len(slot_map))
    )
    hit = np.flatnonzero(slot_map >= 0)
    return TileGather(
        n_out=len(slot_map),
        identity=bool(identity),
        complete=len(hit) == len(slot_map),
        dst=torch.as_tensor(hit, dtype=torch.int64, device=device),
        src=torch.as_tensor(
            slot_map[hit].astype(np.int64), dtype=torch.int64, device=device
        ),
    )


def apply_tile_gather(store: torch.Tensor, g: TileGather) -> torch.Tensor:
    """Apply a resolved gather: nothing for the identity, one
    ``index_select`` when every output has a source. torch has no fill-mode
    take, so -1 sentinels become a zero-initialised output into which the
    hits are copied; the destinations are unique, so the copy is
    deterministic."""
    if g.identity:
        return store  # identity alignment: no copy
    if g.complete:
        return store.index_select(0, g.src)  # one pass, no zero fill
    out = store.new_zeros((g.n_out,) + tuple(store.shape[1:]))
    if len(g.dst):
        out[g.dst] = store.index_select(0, g.src)
    return out


def take_tiles(store: torch.Tensor, slot_map: np.ndarray, tile: int) -> torch.Tensor:
    """Tile-level gather: out[i] = store[slot_map[i]] (zero tile for -1)."""
    if len(slot_map) == 0 or store.shape[0] == 0:
        return store.new_zeros((len(slot_map), tile, tile))
    return apply_tile_gather(
        store, tile_gather(slot_map, store.shape[0], store.device)
    )


# ---------------------------------------------------------------------------
# block <-> tile indicator machinery
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TileBlockInfo:
    """Per-tile block-segment structure of one index at tile edge T (host
    part). ``J`` [ntr, T, amax] / ``I`` [ntc, T, bmax] — row/col→segment
    indicators shared along tile rows/cols; ``K`` [n_tiles, amax, bmax] — 1
    where the (segment-row, segment-col) pair is a STORED block of this
    tile; ``bid`` — the stored block id there (-1 otherwise)."""

    amax: int
    bmax: int
    J: np.ndarray
    I: np.ndarray
    K: np.ndarray
    bid: np.ndarray


def tile_block_info(index: BCSRIndex, tile: int) -> TileBlockInfo:
    """Cached per-(index, tile) block/tile structure."""
    key = ("tile_block_info", tile)

    def mk():
        lay = store_layout(index, tile)
        rind = row_indicators(index.row_block_sizes, tile, index, "rows")
        cind = row_indicators(index.col_block_sizes, tile, index, "cols")
        amax, bmax = rind.seg_max, cind.seg_max
        nt = lay.n_tiles
        K = np.zeros((nt, amax, bmax), dtype=np.float32)
        bid = np.full((nt, amax, bmax), -1, dtype=np.int64)
        if nt:
            # (block, tile) pairs: blocks span <= few tiles each
            ro = index.row_offsets
            co = index.col_offsets
            br = index.blk_rows.astype(np.int64)
            bc = index.col_idx.astype(np.int64)
            r0, r1 = ro[br], ro[br + 1]
            c0, c1 = co[bc], co[bc + 1]
            tr0, tr1 = r0 // tile, (r1 - 1) // tile
            tc0, tc1 = c0 // tile, (c1 - 1) // tile
            nr = (tr1 - tr0 + 1).astype(np.int64)
            nc = (tc1 - tc0 + 1).astype(np.int64)
            counts = nr * nc
            total = int(counts.sum())
            b_of = np.repeat(np.arange(index.nblks, dtype=np.int64), counts)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            t_local = np.arange(total, dtype=np.int64) - starts[b_of]
            tr = tr0[b_of] + t_local // nc[b_of]
            tc = tc0[b_of] + t_local % nc[b_of]
            slot = np.searchsorted(lay.tile_keys(), tr * lay.ntc + tc)
            # the block rows/cols intersecting one tile row/col are
            # consecutive ids: the segment position is the offset from the
            # first block of that tile row/col
            A = br[b_of] - rind.block_of_seg[tr, 0]
            B = bc[b_of] - cind.block_of_seg[tc, 0]
            K[slot, A, B] = 1.0
            bid[slot, A, B] = b_of
        return TileBlockInfo(
            amax=amax, bmax=bmax, J=rind.J, I=cind.J, K=K, bid=bid,
        )

    return index._cached(key, mk)


def block_mask_store(
    index: BCSRIndex, tile: int, device, dtype=torch.float32,
) -> torch.Tensor:
    """[n_tiles, T, T] store-validity mask, 1 on positions a stored block
    covers and 0 on padding: ``mask[t,i,j] = sum_ab J[t,i,a] K[t,a,b]
    I[t,j,b]``, 0/1-valued and exact in float32."""
    info = tile_block_info(index, tile)
    lay = store_layout(index, tile)
    if lay.n_tiles == 0:
        return torch.zeros((0, tile, tile), dtype=dtype, device=device)
    J = torch.as_tensor(info.J, device=device)
    I = torch.as_tensor(info.I, device=device)
    rows = torch.as_tensor(lay.tile_coords[:, 0].astype(np.int64), device=device)
    cols = torch.as_tensor(lay.tile_coords[:, 1].astype(np.int64), device=device)
    Kd = torch.as_tensor(info.K, device=device)
    # J[tr(t)] @ K[t] @ I[tc(t)]^T, in tile batches (bounded scratch)
    out = torch.empty((lay.n_tiles, tile, tile), dtype=dtype, device=device)
    step = 4096
    for s in range(0, lay.n_tiles, step):
        e = min(s + step, lay.n_tiles)
        jk = torch.bmm(J.index_select(0, rows[s:e]), Kd[s:e])
        out[s:e] = torch.bmm(
            jk, I.index_select(0, cols[s:e]).transpose(1, 2)
        ).to(dtype)
    return out


def valid_mask(index: BCSRIndex, tile: int, device) -> torch.Tensor:
    """Cached validity mask (1 where a stored block covers the position).
    The cache key carries the device: one index may serve tensors on
    several devices."""
    dev = torch.device(device)
    key = ("valid_mask", tile, str(dev))
    return index._cached(key, lambda: block_mask_store(index, tile, dev))


# ---------------------------------------------------------------------------
# transposed store
# ---------------------------------------------------------------------------

def transpose_order(m_index: BCSRIndex, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """(order, tile_coords_T): the store slots of the transposed matrix's
    tiles in its row-major order, and those row-major coordinates."""
    lay = store_layout(m_index, tile)
    coords = lay.tile_coords
    keys_t = coords[:, 1].astype(np.int64) * lay.ntr + coords[:, 0]
    order = np.argsort(keys_t)
    coords_t = np.stack(
        [coords[order, 1], coords[order, 0]], axis=1
    ).astype(np.int32)
    return order, coords_t


def transpose_store(
    m_index: BCSRIndex, tile: int, store: torch.Tensor, conj: bool = False
) -> Tuple[torch.Tensor, np.ndarray]:
    """The tile store of the TRANSPOSED matrix: tile (r,c) → (c,r) permuted
    (tile-level gather) + per-tile transpose.

    Returns (store_T, tile_coords_T) where ``tile_coords_T`` is row-major
    over the transposed tile grid. ``conj`` is accepted for the reference's
    signature; on real stores it is the identity.
    """
    if store.is_complex():
        raise NotImplementedError("complex tile stores are not ported")
    order, coords_t = transpose_order(m_index, tile)
    perm = torch.as_tensor(order, dtype=torch.int64, device=store.device)
    out = store.index_select(0, perm).transpose(1, 2).contiguous()
    return out, coords_t
