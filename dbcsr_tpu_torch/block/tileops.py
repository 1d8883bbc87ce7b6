"""Tile-granular device operations on tile stores.

Port of ``dbcsr_tpu/block/tileops.py``: store alignment by tile keys
(``tile_align_map``, ``take_tiles``), coordinate masks (``coord_mask``), the
block↔tile indicator machinery — per-block norms² (``block_sums_sq``) and
block keep/validity masks (``block_mask_store``, ``valid_mask``) as small
per-tile indicator matmuls — and the transposed store
(``transpose_store``). Every device operation moves whole T×T tiles.
Reductions whose destinations repeat (a block spanning several tiles, a
tile column) run as ``OrderedSegmentSum``: one pass per position within a
segment, never atomics, so they are deterministic on the GPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .index import BCSRIndex
from .store import StoreLayout, row_indicators, store_layout

__all__ = [
    "tile_align_map",
    "TileGather",
    "tile_gather",
    "apply_tile_gather",
    "take_tiles",
    "coord_mask",
    "OrderedSegmentSum",
    "ordered_segment_sum",
    "TileBlockInfo",
    "tile_block_pairs",
    "tile_block_info",
    "DeviceBlockInfo",
    "device_block_info",
    "squares",
    "per_tile_block_sums",
    "block_sums_sq",
    "block_mask_store",
    "keep_blocks_",
    "valid_mask",
    "transpose_order",
    "transpose_store",
]

#: tiles per batched indicator matmul (bounds the scratch of the norm and
#: mask passes: 4096 f32 tiles of 128² are 268 MB)
_TILE_STEP = 4096


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
# coordinate masks (device, broadcast from tile coords — no element maps)
# ---------------------------------------------------------------------------

def coord_mask(
    layout: StoreLayout,
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    device,
) -> torch.Tensor:
    """Boolean [n_tiles, T, T] mask: ``fn(global_row, global_col)`` applied
    per tile via broadcasting (e.g. triu: ``lambda r, c: r <= c``)."""
    t = layout.tile
    coords = torch.as_tensor(layout.tile_coords.astype(np.int64), device=device)
    ar = torch.arange(t, device=device)
    r = coords[:, 0, None, None] * t + ar[None, :, None]
    c = coords[:, 1, None, None] * t + ar[None, None, :]
    return fn(r, c)


# ---------------------------------------------------------------------------
# deterministic segment sums
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OrderedSegmentSum:
    """``out[s] = Σ values[i]`` over the ``i`` of segment ``s``, added in
    increasing ``i`` (the order of a sequential scatter-add), resolved once
    on the host: pass ``j`` adds the ``j``-th member of every segment that
    has one. Destinations within a pass are distinct, so no atomics."""

    n_seg: int
    passes: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # (dst, src) int64

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        out = values.new_zeros((self.n_seg,) + tuple(values.shape[1:]))
        for dst, src in self.passes:
            out[dst] += values.index_select(0, src)
        return out


def ordered_segment_sum(seg: np.ndarray, n_seg: int, device) -> OrderedSegmentSum:
    """Plan the reduction of the values whose segment ids are ``seg``
    (int [n]; ids outside [0, n_seg) are dropped)."""
    seg = np.asarray(seg, dtype=np.int64)
    src = np.flatnonzero((seg >= 0) & (seg < n_seg))
    order = src[np.argsort(seg[src], kind="stable")]
    ptr = np.searchsorted(seg[order], np.arange(n_seg + 1))
    lens = np.diff(ptr)
    passes = []
    for j in range(int(lens.max(initial=0))):
        segs = np.flatnonzero(lens > j)
        passes.append((
            torch.as_tensor(segs, dtype=torch.int64, device=device),
            torch.as_tensor(order[ptr[segs] + j], dtype=torch.int64, device=device),
        ))
    return OrderedSegmentSum(n_seg=int(n_seg), passes=tuple(passes))


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


def tile_block_pairs(index: BCSRIndex, tile: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Every (block, tile) pair of ``index`` at tile edge T: int64 arrays of
    the store slot, the block's segment in the tile row (``a``) and tile
    column (``b``), and the block id, block by block."""
    lay = store_layout(index, tile)
    rind = row_indicators(index.row_block_sizes, tile, index, "rows")
    cind = row_indicators(index.col_block_sizes, tile, index, "cols")
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
    # the block rows/cols intersecting one tile row/col are consecutive
    # ids: the segment position is the offset from the first block of that
    # tile row/col
    a = br[b_of] - rind.block_of_seg[tr, 0]
    b = bc[b_of] - cind.block_of_seg[tc, 0]
    return slot, a, b, b_of


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
            slot, a, b, b_of = tile_block_pairs(index, tile)
            K[slot, a, b] = 1.0
            bid[slot, a, b] = b_of
        return TileBlockInfo(
            amax=amax, bmax=bmax, J=rind.J, I=cind.J, K=K, bid=bid,
        )

    return index._cached(key, mk)


@dataclass(frozen=True)
class DeviceBlockInfo:
    """``TileBlockInfo`` resident on one device: the shared indicators
    ``J`` [ntr, T, amax] / ``I`` [ntc, T, bmax], each tile's tile row/col
    (into ``J``/``I``), ``K`` [n_tiles, amax, bmax], ``bid_p1`` = bid + 1
    (0 where no stored block sits), and the reduction of per-tile
    (a, b) sums into per-block sums (``block_sum``)."""

    J: torch.Tensor
    I: torch.Tensor
    rows: torch.Tensor  # int64 [n_tiles]
    cols: torch.Tensor  # int64 [n_tiles]
    K: torch.Tensor
    bid_p1: torch.Tensor  # int64 [n_tiles, amax, bmax]
    block_sum: OrderedSegmentSum  # flat z [n_tiles·amax·bmax] -> [nblks]


def device_block_info(index: BCSRIndex, tile: int, device) -> DeviceBlockInfo:
    """Cached per (index, tile, device)."""
    dev = torch.device(device)

    def mk():
        info = tile_block_info(index, tile)
        lay = store_layout(index, tile)

        def up(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        return DeviceBlockInfo(
            J=up(info.J), I=up(info.I),
            rows=up(lay.tile_coords[:, 0].astype(np.int64)),
            cols=up(lay.tile_coords[:, 1].astype(np.int64)),
            K=up(info.K), bid_p1=up(info.bid + 1),
            block_sum=ordered_segment_sum(info.bid.reshape(-1), index.nblks, dev),
        )

    return index._cached(("device_block_info", tile, str(dev)), mk)


def squares(x: torch.Tensor) -> torch.Tensor:
    """|x|² in x's precision, real: ``x·x`` for real data, the real part of
    ``x·conj(x)`` for complex data (re² + im²), as the JAX package takes it."""
    return (x * x.conj()).real if x.is_complex() else x * x


def per_tile_block_sums(store: torch.Tensor, info: DeviceBlockInfo) -> torch.Tensor:
    """``z[t, a, b] = Σ_ij J[t,i,a]·|x[t,i,j]|²·I[t,j,b]`` in float32 (IEEE,
    TF32 off): norms are true single precision like the reference's
    (``calculate_norms.cpp``). Squares are taken in the store's precision
    (|z|² for complex stores) and rounded to float32, as the JAX package
    does."""
    from ..mm.kernels import tf32_matmul

    n = store.shape[0]
    z = store.new_empty((n, info.K.shape[1], info.K.shape[2]), dtype=torch.float32)
    with tf32_matmul(False):
        for s in range(0, n, _TILE_STEP):
            e = min(s + _TILE_STEP, n)
            x = store[s:e]
            y = torch.bmm(info.J.index_select(0, info.rows[s:e]).transpose(1, 2),
                          squares(x).float())
            z[s:e] = torch.bmm(y, info.I.index_select(0, info.cols[s:e]))
    return z


def block_sums_sq(index: BCSRIndex, tile: int, store: torch.Tensor) -> np.ndarray:
    """Per-block Frobenius-norm² (float32 like the reference's norms,
    ``src/mm/dbcsr_mm_common.F:629-694``; real for complex stores): two
    batched indicator matmuls on
    the device, the combine of blocks spanning several tiles on the host
    (float64, then rounded to float32, as the JAX package does)."""
    if index.nblks == 0:
        return np.zeros(0, dtype=np.float32)
    info = device_block_info(index, tile, store.device)
    z = per_tile_block_sums(store, info).cpu().numpy()
    bid = tile_block_info(index, tile).bid
    out = np.zeros(index.nblks + 1, dtype=np.float64)
    np.add.at(out, bid.reshape(-1) + 1, z.reshape(-1))
    return out[1:].astype(np.float32)


def block_mask_store(
    index: BCSRIndex, tile: int, device, dtype=torch.float32, keep=None,
) -> torch.Tensor:
    """[n_tiles, T, T] mask with 1 at positions of kept stored blocks:
    ``mask[t,i,j] = sum_ab J[t,i,a] keep[bid[t,a,b]] K[t,a,b] I[t,j,b]``,
    0/1-valued and exact in float32. ``keep=None`` keeps every stored block
    — the store-validity mask (1 on block-covered positions, 0 on padding);
    otherwise ``keep`` is a 0/1 vector over the blocks, on the host (numpy)
    or on ``device``."""
    lay = store_layout(index, tile)
    if lay.n_tiles == 0:
        return torch.zeros((0, tile, tile), dtype=dtype, device=device)
    info = device_block_info(index, tile, device)
    Kd = info.K
    if keep is not None:
        kf = torch.zeros(index.nblks + 1, dtype=torch.float32, device=info.K.device)
        kf[1:] = torch.as_tensor(keep, device=info.K.device).to(torch.float32)
        Kd = kf[info.bid_p1] * info.K
    # J[tr(t)] @ Kd[t] @ I[tc(t)]^T, in tile batches (bounded scratch)
    out = torch.empty((lay.n_tiles, tile, tile), dtype=dtype, device=device)
    for s in range(0, lay.n_tiles, _TILE_STEP):
        e = min(s + _TILE_STEP, lay.n_tiles)
        jk = torch.bmm(info.J.index_select(0, info.rows[s:e]), Kd[s:e])
        out[s:e] = torch.bmm(
            jk, info.I.index_select(0, info.cols[s:e]).transpose(1, 2)
        ).to(dtype)
    return out


def keep_blocks_(store: torch.Tensor, info: DeviceBlockInfo, keep: torch.Tensor
                 ) -> torch.Tensor:
    """Zero, in place, the blocks of ``store`` whose ``keep`` entry (a 0/1
    float32 vector over ``info``'s blocks) is 0, and every position no
    block covers: ``block_mask_store``'s mask, made and applied a batch of
    tiles at a time. Tiles past ``info``'s (a shard's padding) are left as
    they are."""
    kf = torch.zeros(keep.shape[0] + 1, dtype=torch.float32, device=info.K.device)
    kf[1:] = keep
    n = info.K.shape[0]
    for s in range(0, n, _TILE_STEP):
        e = min(s + _TILE_STEP, n)
        kd = kf[info.bid_p1[s:e]] * info.K[s:e]
        jk = torch.bmm(info.J.index_select(0, info.rows[s:e]), kd)
        store[s:e] *= torch.bmm(jk, info.I.index_select(0, info.cols[s:e]).transpose(1, 2))
    return store


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
    over the transposed tile grid. ``conj`` conjugates a complex store
    (physically, not as torch's lazy view); on real stores it is the
    identity.
    """
    order, coords_t = transpose_order(m_index, tile)
    perm = torch.as_tensor(order, dtype=torch.int64, device=store.device)
    out = store.index_select(0, perm).transpose(1, 2).contiguous()
    if conj and out.is_complex():
        out = out.conj_physical_()
    return out, coords_t
