"""Tile-granular device operations on tile stores.

Port of ``dbcsr_tpu/block/tileops.py``: store alignment by tile keys
(``tile_align_map``, ``take_tiles``), coordinate masks (``coord_mask``), the
block↔tile structure of a store — each tile row's and tile column's
atom-block segments and each tile's stored (segment-row, segment-col)
cells (``segment_tables``, ``device_block_info``) — and what the eps
filter does with it: per-block norms² (``tile_block_sumsq``,
``block_sums_sq``) and the zeroing of dropped blocks (``keep_blocks``), on
a card by the hand-written kernels of ``csrc/block_filter.cu``, which walk
each tile's segments in place, on the CPU by their plain versions; block
keep/validity masks (``block_mask_store``, ``valid_mask``) as small
per-tile indicator matmuls; and the transposed store
(``transpose_store``). Every gather moves whole
T×T tiles. Reductions whose destinations repeat (a block spanning several
tiles, a tile column) run as ``OrderedSegmentSum``: one pass per position
within a segment, never atomics, so they are deterministic on the GPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.stats import get_stats
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
    "segment_bounds",
    "SegmentTables",
    "segment_tables",
    "DeviceBlockInfo",
    "block_info",
    "device_block_info",
    "slots_block_info",
    "squares",
    "FILTER_DTYPES",
    "tile_block_sumsq",
    "tile_block_sumsq_plain",
    "keep_blocks",
    "keep_blocks_plain",
    "block_sums_sq",
    "block_mask_store",
    "valid_mask",
    "transpose_order",
    "transpose_store",
]

#: tiles per batch of the plain norm and mask passes (bounds their scratch:
#: 4096 f32 tiles of 128² are 268 MB)
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


def segment_bounds(J: np.ndarray) -> np.ndarray:
    """int32 ``[n, seg_max + 1]`` from one dimension's indicators ``J``
    ``[n, T, seg_max]``: the first row of each segment within its tile row
    (column within its tile column), then the end of the last. The segments
    of a tile row cover its rows from 0 on, so the bounds are the running
    sum of the segments' heights; past the last segment they stay at its end
    (the padding after it belongs to no segment)."""
    heights = J.sum(axis=1).astype(np.int64)
    return np.concatenate(
        [np.zeros((len(J), 1), np.int64), np.cumsum(heights, axis=1)], axis=1
    ).astype(np.int32)


@dataclass(frozen=True)
class SegmentTables:
    """One index's tables at tile edge T on one device, shared by every tile
    (and every shard) of a tile row or column: the indicators ``J`` [ntr, T,
    amax] / ``I`` [ntc, T, bmax] and the segment bounds ``rseg`` [ntr, amax +
    1] / ``cseg`` [ntc, bmax + 1] (``segment_bounds``), with the segments'
    heights and widths on the host."""

    J: torch.Tensor
    I: torch.Tensor
    rseg: torch.Tensor
    cseg: torch.Tensor
    heights: np.ndarray  # int64 [ntr, amax]
    widths: np.ndarray  # int64 [ntc, bmax]


def segment_tables(index: BCSRIndex, tile: int, device) -> SegmentTables:
    """Cached per (index, tile, device)."""
    dev = torch.device(device)

    def mk():
        rows = row_indicators(index.row_block_sizes, tile, index, "rows").J
        cols = row_indicators(index.col_block_sizes, tile, index, "cols").J
        rseg, cseg = segment_bounds(rows), segment_bounds(cols)
        return SegmentTables(
            J=torch.as_tensor(rows, device=dev), I=torch.as_tensor(cols, device=dev),
            rseg=torch.as_tensor(rseg, device=dev), cseg=torch.as_tensor(cseg, device=dev),
            heights=np.diff(rseg, axis=1).astype(np.int64),
            widths=np.diff(cseg, axis=1).astype(np.int64),
        )

    return index._cached(("segment_tables", tile, str(dev)), mk)


@dataclass(frozen=True)
class DeviceBlockInfo:
    """The block structure of a run of tiles, resident on one device: the
    shared tables of ``SegmentTables`` (``J``, ``I``, ``rseg``, ``cseg``),
    each tile's tile row and column (into them), ``bid_p1`` [n_tiles, amax,
    bmax] — the id + 1 of the STORED block that a (segment-row,
    segment-col) cell holds, 0 where none —, the reduction of per-tile
    (a, b) sums into per-block sums (``block_sum``) and the elements that
    the stored cells cover (``stored_elems``)."""

    J: torch.Tensor
    I: torch.Tensor
    rows: torch.Tensor  # int64 [n_tiles]
    cols: torch.Tensor  # int64 [n_tiles]
    bid_p1: torch.Tensor  # int64 [n_tiles, amax, bmax]
    block_sum: OrderedSegmentSum  # flat z [n_tiles·amax·bmax] -> [n_blocks]
    rseg: torch.Tensor  # int32 [ntr, amax + 1]
    cseg: torch.Tensor  # int32 [ntc, bmax + 1]
    stored_elems: int

    @property
    def n_blocks(self) -> int:
        return self.block_sum.n_seg


def block_info(tables: SegmentTables, rows: np.ndarray, cols: np.ndarray,
               bid: np.ndarray, n_blocks: int) -> DeviceBlockInfo:
    """The ``DeviceBlockInfo`` of the tiles at tile rows ``rows`` and tile
    columns ``cols`` whose cells hold the blocks ``bid`` ([n_tiles, amax,
    bmax], -1 where none, ids in [0, n_blocks)), on the tables' device."""
    dev = tables.J.device
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    stored = np.einsum("ta,tab,tb->", tables.heights[rows].astype(np.float64),
                       (bid >= 0).astype(np.float64),
                       tables.widths[cols].astype(np.float64))
    return DeviceBlockInfo(
        J=tables.J, I=tables.I,
        rows=torch.as_tensor(rows, device=dev), cols=torch.as_tensor(cols, device=dev),
        bid_p1=torch.as_tensor(np.ascontiguousarray(bid + 1, dtype=np.int64), device=dev),
        block_sum=ordered_segment_sum(bid.reshape(-1), n_blocks, dev),
        rseg=tables.rseg, cseg=tables.cseg, stored_elems=int(stored),
    )


def device_block_info(index: BCSRIndex, tile: int, device) -> DeviceBlockInfo:
    """Cached per (index, tile, device)."""
    dev = torch.device(device)

    def mk():
        coords = store_layout(index, tile).tile_coords
        return block_info(segment_tables(index, tile, dev), coords[:, 0], coords[:, 1],
                          tile_block_info(index, tile).bid, index.nblks)

    return index._cached(("device_block_info", tile, str(dev)), mk)


def slots_block_info(index: BCSRIndex, tile: int, slots: np.ndarray, device
                     ) -> DeviceBlockInfo:
    """``device_block_info`` of the store's tiles at ``slots``, in that order,
    the blocks keeping their ids; a slot of -1 stands for a zero tile (a
    shard's padding), which holds no block."""
    slots = np.asarray(slots, dtype=np.int64)
    held = np.maximum(slots, 0)
    coords = store_layout(index, tile).tile_coords[held]
    bid = np.where((slots >= 0)[:, None, None], tile_block_info(index, tile).bid[held], -1)
    return block_info(segment_tables(index, tile, device), coords[:, 0], coords[:, 1],
                      bid, index.nblks)


def squares(x: torch.Tensor) -> torch.Tensor:
    """|x|² in x's precision, real: ``x·x`` for real data, the real part of
    ``x·conj(x)`` for complex data (re² + im²), as the JAX package takes it."""
    return (x * x.conj()).real if x.is_complex() else x * x


# ---------------------------------------------------------------------------
# the filter's kernels: block norms² and the keep-zeroing, over each tile's
# segments (csrc/block_filter.cu), with their plain versions
# ---------------------------------------------------------------------------

#: store types the filter kernels take, with the kernels' type codes
#: (``csrc/block_filter.cu``); the wrappers refuse any other on every device
FILTER_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
                 torch.complex64: 3, torch.complex128: 4}


def _check_filter_operands(store: torch.Tensor, info: DeviceBlockInfo, what: str,
                           extra=()) -> None:
    """The filter wrappers' checks, on every device: the store's shape, type
    and contiguity, its tiles against the plan's, every plan array on the
    store's device; on a card the tile edge and 16-byte alignment too."""
    if store.dim() != 3 or store.shape[1] != store.shape[2]:
        raise ValueError(f"{what}: a tile store is [n, T, T], got {tuple(store.shape)}")
    if store.dtype not in FILTER_DTYPES:
        raise TypeError(f"{what}: no kernel for dtype {store.dtype}")
    if not store.is_contiguous():
        raise ValueError(f"{what}: the tile store must be contiguous")
    if store.shape[0] != info.rows.shape[0] or store.shape[1] != info.J.shape[1]:
        raise ValueError(f"{what}: a store of {store.shape[0]} tiles of {store.shape[1]}, "
                         f"a plan of {info.rows.shape[0]} of {info.J.shape[1]}")
    for t in (info.rows, info.cols, info.rseg, info.cseg, info.bid_p1, *extra):
        if t.device != store.device or not t.is_contiguous():
            raise ValueError(f"{what}: plan arrays must be contiguous on {store.device}, "
                             f"one is on {t.device}")
    if store.device.type == "cpu":
        return
    if store.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {store.device}")
    from ..mm.kernels import KERNEL_TILES

    if store.shape[1] not in KERNEL_TILES:
        raise ValueError(f"{what}: tile edge {store.shape[1]} not in {KERNEL_TILES}")
    if store.data_ptr() % 16:
        raise ValueError(f"{what}: the tile store must start on a 16-byte boundary")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _cell_mask(info: DeviceBlockInfo, kd: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """float32 [e - s, T, T]: ``J[tr(t)] @ kd[t] @ I[tc(t)]^T`` for tiles
    s..e-1, each position taking the value ``kd`` [e - s, amax, bmax] gives
    its cell (0 on the padding); exact for 0/1 ``kd`` (one term a sum)."""
    jk = torch.bmm(info.J.index_select(0, info.rows[s:e]), kd)
    return torch.bmm(jk, info.I.index_select(0, info.cols[s:e]).transpose(1, 2))


def tile_block_sumsq_plain(store: torch.Tensor, info: DeviceBlockInfo) -> torch.Tensor:
    """Plain version of ``tile_block_sumsq`` (any device):
    ``z[t, a, b] = Σ_ij J[t,i,a]·|x[t,i,j]|²·I[t,j,b]`` as two batched
    indicator matmuls in float32 (IEEE, TF32 off), squares taken in the
    store's precision (|z|² for complex stores) and rounded to float32, as
    the JAX package takes them. It sums every cell, stored or not; the
    kernel writes 0 where no block is stored (the padding there is 0)."""
    from ..mm.kernels import tf32_matmul

    n = store.shape[0]
    z = store.new_empty((n, *info.bid_p1.shape[1:]), dtype=torch.float32)
    with tf32_matmul(False):
        for s in range(0, n, _TILE_STEP):
            e = min(s + _TILE_STEP, n)
            y = torch.bmm(info.J.index_select(0, info.rows[s:e]).transpose(1, 2),
                          squares(store[s:e]).float())
            z[s:e] = torch.bmm(y, info.I.index_select(0, info.cols[s:e]))
    return z


def tile_block_sumsq(store: torch.Tensor, info: DeviceBlockInfo) -> torch.Tensor:
    """``z``, float32 ``[n_tiles, amax, bmax]``: Σ |x|² over each stored cell
    (a, b) of each tile, norms² of the blocks' parts in single precision
    like the reference's (``calculate_norms.cpp``): squares in the store's
    precision (re² + im² for complex stores), rounded to float32, summed in
    float32 (rows of a segment, then its columns). CPU stores run the plain
    version; CUDA stores launch ``block_sumsq_kernel``
    (``csrc/block_filter.cu``), which reads only the stored cells. On every
    device it raises on what the kernel does not take: TypeError for a type
    outside ``FILTER_DTYPES``, ValueError for the shape, contiguity or
    placement, and on a card for the tile edge or alignment."""
    what = "tile_block_sumsq"
    _check_filter_operands(store, info, what)
    if store.device.type == "cpu":
        return tile_block_sumsq_plain(store, info)
    from .._build import check_launch, kernels

    n, amax, bmax = info.bid_p1.shape
    z = torch.empty((n, amax, bmax), dtype=torch.float32, device=store.device)
    if n:
        lib = kernels()
        rc = lib.dbcsr_torch_block_sumsq(
            store.data_ptr(), z.data_ptr(), info.rows.data_ptr(), info.cols.data_ptr(),
            info.rseg.data_ptr(), info.cseg.data_ptr(), info.bid_p1.data_ptr(),
            n, amax, bmax, store.shape[1], FILTER_DTYPES[store.dtype],
            store.device.index, _stream(store),
        )
        check_launch(lib, rc, what)
        tile_block_sumsq.launches += 1
        # the stored cells' elements read, and a cell's block id read and sum
        # written
        get_stats().filter_bytes += info.stored_elems * store.element_size() + z.numel() * 12
    return z


#: launches of the block norms² kernel since the last reset (set it to 0 to
#: reset)
tile_block_sumsq.launches = 0


def keep_blocks_plain(store: torch.Tensor, info: DeviceBlockInfo, nsq: torch.Tensor,
                      eps_sq: float) -> torch.Tensor:
    """Plain version of ``keep_blocks`` (any device): the keep vector, then
    every position outside the kept blocks set to 0 in place, by the kept
    cells' mask (``_cell_mask``) a batch of tiles at a time. That zeroes the
    padding as well, which holds 0 already."""
    keep = (nsq >= eps_sq).to(torch.float32)
    kf = torch.cat([keep.new_zeros(1), keep])  # id 0: no block
    n = store.shape[0]
    for s in range(0, n, _TILE_STEP):
        e = min(s + _TILE_STEP, n)
        store[s:e].masked_fill_(_cell_mask(info, kf[info.bid_p1[s:e]], s, e) == 0, 0)
    return keep


def keep_blocks(store: torch.Tensor, info: DeviceBlockInfo, nsq: torch.Tensor,
                eps_sq: float) -> torch.Tensor:
    """The eps filter's keep decision and mask, in place: returns ``keep``,
    float32 ``nsq >= eps_sq`` (1 or 0) over ``info``'s blocks, and writes
    zeros over every stored cell of ``store`` whose block is not kept
    (``nsq`` below ``eps_sq``, or NaN). Kept blocks are not touched. The
    positions no block covers hold 0 already (the superset product leaves
    them at exact 0); the kernel writes zeros over them only inside a
    32-byte sector of a row that a dropped block shares, the plain version
    everywhere. CPU stores run the plain version; CUDA stores launch
    ``keep_blocks_kernel`` (``csrc/block_filter.cu``). On every device it
    raises as ``tile_block_sumsq`` does, and on an ``nsq`` that is not
    float32 over ``info``'s blocks on the store's device."""
    what = "keep_blocks"
    _check_filter_operands(store, info, what, (nsq,))
    if nsq.dtype != torch.float32 or tuple(nsq.shape) != (info.n_blocks,):
        raise TypeError(f"{what}: nsq must be float32 [{info.n_blocks}], got {nsq.dtype} "
                        f"{tuple(nsq.shape)}")
    if store.device.type == "cpu":
        return keep_blocks_plain(store, info, nsq, eps_sq)
    from .._build import check_launch, kernels

    n, amax, bmax = info.bid_p1.shape
    keep = torch.empty(info.n_blocks, dtype=torch.float32, device=store.device)
    if n or info.n_blocks:
        lib = kernels()
        rc = lib.dbcsr_torch_keep_blocks(
            store.data_ptr(), nsq.data_ptr(), keep.data_ptr(), info.rows.data_ptr(),
            info.cols.data_ptr(), info.rseg.data_ptr(), info.cseg.data_ptr(),
            info.bid_p1.data_ptr(), n, info.n_blocks, amax, bmax, float(eps_sq),
            store.shape[1], FILTER_DTYPES[store.dtype], store.device.index, _stream(store),
        )
        check_launch(lib, rc, what)
        keep_blocks.launches += 1
        # the cells' block ids read; nsq read and keep written (the zeros
        # written depend on the data and are not counted)
        get_stats().filter_bytes += info.bid_p1.numel() * 8 + info.n_blocks * 8
    return keep


#: launches of the keep-zeroing kernel since the last reset (set it to 0 to
#: reset)
keep_blocks.launches = 0


def block_sums_sq(index: BCSRIndex, tile: int, store: torch.Tensor) -> np.ndarray:
    """Per-block Frobenius-norm² (float32 like the reference's norms,
    ``src/mm/dbcsr_mm_common.F:629-694``; real for complex stores): the
    per-tile sums on the device (``tile_block_sumsq``), the combine of
    blocks spanning several tiles on the host (float64, then rounded to
    float32, as the JAX package does)."""
    if index.nblks == 0:
        return np.zeros(0, dtype=np.float32)
    info = device_block_info(index, tile, store.device)
    z = tile_block_sumsq(store.contiguous(), info).cpu().numpy()
    bid = tile_block_info(index, tile).bid
    out = np.zeros(index.nblks + 1, dtype=np.float64)
    np.add.at(out, bid.reshape(-1) + 1, z.reshape(-1))
    return out[1:].astype(np.float32)


def block_mask_store(
    index: BCSRIndex, tile: int, device, dtype=torch.float32, keep=None,
) -> torch.Tensor:
    """[n_tiles, T, T] mask with 1 at positions of kept stored blocks:
    ``mask[t,i,j] = sum_ab J[t,i,a] keep[bid[t,a,b]] I[t,j,b]`` over the
    stored cells (a, b),
    0/1-valued and exact in float32. ``keep=None`` keeps every stored block
    — the store-validity mask (1 on block-covered positions, 0 on padding);
    otherwise ``keep`` is a 0/1 vector over the blocks, on the host (numpy)
    or on ``device``."""
    lay = store_layout(index, tile)
    if lay.n_tiles == 0:
        return torch.zeros((0, tile, tile), dtype=dtype, device=device)
    info = device_block_info(index, tile, device)
    kf = torch.ones(index.nblks + 1, dtype=torch.float32, device=info.bid_p1.device)
    kf[0] = 0  # id 0: no block
    if keep is not None:
        kf[1:] = torch.as_tensor(keep, device=kf.device).to(torch.float32)
    # in tile batches (bounded scratch)
    out = torch.empty((lay.n_tiles, tile, tile), dtype=dtype, device=device)
    for s in range(0, lay.n_tiles, _TILE_STEP):
        e = min(s + _TILE_STEP, lay.n_tiles)
        out[s:e] = _cell_mask(info, kf[info.bid_p1[s:e]], s, e).to(dtype)
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
