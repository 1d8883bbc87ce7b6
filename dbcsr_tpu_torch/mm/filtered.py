"""Device-resident epsilon-filtered multiply: the linear-scaling SCF form.

Port of ``dbcsr_tpu/mm/filtered.py``. The reference recomputes block norms
every SCF step, applies per-row thresholds inside its multiply
(``src/mm/dbcsr_mm_cannon.F:1042-1113``) and prunes the product to blocks
with Frobenius norm >= eps (``multrec_filtering``,
``src/mm/dbcsr_mm_multrec.F:390``). The plan-once form here:

* Plan ONCE on the operand patterns (the symbolic SUPERSET product, no
  norms): C's superset index, the stack plan (``build_multiply_executor``)
  and the block<->tile indicator structure on the device. Host work happens
  only when a pattern changes.
* Per call, device work with no host sync: superset product (the same
  kernels every unfiltered multiply uses) → per-block Frobenius norms², a
  pass over each tile's stored atom-block cells + an ordered segment sum →
  keep = norms² >= eps² and zeros written over the dropped blocks, in
  place (on a card the two hand-written kernels of
  ``csrc/block_filter.cu``, ``block/tileops.py``). Data may change every
  call.

Equivalence to ``multiply(filter_eps=...)`` with ``filter_mode="sum"`` (the
default): a C block is pre-dropped there iff
``sum_k |A_ik|^2 |B_kj|^2 < (eps/row_nk)^2``; by Cauchy-Schwarz
``|C_ij|_F <= sum_k |A_ik||B_kj| < eps`` then, so every pre-dropped block is
one the final filter removes anyway. The superset product with only the
final filter therefore keeps the same blocks (up to exact-boundary ties)
with the same values.

The result stays in MASK form: C's superset index with dropped blocks
zeroed (padding and dropped positions exactly 0: the superset product of
stores with zero padding leaves every position no superset block covers at
exact 0, so only the dropped blocks are written), so it feeds the next
step with no conversion. ``compact()`` builds the pruned ``BCSRMatrix``.
The JAX package composes ``step`` under jit/scan; here a Python loop of
steps is the equivalent (each step only enqueues device work).

Over a process grid (``dist=``, ``ShardedFilteredExecutor``) the same step
runs sharded at rest, as CP2K runs its SCF multiply over MPI ranks: each
rank runs its Cannon (or SUMMA) ticks into its own C shard (its C panel,
the superset tiles it owns), then takes the norms² of its own blocks on
its device, with the same kernels over its shard, and zeroes its dropped
blocks in place. Nothing is gathered: only a block whose tiles lie
on more than one rank needs more than its rank's partial, and its partial
norms² are summed over those ranks alone, in rank order, on each of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..block.bcsr import BCSRMatrix
from ..block.index import BCSRIndex, build_index
from ..block.store import store_layout
from ..block.tileops import (
    DeviceBlockInfo,
    SegmentTables,
    block_info,
    device_block_info,
    keep_blocks,
    segment_tables,
    take_tiles,
    tile_align_map,
    tile_block_pairs,
    tile_block_sumsq,
)
from ..core.errors import dbcsr_assert
from ..core.stats import get_stats
from ..core.timing import timed

__all__ = ["FilteredExecutor", "ShardedFilteredExecutor", "build_filtered_executor",
           "filter_store_"]


@dataclass
class FilteredExecutor:
    """Plan-once eps-filtered multiply over fixed operand patterns.

    ``step(a_data, b_data) -> (c_data, keep, norms_sq)``: ``c_data`` is the
    product in C's SUPERSET store layout with blocks of Frobenius norm <
    eps zeroed (in place, in the store the product was written to),
    ``keep`` the float32 0/1 vector over superset blocks,
    ``norms_sq`` the pre-mask block norms² (float32), all on the operands'
    device. ``eff_flops`` counts the superset product (the flops the device
    performs, block-granular); ``kept_flops(keep)`` gives the filtered
    accounting of the host-planned path."""

    transa: str
    transb: str
    eps: float
    c_index: BCSRIndex  # superset pattern
    eff_flops: float
    tile: int
    dtype: torch.dtype
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # superset executor
    _flop_w: np.ndarray  # per-superset-block effective flops (host)

    def step(
        self, a_data: torch.Tensor, b_data: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c_sup = self.fn(a_data, b_data).contiguous()
        keep, nsq = filter_store_(c_sup, self.c_index, self.tile, self.eps)
        return c_sup, keep, nsq

    def kept_flops(self, keep) -> float:
        """Effective flops restricted to kept blocks — the number the
        host-planned filtered path reports."""
        keep = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else keep
        return float(np.asarray(keep, dtype=np.float64) @ self._flop_w)

    def compact(self, c_data: torch.Tensor, keep) -> BCSRMatrix:
        """The pruned matrix (the reference's compacted form): host index
        over the kept blocks + one tile-level gather. Pay this once at the
        end of an iterative loop, not per step."""
        keep = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else keep
        keep_np = np.asarray(keep) > 0.5
        new_index, _ = build_index(
            self.c_index.blk_rows[keep_np].astype(np.int64),
            self.c_index.col_idx[keep_np].astype(np.int64),
            self.c_index.row_block_sizes, self.c_index.col_block_sizes,
        )
        amap = tile_align_map(
            store_layout(new_index, self.tile).tile_keys(),
            store_layout(self.c_index, self.tile).tile_keys(),
        )
        # dropped blocks sharing tiles with survivors are already zeroed by
        # the step's keep mask: the store invariant holds
        return BCSRMatrix(name="product", index=new_index,
                          data=take_tiles(c_data, amap, self.tile))


def filter_store_(store: torch.Tensor, index: BCSRIndex, tile: int, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eps filter on a store in mask form, in place: block norms² in
    single precision (span ``filtered/norms``), then zeros over every block
    of norm² below eps² (span ``filtered/mask``). Returns ``(keep,
    norms_sq)``, float32 over ``index``'s blocks, on the store's device."""
    if index.nblks == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=store.device)
        return empty, empty
    with timed("filtered/norms"):
        info = device_block_info(index, tile, store.device)
        nsq = info.block_sum(tile_block_sumsq(store, info).reshape(-1))
    with timed("filtered/mask"):
        # eps² rounded to float32 as the reference's single-precision
        # norms; a Python scalar needs no host-to-device copy
        keep = keep_blocks(store, info, nsq, float(np.float32(eps) ** 2))
    return keep, nsq


def _pattern(index: BCSRIndex, trans: bool) -> sp.csr_matrix:
    pat = sp.csr_matrix(
        (np.ones(index.nblks), index.col_idx.astype(np.int64),
         index.row_ptr.astype(np.int64)),
        shape=(index.nblkrows, index.nblkcols),
    )
    return pat.T.tocsr() if trans else pat


def build_filtered_executor(
    transa: str,
    transb: str,
    a: BCSRMatrix,
    b: BCSRMatrix,
    eps: float,
    *,
    driver: Optional[str] = None,
    dist=None,
):
    """Plan the eps-filtered multiply ``C = op(A)·op(B), |C_blk| >= eps``
    for repeated execution with CHANGING data over fixed patterns — the
    analog of the reference's batched-multiply state machine wrapped around
    its filtered multiply (linear-scaling SCF's inner loop).

    With ``dist`` (a ``Distribution`` whose grid may span the processes of
    ``init_lib(distributed=True)``) the step runs over the grid, sharded at
    rest: a ``ShardedFilteredExecutor``, whose ``step`` takes this
    process's A shards and returns its C shards (B's data is read here,
    once)."""
    from ..ops.transform import desymmetrize
    from .engine import build_multiply_executor

    if dist is not None:
        dbcsr_assert(driver is None, "driver= names a local driver; the grid's "
                                     "algorithm is the config's mm_dist_algo")
        return _build_sharded(transa, transb, a, b, eps, dist)
    with timed("filtered/build"):
        dbcsr_assert(eps is not None and float(eps) > 0.0, "eps must be > 0")
        # the flop weights below read the operand patterns: expand symmetric
        # storage first (the JAX package reads the stored triangle there and
        # undercounts kept_flops)
        a, b = desymmetrize(a), desymmetrize(b)
        fn, c_index, eff_flops = build_multiply_executor(
            transa, transb, a, b, driver=driver
        )
        with timed("filtered/prep"):
            # the block structure goes to the device at plan time, not in step
            device_block_info(c_index, a.tile, a.device)

            # per-block effective flops of the superset product (static):
            # flops(i,j) = 2 * m_i * n_j * sum_k k_size over contributing triples
            ta = transa.upper() in ("T", "C")
            tb = transb.upper() in ("T", "C")
            k_sizes = (a.index.row_block_sizes if ta
                       else a.index.col_block_sizes).astype(np.float64)
            ksum = (_pattern(a.index, ta).multiply(k_sizes[None, :]).tocsr()
                    @ _pattern(b.index, tb)).tocsr()
            rows = c_index.blk_rows.astype(np.int64)
            cols = c_index.col_idx.astype(np.int64)
            ks = np.asarray(ksum[rows, cols]).ravel() if c_index.nblks else np.zeros(0)
            flop_w = (2.0 * c_index.row_block_sizes.astype(np.float64)[rows]
                      * c_index.col_block_sizes.astype(np.float64)[cols] * ks)

    return FilteredExecutor(
        transa=transa, transb=transb, eps=float(eps), c_index=c_index,
        eff_flops=eff_flops, tile=a.tile, dtype=a.dtype, fn=fn, _flop_w=flop_w,
    )


# ---------------------------------------------------------------------------
# over a process grid, sharded at rest
# ---------------------------------------------------------------------------

@dataclass
class _RankFilter:
    """One plane rank's share of the filter, resident on its device: the
    block structure of its shard's tiles with the blocks numbered locally
    (``info``; ``n`` real tiles, the padding after them untouched), and
    the counts that a call adds to the statistics."""

    n: int
    info: DeviceBlockInfo
    eff_flops: float
    hw_flops: float  # what its ticks issue (``RankPlan.hw_flops``, layers summed)
    padded_flops: float  # the tile figure, 2·T³ an entry
    segments: Tuple[int, int]  # (split_runs, run_segments) of its ticks, layers summed


@dataclass
class _Share:
    """The blocks that rank ``src`` and rank ``dst`` both hold part of:
    their positions in each rank's block numbering (on the rank's device;
    None where the rank is off this process)."""

    src: int
    dst: int
    src_pos: Optional[torch.Tensor]
    dst_pos: Optional[torch.Tensor]
    n: int


@dataclass
class ShardedFilteredExecutor:
    """Plan-once eps-filtered multiply over a process grid, sharded at rest.

    ``step(a_shards) -> (c_shards, keep, norms_sq)``: ``a_shards`` are A's
    shards in the layout ``shard_a`` (``dist.sharded.shard_store_with_layout``;
    this process's entries, None for the others'), B is the one given at
    build. ``c_shards`` are C's superset shards in the layout ``shard_c``
    (a rank's C panel: its superset tiles, then zero padding), dropped
    blocks zero; ``keep`` and ``norms_sq`` are per plane rank float32
    vectors over ``rank_blocks[d]``, the superset blocks (global ids,
    ascending) with a part on rank ``d``. Lists run over the grid's (i, j)
    plane, None off this process.

    ``spanning`` counts the superset blocks whose tiles lie on more than
    one rank: the only blocks whose norms² take messages (their partials,
    one float32 each, to the other ranks that hold a part)."""

    transa: str
    transb: str
    eps: float
    c_index: BCSRIndex  # superset pattern
    eff_flops: float
    tile: int
    dtype: torch.dtype
    grid: object
    fn: Callable  # the sharded distributed executor
    shard_a: object
    shard_c: object
    rank_blocks: List[Optional[np.ndarray]]
    spanning: int
    _b_pieces: list
    _ranks: List[Optional[_RankFilter]]
    #: (src, dst) -> _Share, every pair of ranks that share blocks, in
    #: (src, dst) order on every process (a message's tag is its place)
    _shares: Dict[Tuple[int, int], _Share]

    def step(self, a_shards: List[Optional[torch.Tensor]]
             ) -> Tuple[list, list, list]:
        panels = self.fn.plan.run(self.fn.pieces_a(a_shards), self._b_pieces, self.dtype)
        c = [None if x is None else x.to(self.dtype) for x in panels]
        ranks = self._ranks
        with timed("filtered/norms"):
            part = [None if rf is None else
                    rf.info.block_sum(tile_block_sumsq(x[:rf.n], rf.info).reshape(-1))
                    for rf, x in zip(ranks, c)]
            nsq = self._sum_shared(part)
        keep: list = [None] * len(ranks)
        with timed("filtered/mask"):
            # eps² rounded to float32, as the one-card step takes it
            thr = float(np.float32(self.eps) ** 2)
            for d, rf in enumerate(ranks):
                if rf is not None:
                    keep[d] = keep_blocks(c[d][:rf.n], rf.info, nsq[d], thr)
        stats = get_stats()
        stats.num_multiplications += 1
        for rf in ranks:
            if rf is not None:
                stats.total_flops += rf.eff_flops
                stats.add_tile_flops(rf.hw_flops, rf.padded_flops)
                stats.add_segments(*rf.segments)
        return c, keep, nsq

    def _sum_shared(self, part: list) -> list:
        """Each rank's norms²: its own partials, and for a block it shares
        the holders' partials added in rank order (0 + p_r0 + p_r1 + ...),
        the same sum on every holder. Partials from a rank of another
        process arrive in one batch of messages."""
        from ..dist import comm

        own = self.grid.plane().owner_list()
        remote = [sh for sh in self._shares.values() if own[sh.src] != own[sh.dst]]
        got = comm.exchange([(own[sh.src], own[sh.dst], (sh.n,), torch.float32)
                             for sh in remote],
                            lambda i: part[remote[i].src].index_select(0, remote[i].src_pos))
        came = {(remote[i].src, remote[i].dst): x for i, x in got.items()}
        out: list = [None] * len(part)
        for d, p in enumerate(part):
            if p is None:
                continue
            total = torch.zeros_like(p)
            for h in range(len(part)):
                if h == d:
                    total += p
                    continue
                sh = self._shares.get((h, d))
                if sh is not None:
                    x = came.get((h, d))
                    if x is None:  # a rank of this process
                        x = comm.move(part[h].index_select(0, sh.src_pos), p.device)
                    total[sh.dst_pos] += x
            out[d] = total
        return out


def _rank_block_info(c_index: BCSRIndex, tile: int, sl, d: int, pairs: tuple,
                     mine: np.ndarray, blocks: np.ndarray,
                     tables: SegmentTables) -> DeviceBlockInfo:
    """``device_block_info`` of rank ``d``'s shard of C: its real tiles in
    shard order, its blocks (``blocks``, the (block, tile) ``pairs`` that
    are ``mine``) numbered locally, on ``tables``' device."""
    slot, sa, sb, blk = (x[mine] for x in pairs)
    n = int((sl.owner_of_slot == d).sum())
    bid = np.full((n, tables.heights.shape[1], tables.widths.shape[1]), -1, dtype=np.int64)
    bid[sl.local_of_slot[slot], sa, sb] = np.searchsorted(blocks, blk)
    coords = store_layout(c_index, tile).tile_coords.astype(np.int64)
    slots = sl.slot_of_pos[d * sl.n_max:d * sl.n_max + n]
    return block_info(tables, coords[slots, 0], coords[slots, 1], bid, len(blocks))


def _shares(rank_blocks: List[np.ndarray], holders: np.ndarray, owners: List[int],
            devices: list, me: int) -> Dict[Tuple[int, int], _Share]:
    """Every ordered pair of ranks that hold parts of one block, listed
    alike on every process (a message's tag is its place in the list)."""
    span = np.flatnonzero(holders > 1)
    holds = []
    for blocks in rank_blocks:
        h = np.zeros(len(holders), dtype=bool)
        h[blocks] = True
        holds.append(h[span])

    def pos(r, both):
        if owners[r] != me:
            return None
        return torch.as_tensor(np.searchsorted(rank_blocks[r], both), device=devices[r])

    out = {}
    for h in range(len(rank_blocks)):
        for d in range(len(rank_blocks)):
            both = span[holds[h] & holds[d]]
            if h != d and len(both):
                out[(h, d)] = _Share(src=h, dst=d, src_pos=pos(h, both),
                                     dst_pos=pos(d, both), n=len(both))
    return out


def _elements_in_bins(sizes: np.ndarray, tile_bins: np.ndarray, tile: int,
                      nbins: int) -> np.ndarray:
    """float64 ``[n_blocks, nbins]``: the elements of each block (of one
    dimension) that lie in tiles of each bin."""
    sizes = np.asarray(sizes, dtype=np.int64)
    blk = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
    tb = np.asarray(tile_bins, dtype=np.int64)[np.arange(len(blk)) // tile]
    return np.bincount(blk * nbins + tb, minlength=len(sizes) * nbins
                       ).reshape(len(sizes), nbins).astype(np.float64)


def _rank_eff_flops(a: BCSRMatrix, ta: bool, b: BCSRMatrix, tb: bool, dp) -> np.ndarray:
    """float64 ``[p, q]``: the effective flops (2·m·k·n a block triple) of
    the C elements each plane rank of ``dp`` (a ``cannon.DistPlan``) owns.
    A triple's sum over (i, j) for a fixed k factorises, so rank (r, s)
    takes 2·Σ_k k·(Σ_i m_i^r)·(Σ_j n_j^s) over the i of op(A)'s column k and
    the j of op(B)'s row k, m_i^r being block row i's elements in row bin
    r."""
    m_in = _elements_in_bins(dp.m_sizes, dp.rowb, dp.tile, dp.grid.nprow)
    n_in = _elements_in_bins(dp.n_sizes, dp.colb, dp.tile, dp.grid.npcol)
    a_col = _pattern(a.index, ta).T.tocsr() @ m_in  # [k, p]
    b_row = _pattern(b.index, tb) @ n_in  # [k, q]
    return 2.0 * np.einsum("k,kr,ks->rs", dp.k_sizes.astype(np.float64),
                           np.asarray(a_col), np.asarray(b_row))


def _build_sharded(transa: str, transb: str, a: BCSRMatrix, b: BCSRMatrix,
                   eps: float, dist) -> ShardedFilteredExecutor:
    from ..dist import comm
    from ..dist.sharded import plane_devices, plane_owners, shard_store_with_layout
    from ..ops.transform import desymmetrize
    from .engine import _effective_trans, _promote_operands, build_distributed_executor

    with timed("filtered/build"):
        dbcsr_assert(eps is not None and float(eps) > 0.0, "eps must be > 0")
        a, b = _promote_operands(a, b)
        a, b = desymmetrize(a), desymmetrize(b)
        fn, c_index, eff_flops = build_distributed_executor(transa, transb, a, b, dist,
                                                            sharded=True)
        grid, tile = dist.grid, a.tile
        ta, tb = _effective_trans(transa)[0], _effective_trans(transb)[0]
        with timed("filtered/prep"):
            b_pieces = fn.pieces_b(shard_store_with_layout(b, fn.shard_b, grid))
            sl = fn.shard_c
            p, q = sl.p, sl.q
            me = comm.rank()
            owners, devices = plane_owners(grid), plane_devices(grid)
            eff = _rank_eff_flops(a, ta, b, tb, fn.dist_plan).reshape(-1)
            # the flops the ticks of each plane rank's layers issue
            issued = fn.plan.hw_flops.reshape(p * q, -1).sum(axis=1)
            padded = fn.plan.padded_flops.reshape(p * q, -1).sum(axis=1)
            segments = fn.plan.rank_segments().reshape(p * q, -1, 2).sum(axis=1)
            # (block, tile) pairs of C's superset, by owner rank; the pairs
            # run block by block, so each rank's blocks come sorted
            pairs = tile_block_pairs(c_index, tile)
            owner = sl.owner_of_slot[pairs[0]]
            rank_blocks = []
            for d in range(p * q):
                x = pairs[3][owner == d]
                rank_blocks.append(x[np.concatenate(([True], x[1:] != x[:-1]))]
                                   if len(x) else x)
            holders = np.bincount(np.concatenate(rank_blocks), minlength=c_index.nblks)
            ranks: List[Optional[_RankFilter]] = []
            for d in range(p * q):
                if owners[d] != me:
                    ranks.append(None)
                    continue
                info = _rank_block_info(c_index, tile, sl, d, pairs, owner == d,
                                        rank_blocks[d],
                                        segment_tables(c_index, tile, devices[d]))
                ranks.append(_RankFilter(n=info.bid_p1.shape[0], info=info, eff_flops=float(eff[d]),
                                         hw_flops=float(issued[d]),
                                         padded_flops=float(padded[d]),
                                         segments=(int(segments[d, 0]), int(segments[d, 1]))))
            shares = _shares(rank_blocks, holders, owners, devices, me)
    return ShardedFilteredExecutor(
        transa=transa, transb=transb, eps=float(eps), c_index=c_index,
        eff_flops=eff_flops, tile=tile, dtype=a.dtype, grid=grid, fn=fn,
        shard_a=fn.shard_a, shard_c=sl, rank_blocks=rank_blocks,
        spanning=int((holders > 1).sum()), _b_pieces=b_pieces, _ranks=ranks,
        _shares=shares,
    )
