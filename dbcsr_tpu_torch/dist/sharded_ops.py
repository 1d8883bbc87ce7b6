"""Sharded elementwise, reduction and pattern-changing ops.

Port of ``dbcsr_tpu/dist/sharded_ops.py`` without its split-complex
emulation (``_emu_s_*``: the card holds complex natively). Every op acts
on the owner shards of a ``ShardedMatrix`` (``sharded.py``: one ``[n_max,
T, T]`` tensor per rank of the grid's (row, col) plane) rank by rank, and
never gathers a matrix onto one device: where the JAX package runs one
``jax.shard_map`` with ``lax.psum``/``pmax``, a loop visits the ranks and
the scalar partials are reduced on the host in rank order. On a grid that
spans processes a process visits its own ranks (the others' shards are
None) and the partials of all ranks reach every process
(``comm.gather_scalars``) before the same rank-order reduction, so every
process gets the single-process result, bit for bit.

The structural fact the ops rest on: pattern-changing results (add's index
union, hadamard's intersection, filter's survivors) keep the owner bins of
their operands (a tile's owner depends only on its tile row and column),
so the remap from an operand's layout to the result's is OWNER-LOCAL: one
tile gather per rank, resolved once on the host (``_remap_table``).

``build_sharded_multiply`` reshards the operands from their at-rest
layouts onto the executor's k-binned layouts (a per-rank gather from the
shards it needs) and runs the distributed executor of ``mm/engine.py``
with ``sharded=True``: every rank's product on the port's stack kernel.
``sharded_checkpoint_write/read`` keep the JAX package's file format
(``index.npz`` plus one ``shard_<d>.npy`` per rank); each process writes
and reads its own shards.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.index import BCSRIndex, build_index, merge_index
from ..block.store import store_layout
from ..block.tileops import (
    TileGather,
    apply_tile_gather,
    slots_block_info,
    take_tiles,
    tile_align_map,
    tile_block_info,
    tile_block_sumsq,
    tile_gather,
    valid_mask,
)
from ..core.errors import dbcsr_assert
from ..core.timing import timed
from . import comm
from ..mm.engine import _coefficient
from ..ops.arithmetic import _host_scalar as _host
from .distribution import Distribution
from .sharded import (
    ShardLayout,
    plane_devices,
    plane_owners,
    shard_layout,
    shard_store_with_layout,
    unshard_store_with_layout,
)

__all__ = [
    "ShardedMatrix",
    "shard_matrix",
    "build_sharded_multiply",
    "sharded_multiply",
    "build_sharded_add",
    "sharded_add",
    "build_sharded_hadamard",
    "sharded_hadamard",
    "sharded_scale",
    "build_sharded_scale_by_vector",
    "sharded_scale_by_vector",
    "sharded_function_of_elements",
    "sharded_trace",
    "sharded_dot",
    "sharded_frobenius",
    "sharded_maxabs",
    "sharded_block_norms",
    "sharded_filter",
    "sharded_checkpoint_write",
    "sharded_checkpoint_read",
]

_BF16_STR = "<V2"  # what numpy writes for a bfloat16 array (``ops/io.py``)


@dataclass(frozen=True)
class ShardedMatrix:
    """A BCSR matrix whose tile data lives owner-sharded on a grid's ranks:
    ``data`` is the list of the plane's shards (``[n_max, T, T]`` each, zero
    padded, laid out by ``shard``); ``index`` stays host metadata, as the
    reference keeps the block index on every rank while its ``data_area``
    is distributed. On a grid that spans processes a shard of another
    process is None; ``dtype`` is then the type of every shard (given, or
    read from a shard of this process)."""

    name: str
    index: BCSRIndex
    tile: int
    dist: Distribution
    shard: ShardLayout
    data: List[Optional[torch.Tensor]]
    sym: str = SYM_NONE
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        held = [x for x in self.data if x is not None]
        if held:
            object.__setattr__(self, "dtype", held[0].dtype)
        dbcsr_assert(self.dtype is not None,
                     "a ShardedMatrix that holds no shard here needs its dtype")

    @property
    def nblks(self) -> int:
        return self.index.nblks

    @property
    def grid(self):
        return self.dist.grid

    def with_data(self, data: List[Optional[torch.Tensor]]) -> "ShardedMatrix":
        return replace(self, data=list(data))

    def to_local(self, device=None) -> BCSRMatrix:
        """Gather back to one local store (on the first shard's device by
        default), on every process of a grid that spans several."""
        dev = device if device is not None else plane_devices(self.grid)[0]
        data = unshard_store_with_layout(self.data, self.shard, self.tile, dev,
                                         grid=self.grid, dtype=self.dtype)
        return BCSRMatrix(name=self.name, index=self.index, data=data, sym=self.sym,
                          dist=self.dist)


def shard_matrix(m: BCSRMatrix, dist: Distribution) -> ShardedMatrix:
    """Owner-shard a local matrix over ``dist``'s grid. On a 2.5D grid the
    owner partition lives on the (row, col) plane and the layered executors
    read the plane's shards (the JAX package replicates them over the layer
    axis)."""
    sl = shard_layout(m.index, m.tile, dist)
    return ShardedMatrix(
        name=m.name, index=m.index, tile=m.tile, dist=dist, shard=sl,
        data=shard_store_with_layout(m, sl, dist.grid), sym=m.sym, dtype=m.dtype,
    )


# ---------------------------------------------------------------------------
# owner-local remaps between two shard layouts with the same bins
# ---------------------------------------------------------------------------

def _remap_table(dst_index: BCSRIndex, dst_sl: ShardLayout, src_index: BCSRIndex,
                 src_sl: ShardLayout, tile: int) -> np.ndarray:
    """int64 [ndev, n_max_dst]: for every destination sharded position, the
    LOCAL source slot on the same rank holding that tile (-1: zero). Raises
    if a shared tile has different owners (layouts of different
    distributions)."""
    dst_keys = store_layout(dst_index, tile).tile_keys()
    src_keys = store_layout(src_index, tile).tile_keys()
    amap = tile_align_map(dst_keys, src_keys)  # dst slot -> src slot | -1
    tbl = np.full(dst_sl.ndev * dst_sl.n_max, -1, dtype=np.int64)
    pos_valid = dst_sl.slot_of_pos >= 0
    dslot = dst_sl.slot_of_pos[pos_valid]
    sslot = amap[dslot]
    hit = sslot >= 0
    if hit.any():
        dbcsr_assert(
            np.array_equal(src_sl.owner_of_slot[sslot[hit]],
                           dst_sl.owner_of_slot[dslot[hit]]),
            "shard layouts disagree on tile owners — reshard one operand "
            "onto the other's distribution first",
        )
        idx = np.flatnonzero(pos_valid)[hit]
        tbl[idx] = src_sl.local_of_slot[sslot[hit]]
    return tbl.reshape(dst_sl.ndev, dst_sl.n_max)


def _held(grid) -> List[bool]:
    """Whether this process holds each shard of ``grid``'s plane."""
    me = comm.rank()
    return [o == me for o in plane_owners(grid)]


def _local_gathers(tbl: np.ndarray, n_src: int, grid) -> List[Optional[TileGather]]:
    """One resolved tile gather per rank of a [ndev, n] table (None for a
    shard of another process)."""
    return [tile_gather(tbl[d], n_src, dev) if h else None
            for d, (dev, h) in enumerate(zip(plane_devices(grid), _held(grid)))]


def _shard_constant(store: torch.Tensor, sl: ShardLayout, grid
                    ) -> List[Optional[torch.Tensor]]:
    """A store-ordered constant ([n_tiles, ...]) laid out as shards (zero
    padding); ``store`` may sit on any device."""
    return [take_tiles(store, sl.slot_of_pos[d * sl.n_max:(d + 1) * sl.n_max],
                       store.shape[1]).to(dev) if h else None
            for d, (dev, h) in enumerate(zip(plane_devices(grid), _held(grid)))]


def _sharded_valid_mask(sm: ShardedMatrix) -> List[Optional[torch.Tensor]]:
    """Cached sharded validity mask (1 on stored-block positions)."""
    devs = plane_devices(sm.grid)
    key = ("sharded_valid_mask", sm.tile, sm.shard.token, sm.grid)
    return sm.index._cached(key, lambda: _shard_constant(
        valid_mask(sm.index, sm.tile, devs[0]), sm.shard, sm.grid))


def _check_compatible(a: ShardedMatrix, b: ShardedMatrix) -> None:
    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    dbcsr_assert(a.sym == b.sym, "sharded ops need matching symmetry")
    dbcsr_assert(a.grid == b.grid, "operands on different grids")
    dbcsr_assert(
        np.array_equal(a.index.row_block_sizes, b.index.row_block_sizes)
        and np.array_equal(a.index.col_block_sizes, b.index.col_block_sizes),
        "incompatible block structures",
    )


# ---------------------------------------------------------------------------
# multiply on sharded matrices
# ---------------------------------------------------------------------------

def _reshard(src_sl: ShardLayout, dst_sl: ShardLayout, grid, tile: int):
    """A function moving sharded stores of ONE index between two layouts
    (the matrix's at-rest owners vs the executor's k-binned ones): a
    per-rank gather from the shards it needs; the identity when the layouts
    agree."""
    same = (src_sl.token == dst_sl.token if src_sl.token and dst_sl.token else (
        src_sl.n_max == dst_sl.n_max
        and np.array_equal(src_sl.pos_of_slot, dst_sl.pos_of_slot)))
    if same:
        return lambda shards, dtype: shards
    from ..mm.cannon import ShardGather

    pos = np.full(dst_sl.ndev * dst_sl.n_max, -1, dtype=np.int64)
    valid = dst_sl.slot_of_pos >= 0
    pos[valid] = src_sl.pos_of_slot[dst_sl.slot_of_pos[valid]]
    return ShardGather(pos, dst_sl.n_max, src_sl.n_max, grid.plane(), tile)


def build_sharded_multiply(transa: str, transb: str, a: ShardedMatrix,
                           b: ShardedMatrix, *, algo: Optional[str] = None,
                           k_dist: Optional[np.ndarray] = None):
    """Plan op(A)·op(B) on sharded stores: the distributed executor (Cannon
    or SUMMA over the grid's ranks) is planned from the indices, and the
    operands are resharded from their at-rest layouts onto the executor's
    k-binned layouts on each call (the reference's ``make_images``
    alltoall, ``src/mm/dbcsr_mm_cannon.F:146``).

    Returns ``(c_index, c_shard, fn)`` with ``fn(a_shards, b_shards) ->
    c_shards``; ``fn.plan`` is the executor's ``RankPlan``."""
    from ..mm.engine import build_distributed_executor

    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    dbcsr_assert(a.sym == SYM_NONE and b.sym == SYM_NONE,
                 "desymmetrize before sharded multiply")
    tile = a.tile
    dev = plane_devices(a.grid)[0]
    # metadata stand-ins: the executor reads only the index and the tile
    a_meta = BCSRMatrix(name=a.name, index=a.index,
                        data=torch.zeros((0, tile, tile), dtype=a.dtype, device=dev))
    b_meta = BCSRMatrix(name=b.name, index=b.index,
                        data=torch.zeros((0, tile, tile), dtype=b.dtype, device=dev))
    exec_fn, c_index, eff = build_distributed_executor(
        transa, transb, a_meta, b_meta, a.dist, algo=algo, k_dist=k_dist,
        sharded=True,
    )
    grid = a.grid
    move_a = _reshard(a.shard, exec_fn.shard_a, grid, tile)
    move_b = _reshard(b.shard, exec_fn.shard_b, grid, tile)

    def fn(a_sh, b_sh):
        return exec_fn(move_a(a_sh, a.dtype), move_b(b_sh, b.dtype))

    fn.eff_flops = eff
    fn.plan = exec_fn.plan
    return c_index, exec_fn.shard_c, fn


def sharded_multiply(transa: str, transb: str, alpha, a: ShardedMatrix,
                     b: ShardedMatrix, beta=0.0,
                     c: Optional[ShardedMatrix] = None) -> ShardedMatrix:
    """``C = alpha * op(A)·op(B) [+ beta * C]`` on sharded matrices, the
    executor cached by content (patterns, distribution, layouts, dtypes,
    config), so iterative loops plan once."""
    from ..core.config import config_fingerprint
    from ..mm.plancache import dist_fingerprint, get_plan_cache

    pcache = get_plan_cache()
    key = pcache.key(
        a.index, transa.upper() != "N", b.index, transb.upper() != "N",
        extra=("sharded_multiply", transa.upper(), transb.upper(),
               dist_fingerprint(a.dist), a.shard.token, b.shard.token, a.tile,
               str(a.dtype), str(b.dtype), config_fingerprint()),
    )
    cached = pcache.get(key)
    if cached is not None:
        c_index, c_sl, fn = cached
    else:
        c_index, c_sl, fn = build_sharded_multiply(transa, transb, a, b)
        pcache.put(key, (c_index, c_sl, fn))
    out = ShardedMatrix(
        name=f"{a.name}*{b.name}", index=c_index, tile=a.tile, dist=a.dist,
        shard=c_sl, data=fn(a.data, b.data), sym=SYM_NONE,
        dtype=torch.promote_types(a.dtype, b.dtype),
    )
    if alpha != 1.0:
        out = sharded_scale(out, alpha)
    if c is not None:
        # C's index is merged even at beta == 0, as the local engine does
        out = sharded_add(1.0, out, beta, c)
    return out


# ---------------------------------------------------------------------------
# add (index union) / hadamard (index intersection)
# ---------------------------------------------------------------------------

def build_sharded_add(a: ShardedMatrix, b: ShardedMatrix
                      ) -> Tuple[BCSRIndex, ShardLayout, Callable]:
    """Plan alpha·A + beta·B on sharded stores: the index union
    (``dbcsr_add``), its shard layout on the operands' owner bins, and two
    owner-local remaps. Returns ``(c_index, c_shard, fn)`` with
    ``fn(x_sh, y_sh, alpha=1.0, beta=1.0) -> c_sh``."""
    _check_compatible(a, b)
    with timed("sharded_add_plan"):
        c_index, _, _ = merge_index(a.index, b.index)
        c_sl = shard_layout(c_index, a.tile, a.dist)
        ga = _local_gathers(_remap_table(c_index, c_sl, a.index, a.shard, a.tile),
                            a.shard.n_max, a.grid)
        gb = _local_gathers(_remap_table(c_index, c_sl, b.index, b.shard, b.tile),
                            b.shard.n_max, a.grid)
        dtype = torch.promote_types(a.dtype, b.dtype)

    def fn(x_sh, y_sh, alpha=1.0, beta=1.0):
        al, be = _coefficient(alpha, dtype), _coefficient(beta, dtype)
        return [None if g1 is None else
                al * apply_tile_gather(x, g1).to(dtype) + be * apply_tile_gather(y, g2).to(dtype)
                for x, y, g1, g2 in zip(x_sh, y_sh, ga, gb)]

    return c_index, c_sl, fn


def sharded_add(alpha, a: ShardedMatrix, beta, b: ShardedMatrix) -> ShardedMatrix:
    c_index, c_sl, fn = build_sharded_add(a, b)
    return ShardedMatrix(
        name=a.name, index=c_index, tile=a.tile, dist=a.dist, shard=c_sl,
        data=fn(a.data, b.data, alpha, beta), sym=a.sym,
        dtype=torch.promote_types(a.dtype, b.dtype),
    )


def build_sharded_hadamard(a: ShardedMatrix, b: ShardedMatrix
                           ) -> Tuple[BCSRIndex, ShardLayout, Callable]:
    """Plan the elementwise product on the pattern intersection
    (``dbcsr_hadamard_product``): a position covered in only one operand
    multiplies that operand's zero padding."""
    _check_compatible(a, b)
    with timed("sharded_hadamard_plan"):
        pm = a.index.pattern().astype(bool).multiply(
            b.index.pattern().astype(bool)).tocsr()
        pm.sort_indices()
        rows = np.repeat(np.arange(pm.shape[0], dtype=np.int32),
                         np.diff(pm.indptr).astype(np.int64))
        c_index, _ = build_index(rows, pm.indices.astype(np.int32),
                                 a.index.row_block_sizes, a.index.col_block_sizes)
        c_sl = shard_layout(c_index, a.tile, a.dist)
        ga = _local_gathers(_remap_table(c_index, c_sl, a.index, a.shard, a.tile),
                            a.shard.n_max, a.grid)
        gb = _local_gathers(_remap_table(c_index, c_sl, b.index, b.shard, b.tile),
                            b.shard.n_max, a.grid)

    def fn(x_sh, y_sh):
        return [None if g1 is None else apply_tile_gather(x, g1) * apply_tile_gather(y, g2)
                for x, y, g1, g2 in zip(x_sh, y_sh, ga, gb)]

    return c_index, c_sl, fn


def sharded_hadamard(a: ShardedMatrix, b: ShardedMatrix) -> ShardedMatrix:
    c_index, c_sl, fn = build_sharded_hadamard(a, b)
    return ShardedMatrix(
        name=a.name, index=c_index, tile=a.tile, dist=a.dist, shard=c_sl,
        data=fn(a.data, b.data), sym=a.sym, dtype=torch.promote_types(a.dtype, b.dtype),
    )


# ---------------------------------------------------------------------------
# same-pattern elementwise
# ---------------------------------------------------------------------------

def sharded_scale(sm: ShardedMatrix, alpha) -> ShardedMatrix:
    """alpha·A (``dbcsr_scale``): local arithmetic on every shard."""
    al = _coefficient(alpha, sm.dtype)
    return sm.with_data([None if x is None else x * al for x in sm.data])


def build_sharded_scale_by_vector(sm: ShardedMatrix, side: str = "right") -> Callable:
    """Plan row/column scaling (``dbcsr_scale_by_vector``): each rank's tile
    coordinates are plan constants, the full vector a call argument,
    re-tiled on every rank. Returns ``fn(x_sh, vec) -> x_sh``."""
    dbcsr_assert(side in ("left", "right"), "side must be left|right")
    sl, t = sm.shard, sm.tile
    lay = store_layout(sm.index, t)
    axis = 0 if side == "left" else 1
    n_full = sm.index.nfullrows if side == "left" else sm.index.nfullcols
    ntiles_dim = lay.ntr if side == "left" else lay.ntc
    coords = np.full(sl.ndev * sl.n_max, ntiles_dim, dtype=np.int64)  # pad row
    pos_valid = sl.slot_of_pos >= 0
    coords[pos_valid] = lay.tile_coords[sl.slot_of_pos[pos_valid], axis]
    ct = [torch.as_tensor(coords[d * sl.n_max:(d + 1) * sl.n_max], device=dev) if h else None
          for d, (dev, h) in enumerate(zip(plane_devices(sm.grid), _held(sm.grid)))]

    def fn(x_sh, vec):
        out = []
        for x, c in zip(x_sh, ct):
            if c is None:
                out.append(None)
                continue
            v = torch.as_tensor(np.asarray(vec) if not torch.is_tensor(vec) else vec)
            vt = torch.zeros(((ntiles_dim + 1) * t,), dtype=x.dtype, device=x.device)
            vt[:n_full] = v.to(device=x.device).reshape(n_full).to(x.dtype)
            per = vt.reshape(ntiles_dim + 1, t).index_select(0, c)
            out.append(x * (per[:, :, None] if side == "left" else per[:, None, :]))
        return out

    return fn


def sharded_scale_by_vector(sm: ShardedMatrix, vec, side: str = "right") -> ShardedMatrix:
    return sm.with_data(build_sharded_scale_by_vector(sm, side)(sm.data, vec))


def sharded_function_of_elements(sm: ShardedMatrix, fn) -> ShardedMatrix:
    """Elementwise function on the stored elements
    (``dbcsr_function_of_elements``): applied on every shard, the sharded
    validity mask keeps padding at zero when fn(0) != 0."""
    from ..ops.arithmetic import ELEMENT_FUNCTIONS

    if isinstance(fn, str):
        dbcsr_assert(fn in ELEMENT_FUNCTIONS, f"unknown element function {fn!r}")
        fn = ELEMENT_FUNCTIONS[fn]
    out = []
    for x, vm in zip(sm.data, _sharded_valid_mask(sm)):
        if x is None:
            out.append(None)
            continue
        y = fn(x)
        out.append(torch.where(vm > 0.5, y, torch.zeros_like(y)))
    return sm.with_data(out)


# ---------------------------------------------------------------------------
# scalar reductions: per-rank partials summed on the host in rank order
# ---------------------------------------------------------------------------

def _all_ranks(sm: ShardedMatrix, parts: list, is_complex: bool) -> list:
    """Every rank's partial in rank order, on every process (``parts``
    holds this process's, None for the others')."""
    return comm.gather_scalars(parts, plane_owners(sm.grid), is_complex)


def _assert_nonsym(sm: ShardedMatrix, what: str) -> None:
    dbcsr_assert(
        sm.sym == SYM_NONE,
        f"sharded {what} needs a desymmetrized matrix (canonical stores hold "
        "one triangle)",
    )


def sharded_trace(sm: ShardedMatrix):
    """Tr(A): each rank's partial over its diagonal tiles, summed in rank
    order (``dbcsr_trace``)."""
    sl, t = sm.shard, sm.tile
    devs = plane_devices(sm.grid)

    def mk():
        lay = store_layout(sm.index, t)
        diag = np.flatnonzero(lay.tile_coords[:, 0] == lay.tile_coords[:, 1])
        out = []
        for d, (dev, h) in enumerate(zip(devs, _held(sm.grid))):
            sel = diag[sl.owner_of_slot[diag] == d]
            out.append(torch.as_tensor(sl.local_of_slot[sel], device=dev) if h else None)
        return out

    tbl = sm.index._cached(("sharded_trace_tbl", t, sl.token, sm.grid), mk)
    parts = [None if c is None else
             _host(torch.diagonal(x.index_select(0, c), dim1=1, dim2=2).sum())
             for x, c in zip(sm.data, tbl)]
    return sum(_all_ranks(sm, parts, sm.dtype.is_complex))


def sharded_dot(a: ShardedMatrix, b: ShardedMatrix):
    """Frobenius inner product Tr(A^H B) (``dbcsr_dot``): B remapped onto
    A's layout (owner-local), per-rank sums in rank order."""
    _check_compatible(a, b)
    _assert_nonsym(a, "dot")
    gb = _local_gathers(_remap_table(a.index, a.shard, b.index, b.shard, a.tile),
                        b.shard.n_max, a.grid)
    parts = [None if g is None else _host((x.conj() * apply_tile_gather(y, g)).sum())
             for x, y, g in zip(a.data, b.data, gb)]
    return sum(_all_ranks(a, parts, torch.promote_types(a.dtype, b.dtype).is_complex))


def sharded_frobenius(sm: ShardedMatrix) -> float:
    """Frobenius norm: per-rank sums of |x|², summed in rank order, sqrt."""
    _assert_nonsym(sm, "frobenius norm")
    from ..block.tileops import squares

    parts = [None if x is None else _host(squares(x).sum()) for x in sm.data]
    return float(np.sqrt(sum(_all_ranks(sm, parts, False))))


def sharded_maxabs(sm: ShardedMatrix) -> float:
    """max |a_ij| (``dbcsr_maxabs``): per-rank maxima, then their maximum."""
    _assert_nonsym(sm, "maxabs norm")
    parts = [None if x is None else (_host(x.abs().max()) if x.numel() else 0.0)
             for x in sm.data]
    return float(max(_all_ranks(sm, parts, False)))


# ---------------------------------------------------------------------------
# sharded checkpoint I/O (the JAX package's format)
# ---------------------------------------------------------------------------

def _np_dtype_str(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return _BF16_STR
    return np.dtype(str(dtype)[6:]).str


def _shard_host(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.cpu().view(torch.int16).numpy().view(np.dtype("V2"))
    return x.cpu().numpy()


def sharded_checkpoint_write(sm: ShardedMatrix, directory: str) -> None:
    """Checkpoint a sharded matrix WITHOUT gathering it: the index metadata
    to ``index.npz``, every rank's shard to its own ``shard_<d>.npy`` (the
    JAX package's files; the reference's MPI-IO checkpoint,
    ``dbcsr_binary_write``, ``src/ops/dbcsr_io.F:576``). Each process
    writes its own shards, the holder of shard 0 the metadata, then every
    process waits for the others: on return the checkpoint is whole."""
    os.makedirs(directory, exist_ok=True)
    idx = sm.index
    held = _held(sm.grid)
    if held[0]:
        np.savez(
        os.path.join(directory, "index.npz"),
            name=sm.name,
            sym=sm.sym,
            tile=np.int64(sm.tile),
            ndev=np.int64(sm.shard.ndev),
            n_max=np.int64(sm.shard.n_max),
            dtype=_np_dtype_str(sm.dtype),
            emulated=np.int64(0),
            row_block_sizes=idx.row_block_sizes,
            col_block_sizes=idx.col_block_sizes,
            blk_rows=idx.blk_rows,
            col_idx=idx.col_idx,
            row_dist=sm.dist.row_dist,
            col_dist=sm.dist.col_dist,
        )
    for d, x in enumerate(sm.data):
        if held[d]:
            np.save(os.path.join(directory, f"shard_{d}.npy"), _shard_host(x))
    comm.barrier()


def sharded_checkpoint_read(directory: str, grid) -> ShardedMatrix:
    """Restore a sharded matrix written by :func:`sharded_checkpoint_write`
    (by either package) onto ``grid``'s ranks (same plane shape), each
    shard loaded straight to its rank's device by the process that holds
    it."""
    z = np.load(os.path.join(directory, "index.npz"))
    tile = int(z["tile"])
    dbcsr_assert(not int(z["emulated"]) if "emulated" in z else True,
                 "split-complex checkpoints are written only by the JAX package "
                 "on a device without complex support")
    index, _ = build_index(z["blk_rows"], z["col_idx"], z["row_block_sizes"],
                           z["col_block_sizes"])
    dist = Distribution(grid=grid, row_dist=z["row_dist"], col_dist=z["col_dist"])
    sl = shard_layout(index, tile, dist)
    dbcsr_assert(sl.ndev == int(z["ndev"]) and sl.n_max == int(z["n_max"]),
                 "checkpoint grid shape does not match the target grid")
    dstr = str(z["dtype"])
    data = []
    for d, (dev, h) in enumerate(zip(plane_devices(grid), _held(grid))):
        if not h:
            data.append(None)
            continue
        arr = np.load(os.path.join(directory, f"shard_{d}.npy"))
        if dstr == _BF16_STR or arr.dtype.itemsize == 2 and arr.dtype.kind == "V":
            x = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
                torch.bfloat16)
        else:
            x = torch.from_numpy(np.ascontiguousarray(arr.astype(np.dtype(dstr))))
        data.append(x.to(dev))
    dtype = torch.bfloat16 if dstr == _BF16_STR else getattr(torch, np.dtype(dstr).name)
    return ShardedMatrix(name=str(z["name"]), index=index, tile=tile, dist=dist,
                         shard=sl, data=data, sym=str(z["sym"]), dtype=dtype)


# ---------------------------------------------------------------------------
# pattern-changing: per-block norms → filter
# ---------------------------------------------------------------------------

def sharded_block_norms(sm: ShardedMatrix) -> np.ndarray:
    """Per-block Frobenius norm² (float32) from the sharded store: each
    rank's per-tile (segment-row, segment-col) partials by
    ``tile_block_sumsq`` (``block/tileops.py``) on its own shard, the
    combine of blocks spanning tiles on the host in rank order
    (``block_sums_sq``'s sharded twin); on a grid that spans processes every
    rank's partials reach every process first."""
    if sm.index.nblks == 0:
        return np.zeros(0, dtype=np.float32)
    sl, t = sm.shard, sm.tile
    devs = plane_devices(sm.grid)
    info = tile_block_info(sm.index, t)

    def mk():
        out = []
        for d, (dev, h) in enumerate(zip(devs, _held(sm.grid))):
            pos = sl.slot_of_pos[d * sl.n_max:(d + 1) * sl.n_max]
            dinfo = slots_block_info(sm.index, t, pos, dev) if h else None
            bid = np.where(pos[:, None, None] >= 0, info.bid[np.maximum(pos, 0)], -1)
            out.append((dinfo, bid))
        return out

    tables = sm.index._cached(("sharded_block_norm_tables", t, sl.token, sm.grid), mk)
    parts = [None if x is None else tile_block_sumsq(x.contiguous(), dinfo)
             for x, (dinfo, _) in zip(sm.data, tables)]
    parts = comm.all_gather_panels(plane_owners(sm.grid), parts,
                                   [bid.shape for _, bid in tables], torch.float32)
    out = np.zeros(sm.index.nblks + 1, dtype=np.float64)
    for z, (_, bid) in zip(parts, tables):
        np.add.at(out, bid.reshape(-1) + 1, z.cpu().numpy().reshape(-1))
    return out[1:].astype(np.float32)


def sharded_filter(sm: ShardedMatrix, eps: Optional[float]) -> ShardedMatrix:
    """Drop blocks with Frobenius norm < eps (``dbcsr_filter``): norms from
    the shards, the survivor index on the host, an owner-local regather and
    the survivors' mask; the data never leaves its owners."""
    if sm.nblks == 0 or eps is None:
        return sm
    with timed("sharded_filter"):
        nsq = sharded_block_norms(sm).astype(np.float64)
        keep = nsq >= float(eps) ** 2
        if keep.all():
            return sm
        new_index, _ = build_index(
            sm.index.blk_rows[keep], sm.index.col_idx[keep],
            sm.index.row_block_sizes, sm.index.col_block_sizes,
        )
        new_sl = shard_layout(new_index, sm.tile, sm.dist)
        g = _local_gathers(_remap_table(new_index, new_sl, sm.index, sm.shard, sm.tile),
                           sm.shard.n_max, sm.grid)
        out = ShardedMatrix(name=sm.name, index=new_index, tile=sm.tile, dist=sm.dist,
                            shard=new_sl, data=sm.data, sym=sm.sym, dtype=sm.dtype)
        vm = _sharded_valid_mask(out)
        return out.with_data([None if gi is None else apply_tile_gather(x, gi) * m.to(x.dtype)
                              for x, gi, m in zip(sm.data, g, vm)])
