"""Sharded at-rest storage: tile data partitioned across the grid's ranks.

Port of ``dbcsr_tpu/dist/sharded.py``. The local tile store
(``block/store.py``) holds a whole matrix on one device; the sharded form
reorders tiles by OWNER rank (the distribution's tile bins on the grid's
(row, col) plane) and pads every rank to the common count ``n_max``. The
JAX package keeps it as one ``[n_devices, n_max, T, T]`` array sharded
over the mesh; here it is a list of ``n_devices`` tensors ``[n_max, T,
T]``, rank ``i * npcol + j``'s on the device of rank (i, j, 0) (on a 2.5D
grid the layers read the plane's shards). On a grid that spans processes
each process materializes only its own ranks' shards (the JAX package's
``put_global``): the others' entries are None, absent rather than zero.
``ShardLayout``'s maps are the JAX package's, computed by the same numpy
code.

Per-rank tile lists are sorted by global (row-major) tile key, exactly the
per-rank C ordering the distributed executors produce, so an executor's
sharded output IS the at-rest sharded form of its C matrix. The block
index stays host metadata (small); only tile data shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..block.index import BCSRIndex
from ..block.store import store_layout
from ..block.tileops import TileGather, apply_tile_gather, tile_gather
from ..core.errors import dbcsr_assert
from ..core.timing import timed
from . import comm
from .distribution import Distribution, dist_tile_bins

__all__ = [
    "ShardLayout",
    "shard_layout",
    "shard_layout_from_bins",
    "shard_store",
    "shard_store_with_layout",
    "unshard_store",
    "unshard_store_with_layout",
    "plane_devices",
    "plane_owners",
]


@dataclass(frozen=True)
class ShardLayout:
    """Owner partition of one matrix's tile set over a (p, q) grid."""

    p: int
    q: int
    n_max: int  # padded tiles per device
    owner_of_slot: np.ndarray  # int32 [n_tiles] -> device (i*q+j)
    local_of_slot: np.ndarray  # int64 [n_tiles] -> local slot at its owner
    #: sharded position of every global slot: dev * n_max + local
    pos_of_slot: np.ndarray  # int64 [n_tiles]
    #: inverse: global slot per sharded position (-1 padding)
    slot_of_pos: np.ndarray  # int64 [p*q*n_max]
    #: O(1) fingerprint for cache keys / layout-equality checks (hash of
    #: the construction inputs — no per-call hashing of the big maps)
    token: str = ""

    @property
    def ndev(self) -> int:
        return self.p * self.q


def shard_layout_from_bins(
    index: BCSRIndex, tile: int, rowb: np.ndarray, colb: np.ndarray,
    p: int, q: int,
) -> ShardLayout:
    """Cached owner partition of ``index``'s tiles: tile (tr, tc) belongs to
    device ``rowb[tr] * q + colb[tc]`` (tiles sorted by global key within
    each owner). The bins are per-TILE maps — each matrix shards along its
    OWN dimensions (A (m,k): (row-bins, k-bins); B (k,n): (k-bins,
    col-bins); C (m,n): (row-bins, col-bins))."""
    key = (
        "shard_layout", tile, p, q,
        rowb.tobytes(), colb.tobytes(),
    )

    def mk():
        import hashlib

        token = hashlib.sha1(
            repr((tile, p, q, id(index))).encode()
            + rowb.tobytes() + colb.tobytes()
        ).hexdigest()[:16]
        lay = store_layout(index, tile)
        coords = lay.tile_coords
        owner = (rowb[coords[:, 0]] * q + colb[coords[:, 1]]).astype(np.int32)
        counts = np.bincount(owner, minlength=p * q)
        n_max = max(int(counts.max(initial=0)), 1)
        local = np.zeros(lay.n_tiles, dtype=np.int64)
        pos_in_dev = np.zeros(p * q, dtype=np.int64)
        for s in range(lay.n_tiles):  # global order = sorted keys per owner
            d = int(owner[s])
            local[s] = pos_in_dev[d]
            pos_in_dev[d] += 1
        pos = owner.astype(np.int64) * n_max + local
        inv = np.full(p * q * n_max, -1, dtype=np.int64)
        inv[pos] = np.arange(lay.n_tiles)
        return ShardLayout(
            p=p, q=q, n_max=n_max, owner_of_slot=owner,
            local_of_slot=local, pos_of_slot=pos, slot_of_pos=inv,
            token=token,
        )

    return index._cached(key, mk)


def shard_layout(
    index: BCSRIndex, tile: int, dist: Distribution
) -> ShardLayout:
    """Owner partition for a matrix whose dims match ``dist``'s (row, col)
    maps (e.g. C, or a square matrix)."""
    rowb = dist_tile_bins(
        dist.row_dist, index.row_block_sizes, tile, majority=True
    )
    colb = dist_tile_bins(
        dist.col_dist, index.col_block_sizes, tile, majority=True
    )
    return shard_layout_from_bins(
        index, tile, rowb, colb, dist.grid.nprow, dist.grid.npcol
    )


def plane_devices(grid) -> List[torch.device]:
    """The device of each shard: rank (i, j, 0) for shard ``i * npcol + j``."""
    return [grid.device(i, j, 0) for i in range(grid.nprow) for j in range(grid.npcol)]


def plane_owners(grid) -> List[int]:
    """The process of each shard: that of rank (i, j, 0)."""
    return [grid.owner(i, j, 0) for i in range(grid.nprow) for j in range(grid.npcol)]


def shard_store_with_layout(m, sl: ShardLayout, grid) -> List[Optional[torch.Tensor]]:
    """Local store -> the owner shards (one ``[n_max, T, T]`` tensor per
    rank of ``grid``'s plane, zero padded), each on its rank's device; a
    shard of another process is None. The cut is the span
    ``sharded/cut``; its gathers are resolved once per (matrix index,
    layout, store device), so cutting new data over one pattern is device
    work alone."""
    t = m.tile
    me = comm.rank()
    out = []
    with timed("sharded/cut"):
        for d, (dev, o) in enumerate(zip(plane_devices(grid), plane_owners(grid))):
            if o != me:
                out.append(None)
            elif m.data.shape[0] == 0:
                out.append(m.data.new_zeros((sl.n_max, t, t), device=dev))
            else:
                g = _cut_gather(m.index, sl, d, m.data.shape[0], m.data.device)
                out.append(apply_tile_gather(m.data, g).to(dev))
    return out


def _cut_gather(index: BCSRIndex, sl: ShardLayout, d: int, n_store: int, device
                ) -> TileGather:
    """Shard ``d``'s tile gather out of a store of ``index``, cached on it."""
    def mk():
        return tile_gather(sl.slot_of_pos[d * sl.n_max:(d + 1) * sl.n_max], n_store, device)

    return index._cached(("shard_cut", sl.token, sl.n_max, len(sl.owner_of_slot), d,
                          n_store, str(device)), mk)


def shard_store(m, dist: Distribution) -> List[torch.Tensor]:
    return shard_store_with_layout(m, shard_layout(m.index, m.tile, dist), dist.grid)


def unshard_store_with_layout(shards: List[Optional[torch.Tensor]], sl: ShardLayout,
                              tile: int, device=None, *, grid=None,
                              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Owner shards -> the local store ``[n_tiles, T, T]`` on ``device``
    (default: the first shard's), one copy per shard. With ``grid`` the
    shards of other processes (None here) arrive as one message each of
    the tiles the store takes, and every process gets the whole store; a
    process that holds no shard names ``device`` and ``dtype``."""
    held = [x for x in shards if x is not None]
    dbcsr_assert(
        len(shards) == sl.ndev and all(x.shape[0] == sl.n_max for x in held),
        "shard layout mismatch",
    )
    dbcsr_assert(grid is not None or len(held) == len(shards),
                 "shards of other processes need the grid")
    dev = held[0].device if device is None else torch.device(device)
    dtype = dtype or held[0].dtype
    n = len(sl.owner_of_slot)
    slots = [np.flatnonzero(sl.owner_of_slot == d) for d in range(sl.ndev)]
    keep = [d for d in range(sl.ndev) if len(slots[d])]
    pieces = [None if shards[d] is None else shards[d].index_select(
        0, torch.as_tensor(sl.local_of_slot[slots[d]], device=shards[d].device))
        for d in keep]
    if grid is not None:
        owners = plane_owners(grid)
        pieces = comm.all_gather_panels([owners[d] for d in keep], pieces,
                                        [(len(slots[d]), tile, tile) for d in keep], dtype)
    out = torch.empty((n, tile, tile), dtype=dtype, device=dev)
    for d, x in zip(keep, pieces):
        out.index_copy_(0, torch.as_tensor(slots[d], device=dev), x.to(dev))
    return out


def unshard_store(shards: List[Optional[torch.Tensor]], index: BCSRIndex, tile: int,
                  dist: Distribution, device=None) -> torch.Tensor:
    return unshard_store_with_layout(shards, shard_layout(index, tile, dist), tile,
                                     device, grid=dist.grid)
