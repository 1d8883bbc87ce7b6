"""Cannon distributed multiply over a 2-D (or 2.5-D) grid of virtual ranks.

Port of ``dbcsr_tpu/mm/cannon.py`` (reference ``multiply_cannon``,
``src/mm/dbcsr_mm_cannon.F:839-1772``). The host plans are the JAX
package's, copied unchanged (numpy): the element-granular ``plan_cannon``
for arbitrary block distributions and the tile-granular
``plan_cannon_tiled`` (with ``_tile_layer_split``) for tile-aligned ones.
Their stacks are ``[P, P, L, P(ticks), s_max, 3]`` with padding rows aimed
at the trash C slot ``n_c``.

One planner, ``plan_distributed``, decides how op(A)·op(B) runs over a
grid, Cannon or SUMMA (``summa.py``): the op block sizes, the default
``k_dist``, the tile bins, the host plan and the K masks, as one
``DistPlan``. Both entry points take it: the one-shot ``multiply(dist=)``
through ``execute_distributed`` (its resident plan cached by content) and
``engine.build_distributed_executor``.

Execution. The JAX package runs the ticks as a ``lax.fori_loop`` inside
``jax.shard_map``, each tick body an XLA gather + ``dot_general`` +
``segment_sum`` with ``lax.ppermute`` ring shifts. Here the ranks are the
cells of the port's ``ProcessGrid`` (``dist/grid.py``) and the tick loop is
a Python loop over P ticks:

- each rank's tick is ONE launch of the port's stack kernel for the dtype
  (K1 ``tile_stack_matmul`` for float32/bfloat16, the float64 kernel
  ``tile_stack_matmul_f64``, KC1/KC2 ``tile_stack_matmul_c`` for complex;
  their plain versions on CPU tensors). The plan's stacks become
  ``DeviceStack``s once per plan: the trash rows are dropped, each tick's
  C slots are renumbered among those it touches (C-sorted, as the kernels
  require) and an empty tick launches nothing. A float64 tiled Cannon
  plan at T = 64 or 128 gives each (rank, tick) stack the K occupancy
  masks of the pieces the rank holds at that tick (``cannon_piece_masks``;
  ``f64_stack.py``), so the kernel issues only the mma depths both tiles
  of an entry fill, as the one-card executor does;
- a tick's partial is added into the rank's C panel in tick order
  (deterministic: each slot once a tick). A tick that touches at least
  half the panel's slots launches over the whole panel (the kernel writes
  a zero tile where it adds nothing) and adds in place, the rank's first
  such partial being the panel itself; a sparser tick launches over the
  slots it touches and adds on those only (gather, add, scatter);
- after each tick A shifts left along 'pc' and B up along 'pr': between
  ranks on one device the tensor is handed over, between devices it is a
  peer copy, between processes one message (``dist/comm.py``); panels are
  read-only inside the loop, C is per rank. Each tick's launches are the
  span ``cannon/ticks``, each shift the span ``cannon/shift``
  (``core/timing.py``; under a profiler the shift's device time runs to
  its completion, since the stream waits for the transfer);
- with ``nlayer > 1`` the layer partials are summed in layer order
  (the 2.5D C-reduction, ``src/mm/dbcsr_mm_3d.F``).

On a grid that spans processes (``init_lib(distributed=True)``) every
process holds the whole operands (as every process of the JAX battery
builds the same ones), builds the same plan, packs and runs its own ranks
only, and takes part in every transfer in one order; the unpack gathers
every process's C panels, so each process gets the whole C store, bitwise
the single-process result: a transfer moves bytes and adds nothing.

Panels are pre-shifted at pack time (the reference's ``make_images``,
``dbcsr_mm_cannon.F:146-751``) and padded to the largest panel's tile
count ``n_a``/``n_b``, so the packed panels can hold more than one copy of
A and B. The message statistics (``RankPlan.record_comm``) are the JAX
package's, computed from the panel shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..block.bcsr import BCSRMatrix
from ..block.index import BCSRIndex
from ..block.store import store_layout
from ..block.tileops import apply_tile_gather, tile_gather
from ..core.errors import dbcsr_assert
from ..core.stats import get_stats
from ..core.timing import timed
from ..dist import comm
from ..dist.comm import move
from ..dist.distribution import Distribution, LocalMap, local_map
from ..dist.grid import ProcessGrid
from .c_stack import tile_stack_matmul_c
from .f64_stack import (
    CHUNKED_TILES,
    depth_flops,
    entry_depths,
    f64_device_stack,
    operand_chunk_masks,
    tile_stack_matmul_f64,
)
from .kernels import DeviceStack, accumulator_dtype, device_stack, tile_stack_matmul
from .tileplan import enumerate_tile_triples

__all__ = [
    "CannonPlan", "TiledCannonPlan", "plan_cannon", "plan_cannon_tiled",
    "DistPlan", "plan_distributed", "execute_distributed", "RankPlan", "DistExec",
    "dist_exec", "rank_kernel", "cannon_piece_masks",
]


def _op_elem_panels(
    index: BCSRIndex,
    trans: bool,
    row_bins: np.ndarray,  # op-row block -> bin
    col_bins: np.ndarray,  # op-col block -> bin
    row_locals: List[LocalMap],
    col_locals: List[LocalMap],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-element (panel_row_bin, panel_col_bin, local_r, local_c) in op
    space, vectorized over the flat data buffer."""
    b = index.elem_to_blk.astype(np.int64)
    t = np.arange(index.nelems, dtype=np.int64) - index.blk_offset[b]
    bn = index.col_block_sizes[index.col_idx].astype(np.int64)[b]
    r_in = t // bn
    c_in = t - r_in * bn
    r_blk = index.blk_rows[b]
    c_blk = index.col_idx[b]
    if trans:
        r_blk, c_blk = c_blk, r_blk
        r_in, c_in = c_in, r_in
    pi = row_bins[r_blk]
    pk = col_bins[c_blk]
    # local element coords within (pi, pk) panel
    row_off = np.stack([m.elem_offset for m in row_locals])  # [P, nblk]
    col_off = np.stack([m.elem_offset for m in col_locals])
    lr = row_off[pi, r_blk] + r_in
    lc = col_off[pk, c_blk] + c_in
    return pi.astype(np.int64), pk.astype(np.int64), lr, lc


@dataclass
class CannonPlan:
    p: int
    layers: int
    tile: int
    n_a: int  # padded tiles per A panel
    n_b: int
    n_c: int
    s_max: int
    a_dest: np.ndarray  # int64 [a nelems] into the [P,P,n_a,T,T] store
    b_dest: np.ndarray
    stacks: np.ndarray  # int32 [P, P, P(ticks), s_max, 3]
    c_src: np.ndarray  # int64 [c nelems] into the [P,P,n_c,T,T] result
    eff_flops: float


def _panelize(
    index: BCSRIndex,
    trans: bool,
    row_bins,
    col_bins,
    row_locals,
    col_locals,
    tile: int,
    nbr: int,
    nbc: int,
):
    """Tile structure of every (row_bin, col_bin) panel.

    Returns (tile patterns dict[(pi,pk)] -> csr with slot+1 values,
    per-panel tile counts, element (panel ids, tile slot, within-tile pos)).
    """
    pi, pk, lr, lc = _op_elem_panels(
        index, trans, row_bins, col_bins, row_locals, col_locals
    )
    ntc = np.array(
        [-(-m.nelems // tile) if m.nelems else 1 for m in col_locals],
        dtype=np.int64,
    )
    ntr = np.array(
        [-(-m.nelems // tile) if m.nelems else 1 for m in row_locals],
        dtype=np.int64,
    )
    tr = lr // tile
    tc = lc // tile
    tid = tr * ntc[pk] + tc  # tile id within panel
    panel_key = pi * nbc + pk  # panel id in [0, nbr*nbc)
    # unique tiles per panel: combine panel and tile id into one key
    max_tid = int((ntr.max() * ntc.max())) if len(tid) else 1
    combo = panel_key * max(max_tid, 1) + tid
    uniq, inverse = np.unique(combo, return_inverse=True)
    # slot of each unique tile within its panel
    u_panel = uniq // max(max_tid, 1)
    u_tid = uniq % max(max_tid, 1)
    # slots: rank within panel (uniq is sorted, so ranks are consecutive)
    panel_starts = np.searchsorted(u_panel, np.arange(nbr * nbc))
    slot_of_uniq = np.arange(len(uniq)) - panel_starts[u_panel]
    elem_slot = slot_of_uniq[inverse]
    panel_counts = np.bincount(u_panel, minlength=nbr * nbc)
    # tile patterns per panel (csr over local tile grid, values slot+1)
    patterns = {}
    for ppi in range(nbr):
        for ppk in range(nbc):
            pid = ppi * nbc + ppk
            sel = slice(panel_starts[pid], panel_starts[pid] + panel_counts[pid])
            tids = u_tid[sel]
            patterns[(ppi, ppk)] = sp.csr_matrix(
                (
                    np.arange(1, len(tids) + 1, dtype=np.int64),
                    (tids // ntc[ppk], tids % ntc[ppk]),
                ),
                shape=(int(ntr[ppi]), int(ntc[ppk])),
            )
    within = (lr - tr * tile) * tile + (lc - tc * tile)
    return patterns, panel_counts, (pi, pk, elem_slot, within)


def plan_cannon(
    a_index: BCSRIndex,
    ta: bool,
    b_index: BCSRIndex,
    tb: bool,
    c_index: BCSRIndex,
    dist: Distribution,
    k_dist: np.ndarray,
    tile: int,
) -> CannonPlan:
    """Host-side planning of the whole Cannon schedule."""
    grid = dist.grid
    p = grid.nprow
    layers = grid.nlayer
    assert grid.npcol == p, "round-1 Cannon requires a square grid"

    m_sizes = c_index.row_block_sizes
    n_sizes = c_index.col_block_sizes
    k_sizes = a_index.row_block_sizes if ta else a_index.col_block_sizes

    m_locals = dist.row_local_maps(m_sizes)
    n_locals = dist.col_local_maps(n_sizes)

    # 2.5D: each k bin is split round-robin across layers; combined bin id
    # kl = kbin * layers + layer (the reference's make_layers_3D_C_reduction,
    # src/mm/dbcsr_mm_3d.F:1038)
    if layers > 1:
        rank_in_bin = np.zeros(len(k_dist), dtype=np.int64)
        for kb in range(p):
            sel = np.flatnonzero(k_dist == kb)
            rank_in_bin[sel] = np.arange(len(sel))
        kl_dist = (k_dist.astype(np.int64) * layers + rank_in_bin % layers)
    else:
        kl_dist = k_dist.astype(np.int64)
    k_locals = local_map(kl_dist, k_sizes, p * layers)

    # --- A panels: rows binned by C's row dist, cols by (k, layer) -------
    a_pat, a_counts, (a_pi, a_pkl, a_slot, a_within) = _panelize(
        a_index, ta, dist.row_dist, kl_dist, m_locals, k_locals,
        tile, p, p * layers,
    )
    # --- B panels: rows binned by (k, layer), cols by C's col dist -------
    b_pat, b_counts, (b_pkl, b_pj, b_slot, b_within) = _panelize(
        b_index, tb, kl_dist, dist.col_dist, k_locals, n_locals,
        tile, p * layers, p,
    )

    n_a = max(int(a_counts.max()), 1)
    n_b = max(int(b_counts.max()), 1)

    # destinations: A panel (i, kbin, l) pre-shifted to device
    # (i, (kbin-i) mod p, l); B panel (kbin, l, j) to ((kbin-j) mod p, j, l)
    a_kbin = a_pkl // layers
    a_lay = a_pkl % layers
    a_dev_col = (a_kbin - a_pi) % p
    a_dest = (
        (((a_pi * p + a_dev_col) * layers + a_lay) * n_a + a_slot)
        * (tile * tile)
        + a_within
    )
    b_kbin = b_pkl // layers
    b_lay = b_pkl % layers
    b_dev_row = (b_kbin - b_pj) % p
    b_dest = (
        (((b_dev_row * p + b_pj) * layers + b_lay) * n_b + b_slot)
        * (tile * tile)
        + b_within
    )

    # --- stacks per (device, tick) + C tile sets per device --------------
    triples = {}  # (i,j,l) -> list over t of (c_trow, c_tcol, a_slot, b_slot)
    for i in range(p):
        for j in range(p):
            for l in range(layers):
                per_tick = []
                for t in range(p):
                    k = (i + j + t) % p
                    kl = k * layers + l
                    cr, cc, asl, bsl = enumerate_tile_triples(
                        a_pat[(i, kl)], b_pat[(kl, j)]
                    )
                    per_tick.append((cr, cc, asl, bsl))
                triples[(i, j, l)] = per_tick

    # C tile set per device: union of product tiles and old-C block tiles
    n_tc = np.array(
        [-(-m.nelems // tile) if m.nelems else 1 for m in n_locals],
        dtype=np.int64,
    )
    c_pi, c_pj, c_lr, c_lc = _op_elem_panels(
        c_index, False, dist.row_dist, dist.col_dist, m_locals, n_locals
    )
    c_tr = c_lr // tile
    c_tc = c_lc // tile
    # all layers of one (i,j) share the C tile set (partials are psum'd)
    c_keysets = {}
    for i in range(p):
        for j in range(p):
            prod_keys = [
                cr * n_tc[j] + cc
                for l in range(layers)
                for (cr, cc, _, _) in triples[(i, j, l)]
            ]
            sel = (c_pi == i) & (c_pj == j)
            own_keys = c_tr[sel] * n_tc[j] + c_tc[sel]
            allk = np.concatenate(prod_keys + [own_keys]) if prod_keys else own_keys
            c_keysets[(i, j)] = np.unique(allk)
    n_c = max(max((len(v) for v in c_keysets.values()), default=1), 1)

    s_max = max(
        max(
            (len(cr) for per in triples.values() for (cr, _, _, _) in per),
            default=1,
        ),
        1,
    )
    stacks = np.zeros((p, p, layers, p, s_max, 3), dtype=np.int32)
    stacks[..., 0] = n_c  # trash slot default
    for (i, j, l), per_tick in triples.items():
        keys = c_keysets[(i, j)]
        for t, (cr, cc, asl, bsl) in enumerate(per_tick):
            s = len(cr)
            if s == 0:
                continue
            ck = cr * n_tc[j] + cc
            cslot = np.searchsorted(keys, ck)
            order = np.argsort(cslot, kind="stable")
            stacks[i, j, l, t, :s, 0] = cslot[order]
            stacks[i, j, l, t, :s, 1] = asl[order]
            stacks[i, j, l, t, :s, 2] = bsl[order]

    # --- result gather map ------------------------------------------------
    slot_all = np.empty(c_index.nelems, dtype=np.int64)
    for i in range(p):
        for j in range(p):
            sel = (c_pi == i) & (c_pj == j)
            keys = c_keysets[(i, j)]
            ck = c_tr[sel] * n_tc[j] + c_tc[sel]
            slot_all[sel] = np.searchsorted(keys, ck)
    c_within = (c_lr - c_tr * tile) * tile + (c_lc - c_tc * tile)
    c_src = (
        ((c_pi * p + c_pj) * n_c + slot_all) * (tile * tile) + c_within
    )

    return CannonPlan(
        p=p,
        layers=layers,
        tile=tile,
        n_a=n_a,
        n_b=n_b,
        n_c=n_c,
        s_max=s_max,
        a_dest=a_dest,
        b_dest=b_dest,
        stacks=stacks,
        c_src=c_src,
        eff_flops=0.0,
    )


def _inverse_map_values(
    dest: np.ndarray, values: np.ndarray, total: int
) -> np.ndarray:
    """Gather map: inv[dest[i]] = values[i], holes = OOB (gathers 0)."""
    inv = np.full(total, np.iinfo(np.int32).max, dtype=np.int64)
    inv[dest] = values
    return inv


@dataclass
class TiledCannonPlan:
    """Cannon plan at GLOBAL-TILE granularity (the fast path).

    Requires tile-aligned distributions (every tile-row/col of the global
    tile grids owned by one grid row/col — ``dist.tile_aligned_dist``):
    then every panel tile IS a tile of the at-rest store, packing is a
    tile-level gather, and the result lands back in C's store by another.
    """

    p: int
    layers: int
    n_a: int
    n_b: int
    n_c: int
    s_max: int
    a_pack: np.ndarray  # int32 [P*P*L*n_a] op-store slot per panel slot (-1 pad)
    b_pack: np.ndarray
    stacks: np.ndarray  # int32 [P, P, L, P, s_max, 3]
    c_unpack: np.ndarray  # int32 [c n_tiles] slot into [P*P*n_c] tile array


def _tile_layer_split(kb: np.ndarray, layers: int) -> np.ndarray:
    """2.5D layer of each k tile: rank within its k-bin modulo layers (the
    tile-granular form of make_layers_3D_C_reduction,
    src/mm/dbcsr_mm_3d.F:1038)."""
    if layers == 1:
        return np.zeros(len(kb), dtype=np.int64)
    lay = np.zeros(len(kb), dtype=np.int64)
    for b in np.unique(kb):
        sel = np.flatnonzero(kb == b)
        lay[sel] = np.arange(len(sel)) % layers
    return lay


def plan_cannon_tiled(
    a_coords: np.ndarray,  # op(A) tile coords, row-major = op-store slots
    b_coords: np.ndarray,
    c_layout,
    rowb: np.ndarray,  # m tile-row -> prow
    colb: np.ndarray,  # n tile-col -> pcol
    kb: np.ndarray,  # k tile -> k bin
    p: int,
    layers: int,
) -> Optional[TiledCannonPlan]:
    """Build the tile-granular Cannon schedule, or None if any tile maps
    outside the grid.

    Fully vectorized single pass: panels, pack maps, per-device C sets and
    the per-(device, layer, tick) stacks all come from one global triple
    enumeration + numpy grouping — no Python loop over tiles, panels or
    grid cells (the O(P²) per-panel scipy loop flagged in round 1)."""
    klay = _tile_layer_split(kb, layers)
    kl = kb * layers + klay  # combined (bin, layer) id per k tile
    nkl = p * layers
    mt, ktl, ntc_n = int(len(rowb)), int(len(kb)), int(len(colb))

    # --- panels: panel id + slot-within-panel per tile -------------------
    # (stable sort keeps each panel's tiles in row-major store order, the
    # panel slot order the executor's pack maps rely on)
    def panelize(coords, rk, ck, npan_c):
        pid = (
            rk[coords[:, 0]].astype(np.int64) * npan_c
            + ck[coords[:, 1]].astype(np.int64)
        )
        order = np.argsort(pid, kind="stable")
        counts = np.bincount(pid, minlength=p * npan_c if npan_c else 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(len(pid), dtype=np.int64)
        slot[order] = np.arange(len(pid), dtype=np.int64) - starts[pid[order]]
        return pid, slot, counts

    a_pid, a_slot, a_counts = panelize(a_coords, rowb, kl, nkl)
    b_pid, b_slot, b_counts = panelize(b_coords, kl, colb, p)
    n_a = max(int(a_counts.max()) if a_counts.size else 0, 1)
    n_b = max(int(b_counts.max()) if b_counts.size else 0, 1)

    # pack maps: pre-shifted destinations (make_images 'L'/'R'
    # predistribution, dbcsr_mm_cannon.F:146-751)
    a_pi, a_kli = a_pid // nkl, a_pid % nkl
    a_kbin, a_lay = a_kli // layers, a_kli % layers
    a_devcol = (a_kbin - a_pi) % p
    a_pack = np.full(p * p * layers * n_a, -1, dtype=np.int64)
    a_pack[((a_pi * p + a_devcol) * layers + a_lay) * n_a + a_slot] = (
        np.arange(len(a_coords), dtype=np.int64)
    )
    b_kli, b_pj = b_pid // p, b_pid % p
    b_kbin, b_lay = b_kli // layers, b_kli % layers
    b_devrow = (b_kbin - b_pj) % p
    b_pack = np.full(p * p * layers * n_b, -1, dtype=np.int64)
    b_pack[((b_devrow * p + b_pj) * layers + b_lay) * n_b + b_slot] = (
        np.arange(len(b_coords), dtype=np.int64)
    )

    # --- per-device C tile sets ------------------------------------------
    c_coords = c_layout.tile_coords
    c_dev = (
        rowb[c_coords[:, 0]].astype(np.int64) * p
        + colb[c_coords[:, 1]].astype(np.int64)
    )
    c_counts = np.bincount(c_dev, minlength=p * p)
    n_c = max(int(c_counts.max()) if len(c_coords) else 0, 1)
    c_starts = np.concatenate([[0], np.cumsum(c_counts)[:-1]])
    order_c = np.argsort(c_dev, kind="stable")
    pos = np.empty(len(c_dev), dtype=np.int64)
    pos[order_c] = np.arange(len(c_dev), dtype=np.int64) - c_starts[c_dev[order_c]]
    c_unpack = c_dev * n_c + pos
    # per-device key lists, concatenated sorted-by-(dev, key): tile_coords
    # are globally row-major sorted so keys ascend within each device
    c_keys = (
        c_coords[:, 0].astype(np.int64) * c_layout.ntc
        + c_coords[:, 1].astype(np.int64)
    )
    keyspace = int(c_layout.ntr) * int(c_layout.ntc) + 1
    c_devkey = c_dev[order_c] * keyspace + c_keys[order_c]

    # --- stacks: one global triple enumeration, grouped ------------------
    amat = sp.csr_matrix(
        (
            np.arange(1, len(a_coords) + 1, dtype=np.int64),
            (a_coords[:, 0].astype(np.int64), a_coords[:, 1].astype(np.int64)),
        ),
        shape=(mt, ktl),
    )
    bmat = sp.csr_matrix(
        (
            np.arange(1, len(b_coords) + 1, dtype=np.int64),
            (b_coords[:, 0].astype(np.int64), b_coords[:, 1].astype(np.int64)),
        ),
        shape=(ktl, ntc_n),
    )
    cr, cc, asl_g, bsl_g = enumerate_tile_triples(amat, bmat)

    n_groups = p * p * layers * p
    if len(cr) == 0:
        stacks = np.zeros((p, p, layers, p, 1, 3), dtype=np.int32)
        stacks[..., 0] = n_c
        return TiledCannonPlan(
            p=p, layers=layers, n_a=n_a, n_b=n_b, n_c=n_c, s_max=1,
            a_pack=a_pack, b_pack=b_pack, stacks=stacks, c_unpack=c_unpack,
        )

    i_t = rowb[cr].astype(np.int64)
    j_t = colb[cc].astype(np.int64)
    kli_t = kl[a_coords[asl_g, 1]].astype(np.int64)
    kbin_t, l_t = kli_t // layers, kli_t % layers
    t_t = (kbin_t - i_t - j_t) % p  # tick when this k bin visits (i, j)
    dev_t = i_t * p + j_t
    dk = dev_t * keyspace + cr.astype(np.int64) * c_layout.ntc + cc
    ppos = np.searchsorted(c_devkey, dk)
    ok = (ppos < len(c_devkey)) & (
        c_devkey[np.minimum(ppos, max(len(c_devkey) - 1, 0))] == dk
    )
    cslot = np.where(ok, ppos - c_starts[dev_t], n_c)  # absent C -> trash
    group = (dev_t * layers + l_t) * p + t_t
    gcounts = np.bincount(group, minlength=n_groups)
    s_max = max(int(gcounts.max()), 1)
    gstarts = np.concatenate([[0], np.cumsum(gcounts)[:-1]])
    order_t = np.lexsort((cslot, group))  # by group, then output tile
    posg = np.arange(len(cr), dtype=np.int64) - gstarts[group[order_t]]
    flat = np.zeros((n_groups * s_max, 3), dtype=np.int32)
    flat[:, 0] = n_c
    rowsel = group[order_t] * s_max + posg
    flat[rowsel, 0] = cslot[order_t]
    flat[rowsel, 1] = a_slot[asl_g[order_t]]
    flat[rowsel, 2] = b_slot[bsl_g[order_t]]
    stacks = flat.reshape(p, p, layers, p, s_max, 3)

    return TiledCannonPlan(
        p=p, layers=layers, n_a=n_a, n_b=n_b, n_c=n_c, s_max=s_max,
        a_pack=a_pack, b_pack=b_pack, stacks=stacks, c_unpack=c_unpack,
    )


# ---------------------------------------------------------------------------
# ranks: per-tick device stacks, the tick loop, packing and unpacking
# ---------------------------------------------------------------------------

def rank_kernel(dtype: torch.dtype) -> Callable:
    """The stack kernel a rank's tick launches for stores of ``dtype``:
    ``kernel(a_panel, b_panel, stack) -> [n_c, T, T]`` partial in
    ``accumulator_dtype(dtype)`` (float32 for float32/bfloat16)."""
    if dtype.is_complex:
        return tile_stack_matmul_c
    if dtype == torch.float64:
        return tile_stack_matmul_f64

    def k1(a, b, stack):
        return tile_stack_matmul(a, b, stack, out_dtype=torch.float32)

    return k1


@dataclass(frozen=True)
class TickStack:
    """One (rank, tick) stack, resident on the rank's device. ``touched``
    None: the stack is numbered in the rank's whole C panel (the kernel
    writes a zero tile where the tick adds nothing); else its C slots are
    renumbered among the ``touched`` panel slots (int64, ascending)."""

    stack: DeviceStack
    touched: Optional[torch.Tensor]


def tick_stack(rows: np.ndarray, n_c: int, device, whole: bool = False,
               chunks: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               depths: Optional[np.ndarray] = None, tile: int = 0) -> Optional[TickStack]:
    """A (rank, tick) stack of a plan, its rows on the trash slot ``n_c``
    dropped ([S, 3], C-sorted), as a ``TickStack``; None when empty. A
    rank's first partial (``whole``) and a tick that touches at least half
    the panel launch over all of it: a zero tile costs one write, where an
    add restricted to the touched slots costs a gather, an add and a
    scatter. A sparser later tick launches over its touched slots only.
    ``chunks``: the K masks of the A and B pieces the tick multiplies,
    piece slot by piece slot, ``depths`` the rows' issued depths and
    ``tile`` the tile edge, for the float64 kernel's stack and its run
    segments (``f64_device_stack``)."""
    if not len(rows):
        return None

    def upload(stack, n):
        if chunks is None:
            return device_stack(stack, n, device)
        return f64_device_stack(stack, n, device, chunks, tile, depths)

    touched, local = np.unique(rows[:, 0], return_inverse=True)
    if whole or 2 * len(touched) >= n_c:
        return TickStack(upload(rows.astype(np.int32), n_c), None)
    stack = np.stack([local, rows[:, 1], rows[:, 2]], axis=1).astype(np.int32)
    return TickStack(upload(stack, len(touched)),
                     torch.as_tensor(touched.astype(np.int64), device=device))


def cannon_piece_masks(plan: TiledCannonPlan, dtype: torch.dtype, tile: int,
                       a_index: BCSRIndex, ta: bool, a_perm: Optional[np.ndarray],
                       b_index: BCSRIndex, tb: bool, b_perm: Optional[np.ndarray]
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The float64 kernel's K masks (``f64_stack.py``) of every A and B
    piece slot of a tiled Cannon plan as packed, in ``a_pack``/``b_pack``
    order: slot s holds op-store tile ``pack[s]`` and takes its mask (from
    the block index alone, ``operand_chunk_masks`` with the op store's
    ``perm``); a padding slot (-1), which no entry names, takes 0. None
    where the rank kernel reads no masks: stores other than float64, tile
    edges outside ``CHUNKED_TILES``."""
    if dtype != torch.float64 or tile not in CHUNKED_TILES:
        return None

    def per_slot(pack, masks):
        return np.where(pack >= 0, masks[np.maximum(pack, 0)], 0).astype(np.int32)

    return (per_slot(plan.a_pack, operand_chunk_masks(a_index, tile, ta, a_perm, "a")),
            per_slot(plan.b_pack, operand_chunk_masks(b_index, tile, tb, b_perm, "b")))


def accumulate(c: Optional[torch.Tensor], part: torch.Tensor, ts: TickStack,
               n_c: int) -> torch.Tensor:
    """``c += part`` on the tick's slots (c None: a zero panel; a whole-panel
    partial then IS the panel). The slots are unique, so no two updates
    meet: the add is deterministic."""
    if ts.touched is None:
        return part if c is None else c.add_(part)
    if c is None:
        c = part.new_zeros((n_c,) + tuple(part.shape[1:]))
        return c.index_copy_(0, ts.touched, part)
    return c.index_copy_(0, ts.touched, c.index_select(0, ts.touched).add_(part))


class RankGather:
    """Per-rank gathers out of one source store, resolved once: rank
    ``r``'s piece is ``src[slot_map[r*n:(r+1)*n]]``, handed to the rank's
    device. A -1 of a tile map is a padding slot past the panel's tiles,
    which no stack entry names: it takes tile 0 (one ``index_select``, no
    zero fill). With ``elements`` the map addresses the flattened source's
    elements, -1 is a position no stored element reaches and must be zero
    (the padding-zero invariant), and each piece is reshaped to tiles. Only
    the ranks of this process (``local``) are gathered: every process holds
    the whole source, as every process of the JAX battery builds the same
    operands; the others' pieces are None."""

    def __init__(self, slot_map: np.ndarray, n: int, n_src: int, src_device,
                 devices: List[torch.device], tile: int, elements: bool = False,
                 local: Optional[List[bool]] = None):
        self.devices = devices
        self.tile = tile
        self.elements = elements
        self.n = n
        local = local if local is not None else [True] * len(devices)
        if elements:
            self.gathers = [tile_gather(slot_map[r * n:(r + 1) * n], n_src, src_device)
                            if local[r] else None for r in range(len(devices))]
        else:
            self.gathers = [torch.as_tensor(np.maximum(slot_map[r * n:(r + 1) * n], 0),
                                            dtype=torch.int64, device=src_device)
                            if local[r] else None for r in range(len(devices))]

    def __call__(self, src: torch.Tensor) -> List[Optional[torch.Tensor]]:
        if self.elements:
            return [None if g is None else move(apply_tile_gather(src.reshape(-1), g).reshape(
                -1, self.tile, self.tile), dev) for g, dev in zip(self.gathers, self.devices)]
        if src.shape[0] == 0:
            return [None if g is None else
                    src.new_zeros((self.n,) + tuple(src.shape[1:]), device=dev)
                    for g, dev in zip(self.gathers, self.devices)]
        return [None if g is None else move(src.index_select(0, g), dev)
                for g, dev in zip(self.gathers, self.devices)]


class ShardGather:
    """Per-rank gathers out of a SHARDED store (``dist/sharded.py``: one
    ``[n_max, T, T]`` shard per rank of the (i, j) plane), resolved once:
    ``pos_map[r*n + t]`` is the sharded position ``s * n_max + local`` of
    rank ``r``'s piece tile ``t`` (-1: zero). Each rank copies what it needs
    from each shard, ``index_select`` on the shard's device, one transfer,
    ``index_copy_`` on its own (the reference's ``make_images`` alltoall);
    a shard on another process sends the selected tiles as one message.
    Padding slots (-1) are left unwritten: no stack entry names them."""

    def __init__(self, pos_map: np.ndarray, n: int, n_max: int, grid: ProcessGrid,
                 tile: int):
        plane = [(i, j, 0) for i in range(grid.nprow) for j in range(grid.npcol)]
        self.n, self.tile = n, tile
        self.devices = [grid.device(*rk) for rk in grid.ranks()]
        own = self.owners = grid.owner_list()
        self.shard_own = [grid.owner(*rk) for rk in plane]
        me = comm.rank()
        # (rank, shard, dst slots on the rank's device, src slots on the shard's)
        self.parts = []
        for r in range(len(self.devices)):
            blk = pos_map[r * n:(r + 1) * n]
            for sh, rk in enumerate(plane):
                sel = np.flatnonzero((blk >= sh * n_max) & (blk < (sh + 1) * n_max))
                if not len(sel):
                    continue
                dst = (torch.as_tensor(sel, device=self.devices[r]) if own[r] == me
                       else len(sel))
                src = (torch.as_tensor(blk[sel] - sh * n_max, device=grid.device(*rk))
                       if self.shard_own[sh] == me else None)
                self.parts.append((r, sh, own[r], dst, src))

    def __call__(self, shards: List[Optional[torch.Tensor]], dtype: torch.dtype
                 ) -> List[Optional[torch.Tensor]]:
        me = comm.rank()
        t = self.tile
        msgs, keys = [], []
        for k, (r, sh, o, dst, _) in enumerate(self.parts):
            if o != self.shard_own[sh]:
                n = dst if isinstance(dst, int) else len(dst)
                msgs.append((self.shard_own[sh], o, (n, t, t), dtype))
                keys.append(k)
        got = comm.exchange(msgs, lambda i: shards[self.parts[keys[i]][1]].index_select(
            0, self.parts[keys[i]][4]))
        remote = {keys[i]: x for i, x in got.items()}
        # a -1 is a padding slot no stack entry names: left as it is
        out = [torch.empty((self.n, t, t), dtype=dtype, device=dev) if o == me else None
               for o, dev in zip(self.owners, self.devices)]
        for k, (r, sh, o, dst, src) in enumerate(self.parts):
            if o != me:
                continue
            x = (shards[sh].index_select(0, src) if self.shard_own[sh] == me
                 else remote[k])
            out[r].index_copy_(0, dst, move(x, self.devices[r]))
        return out


class RankUnpack:
    """The result store out of the ranks' C panels, resolved once:
    ``c_src[s]`` is the position of store slot (or element) ``s`` in the
    concatenation of the (i, j) panels (each ``n_c`` tiles) or -1 (zero).
    Each panel's slots are copied in one ``index_copy_`` (destinations
    unique), from a slice of the panel where it is read in order. Every
    process assembles the whole store, as the JAX result is one global
    array: a panel of another process (``owners``) arrives as one message
    of the slots the store reads."""

    def __init__(self, c_src: np.ndarray, n_c: int, tile: int, n_ranks: int,
                 devices: List[torch.device], out_device, *, owners: List[int],
                 elements: bool = False):
        per = n_c * (tile * tile if elements else 1)
        self.n_out = len(c_src)
        self.complete = bool((c_src >= 0).all())
        self.tile = tile
        self.elements = elements
        self.out_device = out_device
        self.owners = owners
        me = comm.rank()
        self.parts = []
        for d in range(n_ranks):
            sel = np.flatnonzero((c_src >= d * per) & (c_src < (d + 1) * per))
            if len(sel):
                src = (c_src[sel] - d * per).astype(np.int64)
                # a panel read in order from its start is a slice, not a gather
                ordered = bool(np.array_equal(src, np.arange(len(src))))
                self.parts.append((
                    d,
                    torch.as_tensor(sel.astype(np.int64), device=out_device),
                    len(src) if ordered or self.owners[d] != me
                    else torch.as_tensor(src, device=devices[d]),
                ))

    def __call__(self, panels: List[Optional[torch.Tensor]],
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``dtype``: the panels' type (default: that of the first panel of
        this process; a process that holds none must say)."""
        t = self.tile
        if dtype is None:
            dtype = next(x.dtype for x in panels if x is not None)
        pieces = []
        for d, dst, src in self.parts:
            x = panels[d]
            if x is not None:
                x = x.reshape(-1) if self.elements else x
                x = x[:src] if isinstance(src, int) else x.index_select(0, src)
            pieces.append(x)
        shapes = [(len(dst),) if self.elements else (len(dst), t, t)
                  for _, dst, _ in self.parts]
        pieces = comm.all_gather_panels([self.owners[d] for d, _, _ in self.parts],
                                        pieces, shapes, dtype)
        shape = (self.n_out,) if self.elements else (self.n_out, t, t)
        make = torch.empty if self.complete else torch.zeros
        out = make(shape, dtype=dtype, device=self.out_device)
        for (_, dst, _), x in zip(self.parts, pieces):
            out.index_copy_(0, dst, move(x, self.out_device))
        return out.reshape(-1, t, t) if self.elements else out


@dataclass
class RankPlan:
    """A Cannon or SUMMA schedule made resident on the grid's ranks:
    per-rank, per-tick ``TickStack``s (SUMMA: one tick), for the ranks of
    this process (the others' ticks are None). ``run`` takes the ranks'
    A and B pieces (lists in row-major (i, j, l) rank order, None off this
    process) and returns the (i, j) C panels, layers summed, in the
    accumulator type (None where rank (i, j, 0) is off this process)."""

    algo: str  # "cannon" | "summa"
    grid: ProcessGrid
    tile: int
    n_a: int
    n_b: int
    n_c: int
    ticks: List[List[Optional[TickStack]]]
    n_stack: int  # stack entries over all ranks and ticks
    #: whether each rank (of any process) computes a partial: known from the
    #: plan everywhere, so a layer sum knows which partials to expect
    has_part: List[bool]
    #: float64 [ranks], every rank of any process: the flops its ticks issue
    #: (``depth_flops`` of the ticks' issued depths, else 2·T³ an entry)
    #: and the tile figure they come from (2·T³ an entry)
    hw_flops: np.ndarray
    padded_flops: np.ndarray

    @property
    def launches(self) -> int:
        """Kernel launches of one ``run`` on this process: its ranks'
        non-empty (rank, tick) stacks."""
        return sum(ts is not None for per in self.ticks for ts in per)

    def record_comm(self, itemsize: int) -> None:
        """The JAX package's static message accounting of one ``run``: each
        rank receives P-1 ring shifts of each panel (Cannon), or the other
        owners' pieces (SUMMA: Q-1 of A's, P-1 of B's); one C reduction
        across layers."""
        st, g = get_stats(), self.grid
        kind, shifts_a = (("ppermute", g.nprow - 1) if self.algo == "cannon"
                          else ("allgather", g.npcol - 1))
        tt = self.tile * self.tile * itemsize
        st.record_comm(f"{kind}_a", g.size * shifts_a, self.n_a * tt)
        st.record_comm(f"{kind}_b", g.size * (g.nprow - 1), self.n_b * tt)
        if g.nlayer > 1:
            st.record_comm("psum_c_layers", g.size * (g.nlayer - 1), self.n_c * tt)

    def rank_segments(self) -> np.ndarray:
        """int64 [ranks, 2]: each rank's ``(split_runs, run_segments)`` of one
        ``run``, its ticks summed (0 for ranks off this process)."""
        out = np.zeros((len(self.ticks), 2), dtype=np.int64)
        for r, per in enumerate(self.ticks):
            for ts in per:
                if ts is not None and ts.stack is not None:
                    out[r] += (ts.stack.split_runs, ts.stack.run_segments)
        return out

    def tile_flops(self) -> Tuple[float, float]:
        """``(issued, padded)`` of one ``run`` over every rank, as
        ``Stats.add_tile_flops`` takes them."""
        return float(self.hw_flops.sum()), float(self.padded_flops.sum())

    @staticmethod
    def build(algo: str, grid: ProcessGrid, tile: int, n_a: int, n_b: int,
              n_c: int, stacks: np.ndarray,
              chunks: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> "RankPlan":
        """``stacks``: [P, Q, L, T, s_max, 3] (ticks T = P for Cannon, 1 for
        SUMMA), in rank order. ``chunks`` (Cannon only): the K masks of
        every rank's A and B piece slots as packed (``cannon_piece_masks``);
        rank (i, j, l) holds at tick t the A piece of rank (i, j+t, l) and
        the B piece of rank (i+t, j, l), so each (rank, tick) stack takes
        those pieces' masks."""
        dbcsr_assert(chunks is None or algo == "cannon", "K masks need a Cannon plan")
        ranks = grid.ranks()
        p, nl = grid.nprow, grid.nlayer
        st = stacks.reshape(len(ranks), -1, stacks.shape[-2], 3)
        entries = (st[..., 0] < n_c).sum(axis=(1, 2))
        padded = 2.0 * tile**3 * entries
        issued = padded.copy() if chunks is None else np.zeros(len(ranks))
        ticks = []
        for r, (i, j, l) in enumerate(ranks):
            per, first = [], True
            for t in range(st.shape[1]):
                rows = st[r, t][st[r, t, :, 0] < n_c]
                masks = depths = None
                if chunks is not None:
                    sa = (i * p + (j + t) % p) * nl + l
                    sb = (((i + t) % p) * p + j) * nl + l
                    masks = (chunks[0][sa * n_a:(sa + 1) * n_a],
                             chunks[1][sb * n_b:(sb + 1) * n_b])
                    depths = entry_depths(*masks, rows[:, 1], rows[:, 2])
                    issued[r] += depth_flops(depths, tile)
                ts = (tick_stack(rows, n_c, grid.device(i, j, l), whole=first, chunks=masks,
                                 depths=depths, tile=tile)
                      if grid.is_local(i, j, l) else None)
                first = first and ts is None
                per.append(ts)
            ticks.append(per)
        return RankPlan(algo, grid, tile, n_a, n_b, n_c, ticks, int(entries.sum()),
                        [bool(e) for e in entries], issued, padded)

    def run(self, a_pieces: List[Optional[torch.Tensor]],
            b_pieces: List[Optional[torch.Tensor]], dtype: torch.dtype
            ) -> List[Optional[torch.Tensor]]:
        kernel = rank_kernel(dtype)
        loop = self._cannon if self.algo == "cannon" else self._summa
        parts = loop(a_pieces, b_pieces, kernel, dtype)
        return self._sum_layers(parts, accumulator_dtype(dtype))

    def _rank(self, i: int, j: int, l: int) -> int:
        g = self.grid
        return (i * g.npcol + j) * g.nlayer + l

    def _cannon(self, a, b, kernel, dtype):
        g = self.grid
        p, t = g.nprow, self.tile
        ranks = g.ranks()
        c: List[Optional[torch.Tensor]] = [None] * len(ranks)
        # ring shifts: A left along 'pc', B up along 'pr'
        src_a = [self._rank(i, (j + 1) % p, l) for (i, j, l) in ranks]
        src_b = [self._rank((i + 1) % p, j, l) for (i, j, l) in ranks]
        for tick in range(p):
            with timed("cannon/ticks"):
                for r in range(len(ranks)):
                    ts = self.ticks[r][tick]
                    if ts is not None:
                        c[r] = accumulate(c[r], kernel(a[r], b[r], ts.stack), ts, self.n_c)
            if tick == p - 1:
                break
            with timed("cannon/shift"):
                a, b = comm.shift(g, [(a, src_a, (self.n_a, t, t), dtype),
                                      (b, src_b, (self.n_b, t, t), dtype)])
        return c

    def _summa(self, a, b, kernel, dtype):
        """Each rank gathers A's row panel along 'pc' and B's column panel
        along 'pr' (one concatenation per panel and device, shared by the
        ranks on that device), then launches once."""
        g = self.grid
        p, q, t = g.nprow, g.npcol, self.tile
        ranks = g.ranks()
        rows = comm.gather_along(g, a, [[self._rank(i, k, l) for k in range(q)]
                                        for (i, j, l) in ranks], (self.n_a, t, t), dtype)
        cols = comm.gather_along(g, b, [[self._rank(k, j, l) for k in range(p)]
                                        for (i, j, l) in ranks], (self.n_b, t, t), dtype)
        c: List[Optional[torch.Tensor]] = []
        for r in range(len(ranks)):
            ts = self.ticks[r][0]
            c.append(None if ts is None else accumulate(
                None, kernel(rows[r], cols[r], ts.stack), ts, self.n_c))
        return c

    def _sum_layers(self, parts, acc: torch.dtype) -> List[Optional[torch.Tensor]]:
        """The (i, j) C panels: layer partials summed in layer order on the
        device of rank (i, j, 0), in place into the first."""
        g = self.grid
        t = self.tile
        sums = [(self._rank(i, j, 0), [self._rank(i, j, l) for l in range(g.nlayer)])
                for i in range(g.nprow) for j in range(g.npcol)]
        return comm.ordered_sum(g, parts, self.has_part, sums, (self.n_c, t, t), acc)


@dataclass
class DistExec:
    """A distributed plan with everything it reads on the devices: the
    packing of the op stores into the ranks' pieces, the ranks' stacks and
    the unpacking of the C panels into C's store."""

    plan: RankPlan
    pack_a: RankGather
    pack_b: RankGather
    unpack: RankUnpack
    #: op(A)/op(B) store permutation (tiled plans on 'T'; None: the store)
    a_perm: Optional[torch.Tensor] = None
    b_perm: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        """Device bytes of the gather and unpack maps."""
        n = 0
        for pk in (self.pack_a, self.pack_b):
            for g in pk.gathers:
                if g is not None:
                    n += (g.dst.numel() + g.src.numel() if pk.elements else g.numel()) * 8
        for _, dst, src in self.unpack.parts:
            n += (dst.numel() + (0 if isinstance(src, int) else src.numel())) * 8
        return n

    def __call__(self, a_data: torch.Tensor, b_data: torch.Tensor,
                 conj: Tuple[bool, bool] = (False, False)) -> torch.Tensor:
        from .engine import _op_store

        a_st = _op_store(a_data, self.a_perm, conj[0])
        b_st = _op_store(b_data, self.b_perm, conj[1])
        panels = self.plan.run(self.pack_a(a_st), self.pack_b(b_st), a_data.dtype)
        return self.unpack(panels, accumulator_dtype(a_data.dtype))


def dist_exec(algo: str, plan, grid: ProcessGrid, tile: int, a_perm, b_perm,
              n_a_store: int, n_b_store: int, device, chunks=None) -> DistExec:
    """A tiled Cannon (``TiledCannonPlan``) or SUMMA (``summa.SummaPlan``)
    host plan made resident: op stores with ``n_a_store``/``n_b_store``
    tiles on ``device``, ranks on ``grid``; ``chunks`` as ``RankPlan.build``
    takes them."""
    stacks = plan.stacks.reshape(grid.nprow, grid.npcol, grid.nlayer, -1, plan.s_max, 3)
    ranks, local = _rank_devices(grid)
    plane, owners = _plane(grid)
    return DistExec(
        RankPlan.build(algo, grid, tile, plan.n_a, plan.n_b, plan.n_c, stacks, chunks),
        RankGather(plan.a_pack, plan.n_a, n_a_store, device, ranks, tile, local=local),
        RankGather(plan.b_pack, plan.n_b, n_b_store, device, ranks, tile, local=local),
        RankUnpack(plan.c_unpack, plan.n_c, tile, len(plane), plane, device,
                   owners=owners),
        a_perm, b_perm,
    )


def _rank_devices(grid: ProcessGrid):
    """Every rank's device, and whether this process holds it."""
    ranks = grid.ranks()
    return [grid.device(*r) for r in ranks], [grid.is_local(*r) for r in ranks]


def _plane(grid: ProcessGrid):
    """The (i, j, 0) ranks' devices and processes: where C's panels lie."""
    cells = [(i, j, 0) for i in range(grid.nprow) for j in range(grid.npcol)]
    return [grid.device(*c) for c in cells], [grid.owner(*c) for c in cells]


def _element_exec(plan: CannonPlan, a, b, c_lay, grid, tile, device) -> DistExec:
    """The element-granular plan made resident: panel element → at-rest
    store element maps (the at-rest store, not the op store: the plan's
    element maps are in op space already)."""
    ranks, local = _rank_devices(grid)
    plane, owners = _plane(grid)
    p, layers, tt = plan.p, plan.layers, tile * tile
    bad = np.iinfo(np.int32).max
    a_inv = _inverse_map_values(plan.a_dest, a.layout.elem_dest,
                                p * p * layers * plan.n_a * tt)
    b_inv = _inverse_map_values(plan.b_dest, b.layout.elem_dest,
                                p * p * layers * plan.n_b * tt)
    c_src = _inverse_map_values(c_lay.elem_dest, plan.c_src, c_lay.n_tiles * tt)
    rp = RankPlan.build("cannon", grid, tile, plan.n_a, plan.n_b, plan.n_c,
                        plan.stacks)
    return DistExec(
        rp,
        RankGather(np.where(a_inv == bad, -1, a_inv), plan.n_a * tt,
                   a.data.numel(), device, ranks, tile, elements=True, local=local),
        RankGather(np.where(b_inv == bad, -1, b_inv), plan.n_b * tt,
                   b.data.numel(), device, ranks, tile, elements=True, local=local),
        RankUnpack(np.where(c_src == bad, -1, c_src), plan.n_c, tile, p * p, plane,
                   device, elements=True, owners=owners),
    )


@dataclass(frozen=True)
class DistPlan:
    """How op(A)·op(B) into a C index runs over a grid (``plan_distributed``):
    the host ``plan`` (a ``TiledCannonPlan``, a ``summa.SummaPlan``, or the
    element-granular ``CannonPlan``) and what both entry points read off it.
    ``rowb``/``colb``/``kb`` bin each m/n/k tile on the grid and
    ``a_op``/``b_op`` are the op patterns, all None on the element plan,
    which bins blocks; ``chunks`` are the pieces' K masks
    (``cannon_piece_masks``), ``stacks`` the plan's stacks as
    ``RankPlan.build`` takes them, ``[P, Q, L, ticks, s_max, 3]``."""

    algo: str
    grid: ProcessGrid
    plan: object
    tile: int
    m_sizes: np.ndarray
    k_sizes: np.ndarray
    n_sizes: np.ndarray
    c_layout: object
    stacks: np.ndarray
    rowb: Optional[np.ndarray] = None
    colb: Optional[np.ndarray] = None
    kb: Optional[np.ndarray] = None
    a_op: Optional[object] = None
    b_op: Optional[object] = None
    chunks: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def resident(self, a: BCSRMatrix, b: BCSRMatrix) -> DistExec:
        """The plan made resident for op stores of ``a`` and ``b`` (new
        data, the same patterns), on their device."""
        dev = a.device
        if self.a_op is None:
            return _element_exec(self.plan, a, b, self.c_layout, self.grid, self.tile, dev)
        return dist_exec(self.algo, self.plan, self.grid, self.tile, _perm(self.a_op, dev),
                         _perm(self.b_op, dev), a.data.shape[0], b.data.shape[0], dev,
                         self.chunks)


def plan_distributed(a: BCSRMatrix, ta: bool, b: BCSRMatrix, tb: bool,
                     c_index: BCSRIndex, dist: Distribution, k_dist: Optional[np.ndarray],
                     algo: str, *, tiled: bool) -> DistPlan:
    """How op(A)·op(B) into ``c_index`` runs over ``dist``'s grid by
    ``algo`` ("cannon" | "summa"): the one planner of ``multiply(dist=)``
    and ``build_distributed_executor``. ``k_dist`` bins the inner blocks
    (None: whole tile rows round-robin over P for Cannon, max(P, Q) for
    SUMMA). The tile-granular plans honor a block distribution as its
    nearest tile-aligned form (``dist_tile_bins``, ``majority``); Cannon
    with ``tiled`` off takes the element-granular plan instead, SUMMA is
    tile-granular always. The host plan is the span ``cannon/plan`` or
    ``summa/plan``."""
    from ..dist.distribution import dist_tile_bins, tile_dist_vector
    from .engine import _op_pattern, _op_sizes
    from .summa import plan_summa

    grid, tile = dist.grid, a.tile
    p, q, layers = grid.nprow, grid.npcol, grid.nlayer
    sizes = _op_sizes(a, ta, b, tb)
    m_sizes, k_sizes, n_sizes = sizes
    if k_dist is None:
        k_dist = tile_dist_vector(k_sizes, p if algo == "cannon" else max(p, q), tile)
    c_lay = store_layout(c_index, tile)
    if algo == "cannon" and not tiled:
        with timed("cannon/plan"):
            plan = plan_cannon(a.index, ta, b.index, tb, c_index, dist, k_dist, tile)
        return DistPlan(algo, grid, plan, tile, *sizes, c_lay, plan.stacks)
    rowb = dist_tile_bins(dist.row_dist, m_sizes, tile, majority=True)
    colb = dist_tile_bins(dist.col_dist, n_sizes, tile, majority=True)
    kb = dist_tile_bins(k_dist, k_sizes, tile, majority=True)
    a_op, b_op = _op_pattern(a, ta), _op_pattern(b, tb)
    with timed(f"{algo}/plan"):
        if algo == "cannon":
            plan = plan_cannon_tiled(a_op.coords, b_op.coords, c_lay, rowb, colb, kb, p,
                                     layers)
        else:
            plan = plan_summa(a_op.coords, b_op.coords, c_lay, rowb, colb, kb % q, kb % p,
                              p, q, layers)
    # the K masks of the ranks' pieces, where the rank kernel reads them
    chunks = (cannon_piece_masks(plan, a.dtype, tile, a.index, ta, a_op.perm, b.index, tb,
                                 b_op.perm) if algo == "cannon" else None)
    return DistPlan(algo, grid, plan, tile, *sizes, c_lay,
                    plan.stacks.reshape(p, q, layers, -1, plan.s_max, 3),
                    rowb, colb, kb, a_op, b_op, chunks)


def execute_distributed(a: BCSRMatrix, ta: bool, ca: bool, b: BCSRMatrix, tb: bool,
                        cb: bool, c: Optional[BCSRMatrix], c_index: BCSRIndex, alpha,
                        beta, dist: Distribution, k_dist: Optional[np.ndarray], algo: str,
                        *, tiled: bool, mask_result: bool = False) -> torch.Tensor:
    """The distributed path of ``multiply``; returns C's tile store on the
    operands' device. The resident plan (``plan_distributed``, then
    ``DistPlan.resident``) is kept in the plan cache under the content of
    the patterns, the distribution, ``k_dist``, the device and whether the
    stores are float64 (the only ones whose stacks carry K masks), so a
    repeated call plans nothing. Tile-granular plans pack and unpack by
    tile-level gathers; the element-granular plan (``tiled`` off, Cannon)
    packs through composed element maps."""
    from .engine import _finish
    from .plancache import (
        array_fingerprint,
        dist_fingerprint,
        get_plan_cache,
        index_fingerprint,
    )

    pcache = get_plan_cache()
    key = pcache.key(a.index, ta, b.index, tb, extra=(
        f"{algo}_exec", tiled, index_fingerprint(c_index), dist_fingerprint(dist),
        None if k_dist is None else array_fingerprint(k_dist), a.tile, str(a.device),
        a.dtype == torch.float64))
    ex = pcache.get(key)
    if ex is None:
        ex = plan_distributed(a, ta, b, tb, c_index, dist, k_dist, algo,
                              tiled=tiled).resident(a, b)
        pcache.put(key, ex, nbytes=ex.nbytes)
    ex.plan.record_comm(a.data.element_size())
    with timed(f"{algo}/exec"):
        prod = ex(a.data, b.data,
                  (ca and a.dtype.is_complex, cb and b.dtype.is_complex)).to(a.dtype)
    get_stats().add_tile_flops(*ex.plan.tile_flops())
    get_stats().add_segments(*(int(x) for x in ex.plan.rank_segments().sum(axis=0)))
    return _finish(prod, c, c_index, a.tile, alpha, beta, mask_result)


def _perm(op, device) -> Optional[torch.Tensor]:
    """The op store's tile permutation on ``device`` (None for 'N')."""
    if op.perm is None:
        return None
    return torch.as_tensor(op.perm.astype(np.int64), device=device)
