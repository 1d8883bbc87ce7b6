"""Parallel TAS groups on ranks of their own.

Port of ``dbcsr_tpu/tas/parallel.py``. The reference runs its TAS groups on
disjoint MPI subgroups of the cartesian grid at once
(``dbcsr_tas_split.F``), splitting whichever of (m, k, n) is largest
(``max_mm_dim``, ``src/tas/dbcsr_tas_mm.F:79-782``). The host loop of
``tas/mm.py`` runs the groups one after another through ``multiply``;
here every group is one rank (a torch device, ranks may share one) and
its product is ONE launch of the port's stack kernel for the dtype
(``cannon.rank_kernel``) over the group's own tile stack:

- ``long_dim='m'``: A's rows split, B handed to every group's device; the
  groups' C row panels are merged (disjoint);
- ``long_dim='n'``: B's columns split, A handed over; C column panels
  merged;
- ``long_dim='k'``: the contraction dimension split: A's columns and B's
  rows carry the same split, every group computes a partial product, and
  the partials are added into the union C pattern in group order (the
  reference's ``redistribute_and_sum``, ``dbcsr_tas_mm.F:783``);
- ``long_dim='auto'``: the largest dimension.

The JAX package pads the groups to one shape and stacks them on a 'split'
mesh axis, because one ``shard_map`` program needs static shapes; the
groups here launch one by one at their own sizes and need no padding.
``tas_multiply_subgrid`` gives each group a 2-D sub-grid of ranks and runs
it as SUMMA (``mm/summa.py``), one launch per rank.

In a distributed run (``init_lib(distributed=True)``) the groups (and the
sub-grids' ranks) are dealt round-robin over the world's processes: every
process plans every group, launches its own, and gathers the others'
results (``dist/comm.py``) before the merge, which runs in group order on
every process, as one process does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix
from ..block.index import build_index
from ..block.store import store_layout
from ..block.tileops import apply_tile_gather, tile_align_map, tile_gather
from ..core.errors import dbcsr_assert
from ..core.timing import timed
from ..dist import comm
from ..dist.grid import ProcessGrid, rank_devices
from ..mm.cannon import TickStack, accumulate, move, rank_kernel
from ..mm.kernels import accumulator_dtype, device_stack
from ..mm.plan import symbolic_product
from ..mm.tileplan import plan_tile_stacks_stores
from ..ops.transform import desymmetrize
from .matrix import extract_block_subset, merge_col_groups, merge_row_groups
from .split import COLSPLIT, ROWSPLIT, TASSplit

__all__ = ["tas_multiply_parallel", "tas_multiply_subgrid"]


def _group_devices(nsplit: Optional[int], devices) -> List[torch.device]:
    """The groups' devices: ``devices``, else ``nsplit`` ranks over the
    visible CUDA devices (one per device when ``nsplit`` is None; one per
    process in a distributed run)."""
    if devices is not None:
        return rank_devices(len(devices), devices)
    if nsplit is None:
        nsplit = comm.world_size() if comm.is_up() else max(torch.cuda.device_count(), 1)
    return rank_devices(nsplit)


def _group_product(a_st: torch.Tensor, b_st: torch.Tensor, plan, dev) -> torch.Tensor:
    """One group's tile product on ``dev``: one stack-kernel launch over the
    group's C-sorted stack (no launch when the group has no product)."""
    ds = device_stack(plan.stack, plan.n_c_tiles, dev)
    return rank_kernel(a_st.dtype)(move(a_st, dev), move(b_st, dev), ds)


def tas_multiply_parallel(
    a: BCSRMatrix,
    b: BCSRMatrix,
    *,
    long_dim: str = "m",
    nsplit: Optional[int] = None,
    devices=None,
    split_kind: str = "contiguous",
    return_flops: bool = False,
):
    """``C = A · B`` with the ``long_dim`` ∈ {'m','n','k','auto'} dimension
    split into ``nsplit`` groups, one rank each (``devices``, or ranks over
    the visible CUDA devices); the result lands on A's device. The
    rank-parallel analog of ``tas_multiply(..., long_dim=...)``."""
    a = desymmetrize(a)
    b = desymmetrize(b)
    dbcsr_assert(a.tile == b.tile, "operand tile sizes differ")
    dbcsr_assert(
        np.array_equal(a.index.col_block_sizes, b.index.row_block_sizes),
        "inner block dimensions do not match",
    )
    dbcsr_assert(long_dim in ("m", "n", "k", "auto"), "long_dim must be m|n|k|auto")
    if long_dim == "auto":  # the reference's max_mm_dim
        dims = {"m": a.index.nfullrows, "k": a.index.nfullcols, "n": b.index.nfullcols}
        long_dim = max(dims, key=dims.get)
    tile = a.tile
    devs = _group_devices(nsplit, devices)
    nblk_long = {"m": a.nblkrows, "n": b.index.nblkcols, "k": a.index.nblkcols}[long_dim]
    if nsplit is None:
        nsplit = len(devs)
    nsplit = max(1, min(nsplit, len(devs), nblk_long))
    mk = TASSplit.contiguous if split_kind == "contiguous" else TASSplit.cyclic
    rowcol = ROWSPLIT if long_dim in ("m", "k") else COLSPLIT
    split = mk(rowcol, nblk_long, nsplit)
    out_dev = a.device
    rbs, cbs = a.index.row_block_sizes, b.index.col_block_sizes

    me, world = comm.rank(), comm.world_size()
    owners = [g % world for g in range(nsplit)]  # the groups dealt over the processes
    if long_dim in ("m", "n"):
        rows = long_dim == "m"
        groups, eff = [], 0.0
        for g in range(nsplit):
            blocks = split.blocks_of_group(g)
            with timed("tas_parallel/plan"):
                if rows:
                    a_g, b_g = extract_block_subset(a, row_blocks=blocks), b
                else:
                    a_g, b_g = a, extract_block_subset(b, col_blocks=blocks)
                la, lb = a_g.layout, b_g.layout
                plan = plan_tile_stacks_stores(la.tile_coords, (la.ntr, la.ntc),
                                               lb.tile_coords, (lb.ntr, lb.ntc))
                symb = symbolic_product(a_g.index, False, b_g.index, False)
                eff += symb.eff_flops
                c_g_index, _ = build_index(symb.rows, symb.cols,
                                           a_g.index.row_block_sizes,
                                           b_g.index.col_block_sizes)
                # product tiles -> the group C store's tiles: the tile plan
                # also holds tiles where an A and a B tile meet but no block
                # pair does (the JAX package asserts there are none)
                align = tile_gather(
                    tile_align_map(store_layout(c_g_index, tile).tile_keys(),
                                   plan.c_tile_keys), plan.n_c_tiles, out_dev)
            c_g = None
            if owners[g] == me:
                with timed("tas_parallel/exec"):
                    c_g = _group_product(a_g.data, b_g.data, plan, devs[g])
                    c_g = apply_tile_gather(move(c_g, out_dev), align).to(a.dtype)
            groups.append((c_g, c_g_index, blocks))
        with timed("tas_parallel/merge"):
            stores = comm.all_gather_panels(
                owners, [c_g for c_g, _, _ in groups],
                [(store_layout(ci, tile).n_tiles, tile, tile) for _, ci, _ in groups],
                a.dtype)
            parts = [(BCSRMatrix(name=f"g{g}", index=ci, data=move(x, out_dev)), blocks)
                     for g, (x, (_, ci, blocks)) in enumerate(zip(stores, groups))]
            merge = merge_row_groups if rows else merge_col_groups
            out = merge(parts, rbs, cbs, name="tas_parallel", dtype=a.dtype,
                        device=out_dev)
    else:  # k split: partial products over the union C pattern, summed in group order
        subs, plans, eff = [], [], 0.0
        with timed("tas_parallel/plan"):
            for g in range(nsplit):
                blocks = split.blocks_of_group(g)
                a_g = extract_block_subset(a, col_blocks=blocks)
                b_g = extract_block_subset(b, row_blocks=blocks)
                la, lb = a_g.layout, b_g.layout
                plans.append(plan_tile_stacks_stores(la.tile_coords, (la.ntr, la.ntc),
                                                     lb.tile_coords, (lb.ntr, lb.ntc)))
                symb = symbolic_product(a_g.index, False, b_g.index, False)
                eff += symb.eff_flops
                subs.append((a_g, b_g, symb))
            nbc = b.index.nblkcols
            keys = np.unique(np.concatenate(
                [s[2].rows.astype(np.int64) * nbc + s[2].cols for s in subs]
                or [np.zeros(0, dtype=np.int64)]
            ))
            c_index, _ = build_index((keys // nbc).astype(np.int32),
                                     (keys % nbc).astype(np.int32), rbs, cbs)
            c_lay = store_layout(c_index, tile)
            c_keys = c_lay.tile_keys()
        c_store = None
        with timed("tas_parallel/exec"):
            touched, parts = [], []
            for g, ((a_g, b_g, _), plan) in enumerate(zip(subs, plans)):
                # the union C slots this group's product tiles land on (a
                # product tile no block pair reaches is in no C block: dropped)
                prod_of = tile_align_map(c_keys, plan.c_tile_keys)
                touched.append(np.flatnonzero(prod_of >= 0))
                part = None
                if owners[g] == me and len(plan.stack):
                    part = move(_group_product(a_g.data, b_g.data, plan, devs[g]), out_dev)
                    part = apply_tile_gather(part, tile_gather(prod_of[touched[g]],
                                                               plan.n_c_tiles, out_dev))
                parts.append(part)
            # partials summed in group order on every process
            live = [g for g in range(nsplit) if len(plans[g].stack)]
            got = comm.all_gather_panels([owners[g] for g in live], [parts[g] for g in live],
                                         [(len(touched[g]), tile, tile) for g in live],
                                         accumulator_dtype(a.dtype))
            for g, part in zip(live, got):
                full = len(touched[g]) == c_lay.n_tiles
                ts = TickStack(None, None if full else torch.as_tensor(touched[g],
                                                                       device=out_dev))
                c_store = accumulate(c_store, move(part, out_dev), ts, c_lay.n_tiles)
        if c_store is None:
            c_store = torch.zeros((c_lay.n_tiles, tile, tile), dtype=a.dtype,
                                  device=out_dev)
        out = BCSRMatrix(name="tas_parallel", index=c_index, data=c_store.to(a.dtype))

    if return_flops:
        return out, eff
    return out


def tas_multiply_subgrid(
    a: BCSRMatrix,
    b: BCSRMatrix,
    *,
    long_dim: str = "m",
    nsplit: int,
    subgrid: Tuple[int, int],
    devices=None,
    split_kind: str = "contiguous",
    return_flops: bool = False,
):
    """``C = A · B`` with ``nsplit`` TAS groups, each running SUMMA on its
    own ``subgrid = (p, q)`` grid of ranks (``nsplit·p·q`` ranks in all,
    from ``devices`` or over the visible CUDA devices). ``long_dim='m'``
    splits A's rows (B handed to every group); ``'n'`` splits B's columns."""
    from ..mm.cannon import dist_exec
    from ..mm.summa import pad_summa_plan, plan_summa

    a = desymmetrize(a)
    b = desymmetrize(b)
    dbcsr_assert(a.tile == b.tile, "operand tile sizes differ")
    dbcsr_assert(
        np.array_equal(a.index.col_block_sizes, b.index.row_block_sizes),
        "inner block dimensions do not match",
    )
    dbcsr_assert(long_dim in ("m", "n"), "subgrid TAS supports long_dim m|n")
    p, q = subgrid
    tile = a.tile
    need = nsplit * p * q
    devs = rank_devices(need, devices)
    world = comm.world_size()
    mk = TASSplit.contiguous if split_kind == "contiguous" else TASSplit.cyclic
    split_rows = long_dim == "m"
    nblk_long = a.nblkrows if split_rows else b.index.nblkcols
    split = mk(ROWSPLIT if split_rows else COLSPLIT, nblk_long, nsplit)

    with timed("tas_subgrid/plan"):
        # shared-operand tile bins: plain tile-cyclic (TAS groups carry no
        # user distribution)
        ktl = a.layout.ntc
        kb_a = (np.arange(ktl, dtype=np.int64) % q).astype(np.int32)
        kb_b = (np.arange(ktl, dtype=np.int64) % p).astype(np.int32)
        subs, first, eff = [], [], 0.0
        for g in range(nsplit):
            blocks = split.blocks_of_group(g)
            if split_rows:
                a_g, b_g = extract_block_subset(a, row_blocks=blocks), b
            else:
                a_g, b_g = a, extract_block_subset(b, col_blocks=blocks)
            symb = symbolic_product(a_g.index, False, b_g.index, False)
            c_g_index, _ = build_index(symb.rows, symb.cols, a_g.index.row_block_sizes,
                                       b_g.index.col_block_sizes)
            eff += symb.eff_flops
            la, lb = a_g.layout, b_g.layout
            rowb = (np.arange(la.ntr, dtype=np.int64) % p).astype(np.int32)
            colb = (np.arange(lb.ntc, dtype=np.int64) % q).astype(np.int32)
            first.append(plan_summa(la.tile_coords, lb.tile_coords,
                                    store_layout(c_g_index, tile), rowb, colb,
                                    kb_a, kb_b, p, q))
            subs.append((blocks, a_g, b_g, c_g_index))
        # the JAX package's common capacities (one shard_map for all groups)
        caps = (max(pl.n_a for pl in first), max(pl.n_b for pl in first),
                max(pl.n_c for pl in first), max(pl.s_max for pl in first))
        plans = [pad_summa_plan(pl, *caps) for pl in first]

    parts = []
    for g, ((blocks, a_g, b_g, c_g_index), plan) in enumerate(zip(subs, plans)):
        # the group's ranks continue the deal over the processes
        grid = ProcessGrid.make(p, q, devices=devs[g * p * q:(g + 1) * p * q],
                                owners=(g * p * q + np.arange(p * q)) % world)
        with timed("tas_subgrid/exec"):
            ex = dist_exec("summa", plan, grid, tile, None, None, a_g.data.shape[0],
                           b_g.data.shape[0], a.device)
            data = ex(a_g.data, b_g.data).to(a.dtype)
        parts.append((BCSRMatrix(name=f"g{g}", index=c_g_index, data=data), blocks))
    with timed("tas_subgrid/merge"):
        merge = merge_row_groups if split_rows else merge_col_groups
        out = merge(parts, a.index.row_block_sizes, b.index.col_block_sizes,
                    name="tas_subgrid", dtype=a.dtype, device=a.device)
    if return_flops:
        return out, eff
    return out
