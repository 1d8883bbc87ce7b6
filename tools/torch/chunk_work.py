"""The float64 stack kernel's work on a benchmark configuration's pattern,
counted on the host from the block index alone (no data, no device): the
tile products the plan issues at 2·T³ an entry, and what is left when the
kernel skips the K chunks that an entry's A and B tiles leave empty, at
16-deep chunks (a ``cp.async`` chunk of the ring) and at 8-deep ones (one
mma depth, what the kernel skips: ``mm/f64_stack.py``). Each figure comes
with the share of it that the product's effective flops fill, which is
what ``kernel.tile_util`` reads on the card (effective over issued) at
``skip8``.

With ``--grid P Q`` it counts the same over a P × Q Cannon grid (the
tile-aligned distribution, as the benchmark's four-card cell runs it): the
program's own sharded ``build_distributed_executor`` plans the ranks' ticks
on CPU ranks, and each plane rank gets the flops its ticks issue unmasked
(``tile``, 2·T³ an entry) and at 8-deep masks (``skip8``, what the float64
kernel issues there), with its effective flops (the C elements it owns) and
their share of each. No store is made: A and B are stride-0 views.

A and B share the configuration's pattern, as in the benchmark's SCF step
A·B. The pattern comes through ``benchmark.operands.pattern_of(cfg)``
alone: the one entry point into the benchmark that this tool, ``span_cost.py``
and the port's tests read, whose interface a change of the benchmark keeps.
Both also count the runs that the float64 kernel's segment plan
(``mm/f64_stack.py``) would cut on ``--sms`` SMs where the cut pays
(``split_runs``: of the one launch, or of each rank's (rank, tick)
launches).

With ``--ri`` it counts the RI-HFX exchange step of an RI configuration
(``benchmark/calls/rihfx_step.py``, default ``rihfx_water_64.json``): for
each batch of RI atoms, the two products the step multiplies, X = B·D over
the batch's P and K += X·B over the batch's (σ, P), planned by the
program's own planner (``engine._plan_local``) over the same folds,
windows and refold, from the block index alone. For each it prints the
issued work, the C tiles and entries, the longest and mean run's issued
work, and the makespan of a list schedule of the launch's blocks (in
launch order, each to the SM that frees first) over ``--sms`` SMs at
``--sm-gflops`` each: with one block a run, with the segment plan's
blocks, and perfectly balanced. The default rate is what the water cell's
kernel issues an SM (4,044 GFLOP in 100.4 ms on 132 SMs, PERF.md §5).

    python tools/torch/chunk_work.py [--config PATH] [--replicas X Y Z] [--grid P Q]
    python tools/torch/chunk_work.py --ri [--config PATH] [--sms 132] [--sm-gflops 305.1]
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


#: the float64 kernel's issued rate an SM on the water cell (4,044 GFLOP in
#: 100.4 ms on 132 SMs), GFLOP/s
SM_GFLOPS = 4044.0 / 0.1004 / 132
#: an H100 SXM's SMs
SMS = 132


def fold(masks: np.ndarray, depths: int) -> np.ndarray:
    """Masks of 8-deep bits -> masks of chunks ``depths`` bits wide (a chunk
    bit is set iff any of its depths is)."""
    m = masks.astype(np.int64)
    out = np.zeros_like(m)
    for c in range(32 // depths):
        group = (m >> (c * depths)) & ((1 << depths) - 1)
        out |= (group != 0).astype(np.int64) << c
    return out


def pattern_index(cfg: dict):
    """The configuration's block index (A's and B's) and block sizes."""
    from benchmark.operands import pattern_of
    from dbcsr_tpu_torch.block.index import build_index

    blocks = pattern_of(cfg).blocks
    sizes = blocks.row_sizes.astype(np.int32)
    index, _ = build_index(blocks.rows.astype(np.int32), blocks.cols.astype(np.int32),
                           sizes, blocks.col_sizes.astype(np.int32))
    return index, sizes


def count(cfg: dict, sms: int = SMS) -> dict:
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.mm.f64_stack import (
        MMA_DEPTH,
        chunked_hw_flops,
        entry_depths,
        tile_chunk_masks,
    )
    from dbcsr_tpu_torch.mm.plan import symbolic_product
    from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores

    tile = int(cfg["tile"])
    index, _ = pattern_index(cfg)
    lay = store_layout(index, tile)
    grid = (lay.ntr, lay.ntc)
    tplan = plan_tile_stacks_stores(lay.tile_coords, grid, lay.tile_coords, grid)
    stack = tplan.stack
    rows, cols = tile_chunk_masks(index, tile)
    c_ptr = np.searchsorted(stack[:, 0], np.arange(tplan.n_c_tiles + 1))
    seg = cut(c_ptr, entry_depths(cols, rows, stack[:, 1], stack[:, 2]), tile, sms)
    eff = float(symbolic_product(index, False, index, False).eff_flops)
    res = {"config": cfg["name"], "replicas": cfg.get("replicas"), "tile": tile,
           "blocks": int(index.nblks), "tiles": int(lay.n_tiles), "entries": int(len(stack)),
           "eff_flops": eff, "work": {}, "tile_util_pct": {},
           "split_runs": 0 if seg is None else int(len(seg[2]))}
    works = {"tile": 2.0 * len(stack) * tile**3}
    for deep in (16, MMA_DEPTH):
        per = deep // MMA_DEPTH
        works[f"skip{deep}"] = chunked_hw_flops(fold(cols, per), fold(rows, per),
                                                stack[:, 1], stack[:, 2], tile, deep)
    for k, w in works.items():
        res["work"][k] = w
        res["tile_util_pct"][k] = 100.0 * eff / w if w else None
    return res


def cut(c_ptr: np.ndarray, depths: np.ndarray, tile: int, sms: int):
    """The run segments the program launches a masked stack with on ``sms``
    SMs (``f64_stack.f64_device_stack``): the plan where the cut pays, else
    None (one segment a run)."""
    from dbcsr_tpu_torch.mm.f64_stack import plan_run_segments, split_pays

    seg = plan_run_segments(c_ptr, depths, sms)
    return seg if seg is not None and split_pays(c_ptr, depths, seg, tile, sms) else None


def launch_counts(ds, tile: int, sms: int, sm_gflops: float) -> dict:
    """Issued work, runs and schedules of one float64 stack launch
    (``DeviceStack`` with its K masks)."""
    from dbcsr_tpu_torch.mm.f64_stack import MMA_DEPTH, entry_depths, list_makespan

    depths = entry_depths(ds.a_chunks.numpy(), ds.b_chunks.numpy(), ds.a_idx.numpy(),
                          ds.b_idx.numpy())
    work = depths * (2.0 * tile * tile * MMA_DEPTH)
    cw = np.concatenate(([0.0], np.cumsum(work)))
    c_ptr = ds.c_ptr_host
    run_w = cw[c_ptr[1:]] - cw[c_ptr[:-1]]
    seg = cut(c_ptr, depths, tile, sms)
    seg_ptr = c_ptr if seg is None else seg[0]
    seg_w = cw[seg_ptr[1:]] - cw[seg_ptr[:-1]]
    ms = 1e3 / (sm_gflops * 1e9)
    return {"issued_gflop": cw[-1] / 1e9, "c_tiles": int(ds.n_c), "entries": int(len(work)),
            "longest_run_gflop": float(run_w.max()) / 1e9,
            "mean_run_gflop": float(run_w.mean()) / 1e9,
            "split_runs": 0 if seg is None else int(len(seg[2])),
            "segments": int(len(seg_w)),
            "makespan_ms": {"one_block_a_run": list_makespan(run_w, sms) * ms,
                            "segments": list_makespan(seg_w, sms) * ms,
                            "balanced": cw[-1] / sms * ms}}


def _window(matrix, rows):
    """``matrix`` cut to the block rows ``rows`` (ascending), index alone:
    ``tas.matrix.extract_block_subset``'s index without its gather."""
    from dbcsr_tpu_torch.block.index import build_index

    idx = matrix.index
    rmap = np.full(idx.nblkrows, -1, dtype=np.int64)
    rmap[rows] = np.arange(len(rows))
    keep = rmap[idx.blk_rows] >= 0
    new, _ = build_index(rmap[idx.blk_rows[keep]], idx.col_idx[keep].astype(np.int64),
                         idx.row_block_sizes[rows], idx.col_block_sizes)
    return _index_only(new, matrix.tile)


def _index_only(index, tile: int):
    """A float64 matrix over ``index`` whose store is a stride-0 view: the
    planners read its shape and type alone."""
    import torch

    from dbcsr_tpu_torch.block.bcsr import BCSRMatrix
    from dbcsr_tpu_torch.block.store import store_layout

    n = store_layout(index, tile).n_tiles
    data = torch.zeros((1, 1, 1), dtype=torch.float64).expand(n, tile, tile)
    return BCSRMatrix(name="M", index=index, data=data)


def count_ri(cfg: dict, sms: int = SMS, sm_gflops: float = SM_GFLOPS) -> dict:
    """Both products of every batch of an RI-HFX step (module docstring)."""
    from benchmark.calls import rihfx_step
    from benchmark.reference import ri_hfx as ri
    from dbcsr_tpu_torch.block.index import build_index
    from dbcsr_tpu_torch.core.config import get_config
    from dbcsr_tpu_torch.mm.engine import _plan_local
    from dbcsr_tpu_torch.mm.plan import symbolic_product
    from dbcsr_tpu_torch.tensors import NDMapping, Tensor, copy_tensor
    from dbcsr_tpu_torch.tensors.contract import _blockdim_range, _fold_keep, _own_cuts
    from dbcsr_tpu_torch.tensors.tensor import refold_layout

    tile = int(cfg["tile"])
    conf = get_config()
    pat = rihfx_step.ri_pattern(cfg)
    rows, cols, rs, cs = ri.fold_blocks(pat)
    b_index, _ = build_index(rows, cols, rs.astype(np.int32), cs.astype(np.int32))
    ao, rib = pat.ao.astype(np.int32), pat.ri.astype(np.int32)
    b = Tensor(name="B", block_sizes=(ao, ao, rib), mapping=NDMapping(3, (0, 2), (1,)),
               matrix=_index_only(b_index, tile))
    bt = copy_tensor(b, order=(1, 0, 2), name="Bt")
    d_index, _ = pattern_index(cfg)
    d = _index_only(d_index, tile)

    def plan(ma, mb):
        lp = _plan_local(ma, False, mb, False, conf, conf.mm_driver, may_reorder=True)
        if lp.route != "f64_stack":
            raise RuntimeError(f"the product took the {lp.route} route, not the float64 kernel")
        return lp

    out = []
    for lo, hi in rihfx_step.element_ranges(pat, int(cfg["n_batches"])):
        # X = B·D: B's (μ, P) rows of the batch, D whole; X over its superset
        cut, _ = _own_cuts(b, {2: (lo, hi)}, "B")
        ma = _window(b.matrix, _fold_keep(b, (0, 2), cut))
        lp_x = plan(ma, d)
        symb = symbolic_product(ma.index, False, d.index, False)
        x_index, _ = build_index(symb.rows, symb.cols, ma.index.row_block_sizes,
                                 d.index.col_block_sizes)
        rib_cut = rib[_blockdim_range(rib, lo, hi)]
        x = Tensor(name="X", block_sizes=(ao, ao, rib_cut), mapping=NDMapping(3, (0, 2), (1,)),
                   matrix=_index_only(x_index, tile), offsets=(0, 0, lo))
        # K += X·B: X refolded to (μ | (σ, P)), B's (σ, P) rows of the batch
        x2_index, _ = refold_layout(x, NDMapping(3, (0,), (1, 2)))
        cut, _ = _own_cuts(bt, {2: (lo, hi)}, "B")
        lp_k = plan(_index_only(x2_index, tile), _window(bt.matrix, _fold_keep(bt, (1, 2), cut)))
        out.append({"p_elements": [lo, hi],
                    "X": launch_counts(lp_x.stack, tile, sms, sm_gflops),
                    "K": launch_counts(lp_k.stack, tile, sms, sm_gflops)})
    total = {k: {"issued_gflop": sum(o[k]["issued_gflop"] for o in out),
                 "makespan_ms": {m: sum(o[k]["makespan_ms"][m] for o in out)
                                 for m in ("one_block_a_run", "segments", "balanced")}}
             for k in ("X", "K")}
    return {"config": cfg["name"], "tile": tile, "sms": sms, "sm_gflops": sm_gflops,
            "batches": out, "step": total}


def count_grid(cfg: dict, p: int, q: int, sms: int = SMS) -> dict:
    import torch

    from dbcsr_tpu_torch.dist import ProcessGrid, tile_aligned_dist
    from dbcsr_tpu_torch.mm.engine import build_distributed_executor
    from dbcsr_tpu_torch.mm.filtered import _rank_eff_flops

    tile = int(cfg["tile"])
    index, sizes = pattern_index(cfg)
    a = _index_only(index, tile)
    grid = ProcessGrid.make(p, q, devices=[torch.device("cpu")] * (p * q))
    dist = tile_aligned_dist(grid, sizes, sizes, tile)
    fn, c_index, eff = build_distributed_executor("N", "N", a, a, dist, sharded=True)
    rank_eff = _rank_eff_flops(a, False, a, False, fn.dist_plan).reshape(-1)
    works = {"tile": fn.plan.padded_flops.reshape(p * q, -1).sum(axis=1),
             "skip8": fn.plan.hw_flops.reshape(p * q, -1).sum(axis=1)}
    split = np.zeros(len(fn.plan.ticks), np.int64)
    for r, per in enumerate(fn.plan.ticks):
        for ts in per:
            if ts is not None and ts.stack.a_chunks is not None:
                split[r] += launch_counts(ts.stack, tile, sms, SM_GFLOPS)["split_runs"]
    split = split.reshape(p * q, -1).sum(axis=1)
    ranks = []
    for d in range(p * q):
        ranks.append({"rank": [d // q, d % q], "eff_flops": float(rank_eff[d]),
                      "work": {k: float(w[d]) for k, w in works.items()},
                      "tile_util_pct": {k: 100.0 * rank_eff[d] / w[d] if w[d] else None
                                        for k, w in works.items()},
                      "split_runs": int(split[d])})
    return {"config": cfg["name"], "replicas": cfg.get("replicas"), "tile": tile,
            "grid": [p, q], "blocks": int(index.nblks), "tiles": int(a.data.shape[0]),
            "entries": int(fn.plan.n_stack), "eff_flops": float(eff),
            "work": {k: float(w.sum()) for k, w in works.items()}, "ranks": ranks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None,
                    help="a benchmark configuration (default water_2048.json)")
    ap.add_argument("--replicas", type=int, nargs=3, default=None,
                    help="cells along each axis in place of the configuration's")
    ap.add_argument("--grid", type=int, nargs=2, default=None, metavar=("P", "Q"),
                    help="count each rank's share over a P x Q Cannon grid")
    ap.add_argument("--ri", action="store_true",
                    help="count an RI-HFX step's products batch by batch (default config "
                         "rihfx_water_64.json)")
    ap.add_argument("--sms", type=int, default=SMS, help="SMs of the schedules and segment plans")
    ap.add_argument("--sm-gflops", type=float, default=SM_GFLOPS,
                    help="the kernel's issued rate an SM, GFLOP/s")
    args = ap.parse_args(argv)
    if args.config is None:
        args.config = os.path.join(REPO, "benchmark", "configs",
                                   "rihfx_water_64.json" if args.ri else "water_2048.json")
    with open(args.config) as f:
        cfg = json.load(f)
    if args.replicas is not None:
        cfg["replicas"] = list(args.replicas)
    if args.ri:
        res = count_ri(cfg, args.sms, args.sm_gflops)
    elif args.grid is not None:
        res = count_grid(cfg, *args.grid, sms=args.sms)
    else:
        res = count(cfg, args.sms)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
