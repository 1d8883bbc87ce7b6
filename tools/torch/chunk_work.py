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

    python tools/torch/chunk_work.py [--config PATH] [--replicas X Y Z] [--grid P Q]
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


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


def count(cfg: dict) -> dict:
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.mm.f64_stack import MMA_DEPTH, chunked_hw_flops, tile_chunk_masks
    from dbcsr_tpu_torch.mm.plan import symbolic_product
    from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores

    tile = int(cfg["tile"])
    index, _ = pattern_index(cfg)
    lay = store_layout(index, tile)
    grid = (lay.ntr, lay.ntc)
    stack = plan_tile_stacks_stores(lay.tile_coords, grid, lay.tile_coords, grid).stack
    rows, cols = tile_chunk_masks(index, tile)
    eff = float(symbolic_product(index, False, index, False).eff_flops)
    res = {"config": cfg["name"], "replicas": cfg.get("replicas"), "tile": tile,
           "blocks": int(index.nblks), "tiles": int(lay.n_tiles), "entries": int(len(stack)),
           "eff_flops": eff, "work": {}, "tile_util_pct": {}}
    works = {"tile": 2.0 * len(stack) * tile**3}
    for deep in (16, MMA_DEPTH):
        per = deep // MMA_DEPTH
        works[f"skip{deep}"] = chunked_hw_flops(fold(cols, per), fold(rows, per),
                                                stack[:, 1], stack[:, 2], tile, deep)
    for k, w in works.items():
        res["work"][k] = w
        res["tile_util_pct"][k] = 100.0 * eff / w if w else None
    return res


def count_grid(cfg: dict, p: int, q: int) -> dict:
    import torch

    from dbcsr_tpu_torch.block.bcsr import BCSRMatrix
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.dist import ProcessGrid, tile_aligned_dist
    from dbcsr_tpu_torch.mm.engine import build_distributed_executor
    from dbcsr_tpu_torch.mm.filtered import _rank_eff_flops

    tile = int(cfg["tile"])
    index, sizes = pattern_index(cfg)
    n = store_layout(index, tile).n_tiles
    # the build reads the stores' shape and type only
    data = torch.zeros((1, 1, 1), dtype=torch.float64).expand(n, tile, tile)
    a = BCSRMatrix(name="A", index=index, data=data)
    grid = ProcessGrid.make(p, q, devices=[torch.device("cpu")] * (p * q))
    dist = tile_aligned_dist(grid, sizes, sizes, tile)
    fn, c_index, eff = build_distributed_executor("N", "N", a, a, dist, sharded=True)
    rank_eff = _rank_eff_flops(a, False, a, False, fn.dist_plan).reshape(-1)
    works = {"tile": fn.plan.padded_flops.reshape(p * q, -1).sum(axis=1),
             "skip8": fn.plan.hw_flops.reshape(p * q, -1).sum(axis=1)}
    ranks = []
    for d in range(p * q):
        ranks.append({"rank": [d // q, d % q], "eff_flops": float(rank_eff[d]),
                      "work": {k: float(w[d]) for k, w in works.items()},
                      "tile_util_pct": {k: 100.0 * rank_eff[d] / w[d] if w[d] else None
                                        for k, w in works.items()}})
    return {"config": cfg["name"], "replicas": cfg.get("replicas"), "tile": tile,
            "grid": [p, q], "blocks": int(index.nblks), "tiles": int(n),
            "entries": int(fn.plan.n_stack), "eff_flops": float(eff),
            "work": {k: float(w.sum()) for k, w in works.items()}, "ranks": ranks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "benchmark", "configs",
                                                      "water_2048.json"))
    ap.add_argument("--replicas", type=int, nargs=3, default=None,
                    help="cells along each axis in place of the configuration's")
    ap.add_argument("--grid", type=int, nargs=2, default=None, metavar=("P", "Q"),
                    help="count each rank's share over a P x Q Cannon grid")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    if args.replicas is not None:
        cfg["replicas"] = list(args.replicas)
    res = count(cfg) if args.grid is None else count_grid(cfg, *args.grid)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
