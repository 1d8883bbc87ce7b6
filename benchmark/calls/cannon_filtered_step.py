"""``build_filtered_executor("N", "N", A, B, eps, dist=...).step`` over the
configuration's process grid (one rank a process and a card), sharded at
rest, on new A data each step: B's shards are fixed at set-up; each step
cuts this process's A shards from the step's A store (``sharded/cut``, a
device gather of about a quarter of A), runs the Cannon ticks into this
process's C shards, takes their block norms and zeroes the dropped blocks.
The output is this process's C tiles (``shards.Held``), judged per process
against the plain reference (``reference/shards.py``)."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import products
from benchmark.operands import dtype_of
from benchmark.reference.layout import tile_keys, write_rows
from benchmark.reference.product import sq, superset
from benchmark.reference.shards import Held, RowsProduct, held_block_err

COMPARED = products.COMPARED


def _world() -> tuple:
    """(this process, processes) of the run."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


class _Out:
    """A step's output: this process's C tiles on its card, and their host
    copy once the judge asks for it."""

    def __init__(self, c: torch.Tensor):
        self.c, self.host = c, None


class Program:
    def __init__(self, cfg, ops, grid=None):
        import dbcsr_tpu_torch as dt
        from dbcsr_tpu_torch.dist import ProcessGrid, tile_aligned_dist
        from dbcsr_tpu_torch.dist.sharded import plane_owners

        a, b = products.matrices(cfg, ops)
        if grid is None:  # one process: the grid's ranks are virtual, on its card
            shape = cfg["grid"]
            grid = ProcessGrid.make(*shape, devices=[ops.b.device] * int(np.prod(shape)))
        rbs = a.row_block_sizes
        self.ex = dt.build_filtered_executor(
            "N", "N", a, b, float(cfg["eps"]),
            dist=tile_aligned_dist(grid, rbs, rbs, int(cfg["tile"])))
        self.a, self.grid = a, grid
        me = _world()[0]
        sl = self.ex.shard_c
        c_keys = products.blocks_of(self.ex.c_index, ops.pattern)
        c_keys = tile_keys(c_keys, int(cfg["tile"]))
        counts = np.bincount(sl.owner_of_slot, minlength=sl.ndev)
        per_rank = [c_keys[sl.slot_of_pos[d * sl.n_max:d * sl.n_max + counts[d]]]
                    for d in range(sl.ndev)]
        self.local = [(d, int(counts[d])) for d, o in enumerate(plane_owners(grid))
                      if o == me]
        self.held = Held(keys=np.concatenate([per_rank[d] for d, _ in self.local]),
                         ranks=per_rank if me == 0 else None)

    def __call__(self, a_data):
        from dbcsr_tpu_torch.dist.sharded import shard_store_with_layout

        a_sh = shard_store_with_layout(self.a.with_data(a_data), self.ex.shard_a, self.grid)
        c = self.ex.step(a_sh)[0]
        mine = [c[d][:n] for d, n in self.local]
        return _Out(mine[0] if len(mine) == 1 else torch.cat(mine))

    def output(self, out):
        """This process's C tiles in host memory, copied once a call. The
        harness pauses each process's clock for its own copy only; the
        copies differ in size and speed between processes, so every
        process leaves the copy together (a barrier), and no process's
        next step waits out another's copy."""
        from dbcsr_tpu_torch.dist import comm

        if out.host is None:
            out.host = out.c.to("cpu")
            comm.barrier()
        return self.held, out.host

    def release(self) -> None:
        self.ex = None


def judge(cfg, ops):
    ref = RowsProduct(ops.pattern, ops.keys, ops.b, dtype_of(cfg["dtype"]))
    eps, tie = float(cfg["eps"]), float(cfg.get("norm_tie_rel", 0.0))

    def err(a_store, held, store):
        return held_block_err(ref, a_store, held, store, eps, tie)

    return err


def held_keys(cfg, pattern) -> Held:
    """This process's C tiles under the deployment's layout, worked out
    without the program: the tile-aligned distribution deals tile rows and
    tile columns round-robin over the grid's rows and columns, and the grid's
    ranks round-robin over the processes."""
    p, q = (int(x) for x in cfg["grid"])
    me, nprocs = _world()
    keys = tile_keys(superset(pattern), int(cfg["tile"]))
    nt = -(-int(pattern.row_sizes.sum()) // int(cfg["tile"]))
    rank = (keys // nt % p) * q + keys % nt % q
    ranks = [keys[rank == d] for d in range(p * q)]
    mine = [d for d in range(p * q) if d % nprocs == me]
    return Held(keys=np.sort(np.concatenate([ranks[d] for d in mine])),
                ranks=ranks if me == 0 else None)


class Control:
    """The reference in ``cfg["control_dtype"]`` in the program's place:
    this process's C tiles of the superset product, block norms in that
    type over whole blocks, the keep mask."""

    def __init__(self, cfg, ops):
        self.ref = RowsProduct(ops.pattern, ops.keys, ops.b, dtype_of(cfg["control_dtype"]))
        self.out_dtype = ops.b.dtype
        self.eps = float(cfg["eps"])
        self.held = held_keys(cfg, ops.pattern)
        self.sup = superset(ops.pattern)

    def __call__(self, a_store):
        from benchmark.reference.judge import listed

        ref, tile = self.ref, self.ref.tile
        acc = ref.zeros()
        for _, ri, r in ref.rows(a_store):
            ref.sums_into(acc, sq(r), ri)
        keep = acc >= float(torch.tensor(self.eps, dtype=ref.real) ** 2)
        mask = listed(self.sup, ref.nb, ref.dev) & keep
        keys = self.held.keys  # sorted
        store = torch.zeros((len(keys), tile, tile), dtype=self.out_dtype, device=ref.dev)
        for t0, ri, r in ref.rows(a_store):
            write_rows(store, keys, ref.nt, t0, r * mask[ref.owner[ri]][:, ref.owner])
        return store

    def output(self, out):
        return self.held, out

    def release(self) -> None:
        self.ref = None
