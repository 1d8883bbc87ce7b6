"""What the block-product calls (``calls/*.py``) share: the program's
matrices over the benchmark's stores, their judge against the plain
reference, and their control, the reference in the program's place one
precision below the configuration's (``control_dtype``), norms and keep
decisions included.

A call module gives ``Program(cfg, ops, grid)`` (set up once; called with
one A store a step; ``output(out)`` hands back the block list and tile
store that the judge reads; ``release()`` frees its state), ``COMPARED``
(the name of the number compared), ``judge(cfg, ops)`` (a function of an A
store and an output's block list and store, giving that number) and
``Control(cfg, ops)`` (shaped as ``Program``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .operands import Operands, dtype_of
from .reference.judge import block_err, listed
from .reference.layout import Blocks, tile_keys, write_rows
from .reference.product import Product, sq, superset

COMPARED = "block_err"


def matrices(cfg: dict, ops: Operands):
    """The program's A and B over the benchmark's stores; the program's
    store layout has to be the benchmark's."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout

    p = ops.pattern
    rbs = p.row_sizes.astype(np.int32)
    idx, order = dt.build_index(p.rows, p.cols, rbs, p.col_sizes.astype(np.int32))
    if not np.array_equal(order, np.arange(p.n)):
        raise RuntimeError("the pattern is not in the program's canonical order")
    if not np.array_equal(store_layout(idx, int(cfg["tile"])).tile_keys(), ops.keys):
        raise RuntimeError("the program's store layout differs from the benchmark's")
    return (dt.BCSRMatrix(name="A", index=idx, data=ops.a[0]),
            dt.BCSRMatrix(name="B", index=idx, data=ops.b))


def blocks_of(index, like: Blocks) -> Blocks:
    """The block list of one of the program's indices."""
    return Blocks(rows=np.asarray(index.blk_rows, dtype=np.int64),
                  cols=np.asarray(index.col_idx, dtype=np.int64),
                  row_sizes=like.row_sizes, col_sizes=like.col_sizes)


def judge(cfg: dict, ops: Operands, filtered: bool):
    """``block_err`` of an output against the reference in the
    configuration's type, worked out from the benchmark's own stores."""
    ref = Product(ops.pattern, ops.keys, ops.b, dtype_of(cfg["dtype"]))
    eps = float(cfg["eps"]) if filtered else None
    tie = float(cfg.get("norm_tie_rel", 0.0))

    def err(a_store: torch.Tensor, out: Blocks, store: torch.Tensor) -> float:
        return block_err(ref, a_store, out, store, eps, tie)

    return err


class Control:
    """The reference in ``cfg["control_dtype"]`` in the program's place:
    C's superset product, block norms in that type, the keep mask; C in
    mask form over the superset, or compacted to the kept blocks."""

    def __init__(self, cfg: dict, ops: Operands, filtered: bool, compact: bool):
        self.ref = Product(ops.pattern, ops.keys, ops.b, dtype_of(cfg["control_dtype"]))
        self.out_dtype = ops.b.dtype
        self.c = superset(ops.pattern)
        self.filtered, self.compact = filtered, compact
        self.eps = float(cfg["eps"])

    def __call__(self, a_store: torch.Tensor) -> Tuple[Blocks, torch.Tensor]:
        ref, tile, nb = self.ref, self.ref.tile, self.ref.nb
        keep: Optional[torch.Tensor] = None
        if self.filtered:
            acc = torch.zeros((nb + 1, nb + 1), dtype=ref.real, device=ref.dev)
            for t0, r in ref.rows(a_store):
                acc += ref.sums(sq(r), t0)
            thr = float(torch.tensor(self.eps, dtype=ref.real) ** 2)
            keep = acc >= thr
        c = self.c
        if self.compact and keep is not None:
            on = keep[torch.as_tensor(c.rows, device=ref.dev),
                      torch.as_tensor(c.cols, device=ref.dev)].cpu().numpy()
            c = Blocks(rows=c.rows[on], cols=c.cols[on], row_sizes=c.row_sizes,
                       col_sizes=c.col_sizes)
        keys = tile_keys(c, tile)
        store = torch.zeros((len(keys), tile, tile), dtype=self.out_dtype, device=ref.dev)
        mask = listed(c, nb, ref.dev)
        if keep is not None:
            mask &= keep
        for t0, r in ref.rows(a_store):
            own = ref.owner[t0 * tile: t0 * tile + r.shape[0]]
            write_rows(store, keys, ref.nt, t0, r * mask[own][:, ref.owner])
        return c, store

    @staticmethod
    def output(out):
        return out

    def release(self) -> None:
        self.ref = None
