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
  kernels every unfiltered multiply uses) → per-block Frobenius norms² as
  indicator matmuls + an ordered segment sum → keep = norms² >= eps² →
  the keep mask zeroing dropped blocks. Data may change every call.

Equivalence to ``multiply(filter_eps=...)`` with ``filter_mode="sum"`` (the
default): a C block is pre-dropped there iff
``sum_k |A_ik|^2 |B_kj|^2 < (eps/row_nk)^2``; by Cauchy-Schwarz
``|C_ij|_F <= sum_k |A_ik||B_kj| < eps`` then, so every pre-dropped block is
one the final filter removes anyway. The superset product with only the
final filter therefore keeps the same blocks (up to exact-boundary ties)
with the same values.

The result stays in MASK form: C's superset index with dropped blocks
zeroed (padding and dropped positions exactly 0), so it feeds the next
step with no conversion. ``compact()`` builds the pruned ``BCSRMatrix``.
The JAX package composes ``step`` under jit/scan; here a Python loop of
steps is the equivalent (each step only enqueues device work).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..block.bcsr import BCSRMatrix
from ..block.index import BCSRIndex, build_index
from ..block.store import store_layout
from ..block.tileops import (
    block_mask_store,
    device_block_info,
    per_tile_block_sums,
    take_tiles,
    tile_align_map,
)
from ..core.errors import dbcsr_assert
from ..core.timing import timed

__all__ = ["FilteredExecutor", "build_filtered_executor"]


@dataclass
class FilteredExecutor:
    """Plan-once eps-filtered multiply over fixed operand patterns.

    ``step(a_data, b_data) -> (c_data, keep, norms_sq)``: ``c_data`` is the
    product in C's SUPERSET store layout with blocks of Frobenius norm <
    eps zeroed, ``keep`` the float32 0/1 vector over superset blocks,
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
        c_sup = self.fn(a_data, b_data)
        nblks = self.c_index.nblks
        if nblks == 0:
            empty = torch.zeros(0, dtype=torch.float32, device=c_sup.device)
            return c_sup, empty, empty
        with timed("filtered/norms"):
            info = device_block_info(self.c_index, self.tile, c_sup.device)
            nsq = info.block_sum(per_tile_block_sums(c_sup, info).reshape(-1))
        with timed("filtered/mask"):
            # eps² rounded to float32 as the reference's single-precision
            # norms; a Python scalar needs no host-to-device copy
            keep = (nsq >= float(np.float32(self.eps) ** 2)).to(torch.float32)
            mask = block_mask_store(self.c_index, self.tile, c_sup.device, keep=keep)
            c_data = c_sup * mask.to(c_sup.dtype)
        return c_data, keep, nsq

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
) -> FilteredExecutor:
    """Plan the eps-filtered multiply ``C = op(A)·op(B), |C_blk| >= eps``
    for repeated execution with CHANGING data over fixed patterns — the
    analog of the reference's batched-multiply state machine wrapped around
    its filtered multiply (linear-scaling SCF's inner loop)."""
    from ..ops.transform import desymmetrize
    from .engine import build_multiply_executor

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
            # the indicator structure goes to the device at plan time, not in step
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
