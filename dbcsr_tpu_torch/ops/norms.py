"""Per-block norms and matrix-level norms.

Port of ``dbcsr_tpu/ops/norms.py``: per-block squared Frobenius norms feed
epsilon filtering (``src/mm/dbcsr_mm_common.F:629-694``, GPU variant
``calculate_norms.cpp``); matrix norms frobenius / maxabs / column /
gershgorin mirror ``dbcsr_types.F:231-234`` + ``src/ops/dbcsr_operations.F``.
Per-block sums on a tile store run per tile over its atom-block cells
(``block/tileops.py``: a hand-written kernel on a card, two small indicator
matmuls elsewhere); per-tile row/column sums are combined across tiles by
an ordered segment sum (deterministic on the GPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.tileops import block_sums_sq, ordered_segment_sum, squares
from .transform import desymmetrize

__all__ = [
    "block_norms_sq",
    "block_norms",
    "norm_frobenius",
    "norm_maxabs",
    "norm_gershgorin",
    "norm_column",
]


def block_norms_sq(m: BCSRMatrix) -> np.ndarray:
    """Squared Frobenius norm per stored block, float32 host [nblks]
    (single-precision norms like the reference,
    ``src/mm/dbcsr_mm_common.F:629``).

    Memoized per matrix object against its tile store: a filtered multiply
    reads operand norms every call and the final filter re-reads the
    product's — identical data must not pay the device reduction and the
    transfer twice. The result is read-only because it is shared."""
    memo = getattr(m, "_norms_sq_memo", None)
    if memo is not None and memo[0] is m.data:
        return memo[1]
    out = block_sums_sq(m.index, m.tile, m.data)
    out.flags.writeable = False
    object.__setattr__(m, "_norms_sq_memo", (m.data, out))
    return out


def block_norms(m: BCSRMatrix) -> np.ndarray:
    return np.sqrt(block_norms_sq(m).astype(np.float64)).astype(np.float32)


def norm_frobenius(m: BCSRMatrix) -> float:
    if m.sym != SYM_NONE:
        # Off-diagonal stored blocks count twice. Diagonal blocks follow
        # desymmetrize's shadowing convention: the strictly-lower interior
        # is replaced by the reflected upper triangle, so it contributes
        # 2*||triu(b,1)||^2 + ||diag(b)||^2 — stored strictly-lower
        # elements of diagonal blocks are ignored, and
        # norm_frobenius(m) == norm_frobenius(desymmetrize(m)).
        nsq = block_norms_sq(m).astype(np.float64)
        idx = m.index
        diag = idx.blk_rows == idx.col_idx
        off_sum = nsq[~diag].sum()
        diag_ids = np.flatnonzero(diag)
        diag_sum = 0.0
        if len(diag_ids):
            host = m.flat_host()
            _, bn = idx.blk_shapes
            spans = np.concatenate(
                [np.arange(idx.blk_offset[b], idx.blk_offset[b + 1]) for b in diag_ids]
            )
            b_of = idx.elem_to_blk[spans]
            off_in_blk = spans - idx.blk_offset[b_of]
            ncols = bn[b_of].astype(np.int64)
            r_loc = off_in_blk // ncols
            c_loc = off_in_blk % ncols
            w = np.where(r_loc < c_loc, 2.0, np.where(r_loc == c_loc, 1.0, 0.0))
            vals = host[spans]
            diag_sum = float(((vals * np.conj(vals)).real.astype(np.float64) * w).sum())
        return float(np.sqrt(2.0 * off_sum + diag_sum))
    if m.data.numel() == 0:
        return 0.0
    # padding positions are exactly 0, so the raw store sum is the norm
    return float(torch.sqrt(torch.sum(squares(m.data))))


def norm_maxabs(m: BCSRMatrix) -> float:
    if m.data.numel() == 0:
        return 0.0
    return float(m.data.abs().max())


def _max_line_sum(m: BCSRMatrix, axis: int) -> float:
    """max over global rows (axis=2: sums along each tile row, combined per
    tile row) or columns (axis=1) of Σ|a|, on the symmetry-expanded
    matrix."""
    mm = desymmetrize(m)
    if mm.data.numel() == 0:
        return 0.0
    lay = mm.layout
    s = mm.data.abs().sum(dim=axis)  # [n_tiles, T]
    coord = lay.tile_coords[:, 0 if axis == 2 else 1]
    n_seg = lay.ntr if axis == 2 else lay.ntc
    return float(ordered_segment_sum(coord, n_seg, mm.device)(s).max())


def norm_column(m: BCSRMatrix) -> float:
    """Matrix 1-norm: max over columns of sum_i |a_ij| (the reference's
    column norm, ``dbcsr_norm_column``)."""
    return _max_line_sum(m, axis=1)


def norm_gershgorin(m: BCSRMatrix) -> float:
    """Gershgorin-circle bound: max over rows of sum_j |a_ij| (on the
    symmetry-expanded matrix)."""
    return _max_line_sum(m, axis=2)
