"""Scalar-CSR interop: BCSR <-> element-granular CSR conversion.

Port of ``dbcsr_tpu/ops/csr.py`` (reference
``src/ops/dbcsr_csr_conversions.F:115-156``: ``convert_dbcsr_to_csr``,
``convert_csr_to_dbcsr``, ``dbcsr_to_csr_filter``, ``csr_write``). The
exchange format is ``scipy.sparse.csr_matrix`` on the host, with explicit
zeros kept so the blocked structure round-trips.

``from_csr`` is vectorised: every stored CSR element is placed into the
flat block layout by array arithmetic (block by ``searchsorted``, position
inside the block, block offset) where the JAX package slices one block at a
time in a Python loop; the blocks are the same, explicit zeros and
``keep_zero_blocks`` included. ``csr_write`` keeps its text loop (it is for
small matrices).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..block.bcsr import BCSRMatrix
from ..block.index import build_index
from ..core.errors import dbcsr_assert
from ..core.timing import timed
from .transform import desymmetrize

__all__ = ["to_csr", "from_csr", "to_csr_filter", "csr_write"]


def to_csr(m: BCSRMatrix) -> sp.csr_matrix:
    """Element-granular CSR of the full matrix (``convert_dbcsr_to_csr``).
    Stored blocks are kept verbatim (explicit zeros inside blocks survive,
    matching the reference's block-granular nonzero structure)."""
    m = desymmetrize(m)
    idx = m.index
    host = m.flat_host()
    if idx.nblks == 0:
        return sp.csr_matrix((idx.nfullrows, idx.nfullcols), dtype=host.dtype)
    with timed("to_csr"):
        bm, bn = idx.blk_shapes
        # element coordinates per flat data slot (row-major inside each block)
        b = idx.elem_to_blk.astype(np.int64)
        t = np.arange(idx.nelems, dtype=np.int64) - idx.blk_offset[b]
        er = idx.row_offsets[idx.blk_rows[b]] + t // bn[b]
        ec = idx.col_offsets[idx.col_idx[b]] + t % bn[b]
        out = sp.coo_matrix(
            (host, (er, ec)), shape=(idx.nfullrows, idx.nfullcols)
        ).tocsr()
        out.sort_indices()
        return out


def to_csr_filter(m: BCSRMatrix, eps: float) -> sp.csr_matrix:
    """Blockwise-filtered conversion (``dbcsr_to_csr_filter``): drop blocks
    with Frobenius norm below ``eps`` before converting."""
    from .arithmetic import filter_blocks

    return to_csr(filter_blocks(desymmetrize(m), eps))


def from_csr(
    csr,
    row_block_sizes,
    col_block_sizes,
    *,
    device,
    name: str = "from_csr",
    dist=None,
    keep_zero_blocks: bool = False,
) -> BCSRMatrix:
    """Re-block a scalar CSR matrix (``convert_csr_to_dbcsr``) onto
    ``device``: any block containing at least one stored element (an
    explicit zero counts) becomes a stored (dense) block; with
    ``keep_zero_blocks`` every block is stored. Duplicate entries are
    summed (on a copy); ``dist`` is attached to the result."""
    csr = sp.csr_matrix(csr)
    rbs = np.asarray(row_block_sizes, dtype=np.int32)
    cbs = np.asarray(col_block_sizes, dtype=np.int32)
    ro = np.concatenate([[0], np.cumsum(rbs, dtype=np.int64)])
    co = np.concatenate([[0], np.cumsum(cbs, dtype=np.int64)])
    dbcsr_assert(
        csr.shape == (int(ro[-1]), int(co[-1])),
        f"CSR shape {csr.shape} does not match block sizes "
        f"({int(ro[-1])}, {int(co[-1])})",
    )
    if not csr.has_canonical_format:
        csr = csr.copy()
        csr.sum_duplicates()  # keeps explicit zeros
    with timed("from_csr"):
        coo = csr.tocoo()
        er = np.searchsorted(ro, coo.row, side="right") - 1
        ec = np.searchsorted(co, coo.col, side="right") - 1
        key = er.astype(np.int64) * len(cbs) + ec
        if keep_zero_blocks:
            keys = np.arange(len(rbs) * len(cbs), dtype=np.int64)
        else:
            keys = np.unique(key)
        index, _ = build_index(keys // len(cbs), keys % len(cbs), rbs, cbs)
        # canonical (row-major) order is the order of ``keys``: the block of
        # each element is its key's rank, its slot the row-major position
        b = np.searchsorted(keys, key)
        pos = (index.blk_offset[b] + (coo.row - ro[er]) * cbs[ec].astype(np.int64)
               + (coo.col - co[ec]))
        flat = np.zeros(index.nelems, dtype=csr.dtype)
        flat[pos] = coo.data
    return BCSRMatrix.from_flat(index, flat, name=name, device=device, dist=dist)


def csr_write(csr, path_or_file, *, threshold: Optional[float] = None) -> None:
    """Write a CSR matrix in coordinate text format, one ``row col value``
    line per entry, 1-based indices (``csr_write`` analog, the reference's
    external-solver exchange dump)."""
    csr = sp.csr_matrix(csr).tocoo()
    own = isinstance(path_or_file, str)
    f = open(path_or_file, "w") if own else path_or_file
    try:
        print(f"% {csr.shape[0]} {csr.shape[1]} {csr.nnz}", file=f)
        for r, c, v in zip(csr.row, csr.col, csr.data):
            if threshold is not None and abs(v) < threshold:
                continue
            print(f"{int(r) + 1} {int(c) + 1} {v:.17g}", file=f)
    finally:
        if own:
            f.close()
