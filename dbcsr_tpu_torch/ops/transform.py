"""Structural transformations: transpose, desymmetrize, fold, copy, dense
conversion.

Port of ``dbcsr_tpu/ops/transform.py``
(reference ``src/ops/dbcsr_transformations.F:101-150``). On the tile-store
layout, transpose is a tile permutation plus a per-tile transpose (no
element maps), and desymmetrize is the transposed store (negated for
antisymmetric, conjugated for hermitian storage) selected on the
strict-lower global triangle by a coordinate mask.
``make_dense``/``make_undense`` convert between block structures through
the dense matrix (``dbcsr_make_dense``/``dbcsr_make_undense``); ``retile``
re-lays a store at another tile edge with one device element gather. The
distribution functions (``redistribute``, ``complete_redistribute``,
``distribute``, ``replicate_all``) attach or drop a ``Distribution``: the
store is layout-independent and the distributed executors pack each rank's
panels from the distribution maps at multiply time, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..block.bcsr import (
    BCSRMatrix,
    SYM_ANTISYMMETRIC,
    SYM_HERMITIAN,
    SYM_NONE,
    SYM_SYMMETRIC,
)
from ..block.index import build_index
from ..block.store import store_layout
from ..block.tileops import (
    coord_mask,
    take_tiles,
    tile_align_map,
    transpose_store,
    valid_mask,
)
from ..core.errors import dbcsr_assert
from ..core.timing import timed

__all__ = [
    "transpose", "desymmetrize", "fold_symmetric", "copy", "make_dense",
    "make_undense", "may_be_dense", "retile", "redistribute",
    "complete_redistribute", "replicate_all", "distribute", "sum_replicated",
]


def fold_symmetric(m: BCSRMatrix, sym: str = SYM_SYMMETRIC) -> BCSRMatrix:
    """Fold a full matrix into symmetric upper-triangle storage (the inverse
    of :func:`desymmetrize`; the reference's canonical-index fold for
    symmetric product matrices, ``dbcsr_make_index_canonical``). The
    strictly-lower blocks are DISCARDED — callers assert the matrix is
    actually (anti)symmetric, as in the reference."""
    if m.sym != SYM_NONE:
        return m
    with timed("fold_symmetric"):
        keep = m.index.blk_rows <= m.index.col_idx
        new_index, _ = build_index(
            m.index.blk_rows[keep], m.index.col_idx[keep],
            m.index.row_block_sizes, m.index.col_block_sizes,
        )
        keys = store_layout(new_index, m.tile).tile_keys()
        data = take_tiles(
            m.data, tile_align_map(keys, m.layout.tile_keys()), m.tile
        ) * valid_mask(new_index, m.tile, m.device).to(m.dtype)
        return BCSRMatrix(name=m.name, index=new_index, data=data, sym=sym,
                          dist=m.dist)


def retile(m: BCSRMatrix, tile: int) -> BCSRMatrix:
    """Re-lay the store at a different hardware tile edge (the autotuner's
    per-workload-class ``tile_size`` knob): one device element gather
    between the two layouts; the index, and so the flat data, is
    unchanged."""
    if tile == m.tile:
        return m
    from ..block.gather import apply_flat_gather

    with timed("retile"):
        data = apply_flat_gather(
            m.index, tile, m, np.arange(m.index.nelems, dtype=np.int64)
        )
        return BCSRMatrix(name=m.name, index=m.index, data=data, sym=m.sym,
                          dist=m.dist)


def may_be_dense(m: BCSRMatrix, threshold: float = 0.5) -> bool:
    """Occupancy heuristic for the dense fast path (``dbcsr_may_be_dense``,
    ``src/ops/dbcsr_operations.F``)."""
    return m.occupation() >= threshold


def transpose(m: BCSRMatrix, *, conjugate: bool = False) -> BCSRMatrix:
    """Deep transpose (``dbcsr_new_transposed``): tile permutation +
    per-tile transpose. Symmetric inputs are expanded first; the result has
    symmetry 'N'. ``conjugate`` gives the conjugate transpose of a complex
    matrix (the identity on real ones)."""
    m = desymmetrize(m)
    with timed("transpose"):
        new_index, _ = m.index.transposed()
        data, coords_t = transpose_store(m.index, m.tile, m.data, conj=conjugate)
        dbcsr_assert(
            np.array_equal(store_layout(new_index, m.tile).tile_coords, coords_t),
            "transposed tile sets must agree",
        )
        return BCSRMatrix(name=m.name + "^T", index=new_index, data=data,
                          sym=SYM_NONE,
                          dist=None if m.dist is None else m.dist.transposed())


def desymmetrize(m: BCSRMatrix) -> BCSRMatrix:
    """Expand a symmetric/antisymmetric/hermitian matrix into full 'N'
    storage (``dbcsr_desymmetrize_deep``): the strictly-lower global
    triangle is the (signed) transposed store, selected by a coordinate
    mask — this also reflects the interior of diagonal blocks, matching the
    reference's convention that stored strictly-lower elements of diagonal
    blocks are shadowed by the upper triangle."""
    if m.sym == SYM_NONE:
        return m
    with timed("desymmetrize"):
        rows_u = m.index.blk_rows
        cols_u = m.index.col_idx
        off_diag = rows_u != cols_u
        new_index, _ = build_index(
            np.concatenate([rows_u, cols_u[off_diag]]),
            np.concatenate([cols_u, rows_u[off_diag]]),
            m.index.row_block_sizes, m.index.col_block_sizes,
        )
        new_lay = store_layout(new_index, m.tile)
        keys = new_lay.tile_keys()
        up = take_tiles(m.data, tile_align_map(keys, m.layout.tile_keys()), m.tile)
        refl_store, coords_t = transpose_store(m.index, m.tile, m.data)
        keys_t = coords_t[:, 0].astype(np.int64) * new_lay.ntc + coords_t[:, 1]
        refl = take_tiles(refl_store, tile_align_map(keys, keys_t), m.tile)
        if m.sym == SYM_ANTISYMMETRIC:
            refl = -refl
        elif m.sym == SYM_HERMITIAN:
            refl = refl.conj_physical()
        lower = coord_mask(new_lay, lambda r, c: r > c, m.device)
        return BCSRMatrix(name=m.name, index=new_index,
                          data=torch.where(lower, refl, up), sym=SYM_NONE,
                          dist=m.dist)


def copy(m: BCSRMatrix, *, name: Optional[str] = None) -> BCSRMatrix:
    """A new matrix sharing ``m``'s index and store (both are immutable)."""
    return replace(m, name=name or m.name)


def redistribute(m: BCSRMatrix, dist) -> BCSRMatrix:
    """Attach a new distribution (``dbcsr_redistribute``). The executors
    pack each rank's panels from the distribution maps, so changing the
    distribution moves no data here."""
    dbcsr_assert(
        dist is None or dist.compatible_with(m.index),
        "distribution incompatible with block structure",
    )
    return replace(m, dist=dist)


def complete_redistribute(m: BCSRMatrix, dist) -> BCSRMatrix:
    """Arbitrary dist→dist move (``dbcsr_complete_redistribute``,
    ``src/ops/dbcsr_transformations.F:101``): :func:`redistribute`, kept as
    a name of its own as in the reference's API."""
    return redistribute(m, dist)


def replicate_all(m: BCSRMatrix) -> BCSRMatrix:
    """Full replication (``dbcsr_replicate_all``): drop the distribution, so
    the engine treats the store as replicated (local multiplies)."""
    return replace(m, dist=None)


def distribute(m: BCSRMatrix, dist) -> BCSRMatrix:
    """Replicated → distributed (``dbcsr_distribute``), the inverse of
    :func:`replicate_all`: multiplies then run over ``dist``'s grid."""
    return redistribute(m, dist)


def sum_replicated(copies) -> BCSRMatrix:
    """Element-sum of independently updated replicas
    (``dbcsr_sum_replicated``, ``src/ops/dbcsr_operations.F:118``), in the
    order given; index patterns may differ (the result is the merged one)."""
    from .arithmetic import add

    copies = list(copies)
    dbcsr_assert(len(copies) > 0, "sum_replicated needs at least one matrix")
    out = copies[0]
    for nxt in copies[1:]:
        out = add(1.0, out, 1.0, nxt)
    return out


def make_dense(m: BCSRMatrix) -> BCSRMatrix:
    """Sparse-blocked → dense-blocked: one block holding the full matrix
    (``dbcsr_make_dense``)."""
    with timed("make_dense"):
        return BCSRMatrix.from_dense(
            m.to_dense(),
            np.array([m.index.nfullrows], dtype=np.int32),
            np.array([m.index.nfullcols], dtype=np.int32),
            name=m.name, keep_zero_blocks=True, device=m.device, tile=m.tile,
        )


def make_undense(
    m: BCSRMatrix,
    row_block_sizes,
    col_block_sizes,
    *,
    tol: float = 0.0,
    keep_zero_blocks: bool = False,
) -> BCSRMatrix:
    """Dense-blocked → sparse-blocked re-blocking (``dbcsr_make_undense``):
    blocks with Frobenius norm <= ``tol`` are dropped unless
    ``keep_zero_blocks``."""
    with timed("make_undense"):
        return BCSRMatrix.from_dense(
            m.to_dense(), row_block_sizes, col_block_sizes,
            name=m.name, tol=tol, keep_zero_blocks=keep_zero_blocks,
            device=m.device, tile=m.tile, dist=m.dist,
        )
