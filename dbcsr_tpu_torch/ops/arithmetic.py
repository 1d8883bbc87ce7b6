"""Elementwise operations and reductions on BCSR matrices.

Port of ``dbcsr_tpu/ops/arithmetic.py`` (reference
``src/ops/dbcsr_operations.F:109-125``): add (index-merge), scale,
scale-by-vector, set/zero, trace, dot, hadamard product, epsilon filtering,
elementwise function application, triu, diagonal access, crop. All device
math runs at tile granularity on the tile stores (padding positions are
exactly 0, ``block/store.py``); index work stays on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.index import build_index, merge_index
from ..block.store import store_layout
from ..block.tileops import (
    block_mask_store,
    coord_mask,
    take_tiles,
    tile_align_map,
    valid_mask,
)
from ..core.errors import dbcsr_assert
from ..core.timing import timed
from .norms import block_norms_sq
from .transform import desymmetrize

__all__ = [
    "add",
    "scale",
    "scale_by_vector",
    "set_value",
    "zero",
    "trace",
    "dot",
    "hadamard_product",
    "filter_blocks",
    "function_of_elements",
    "ELEMENT_FUNCTIONS",
    "get_block_diag",
    "triu",
    "get_diag",
    "set_diag",
    "add_on_diag",
    "crop",
]


def _same_structure(a: BCSRMatrix, b: BCSRMatrix) -> bool:
    return np.array_equal(a.row_block_sizes, b.row_block_sizes) and np.array_equal(
        a.col_block_sizes, b.col_block_sizes
    )


def _align_to(keys: np.ndarray, m: BCSRMatrix) -> torch.Tensor:
    """m's store gathered onto the tile set ``keys`` (tile-level take)."""
    return take_tiles(m.data, tile_align_map(keys, m.layout.tile_keys()), m.tile)


def _scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar rounded to ``dtype`` first, as ``jnp.asarray(x, dtype)``
    (which keeps a complex scalar's real part for a real ``dtype``)."""
    if isinstance(x, complex) and not dtype.is_complex:
        x = x.real
    return torch.tensor(x, dtype=dtype, device=device)


def add(alpha, a: BCSRMatrix, beta, b: BCSRMatrix) -> BCSRMatrix:
    """alpha*A + beta*B with index union (``dbcsr_add``). The tile stores
    are dense-on-tiles with zero padding, so the union-aligned element sum
    IS the matrix sum — one tile gather per operand, one add."""
    dbcsr_assert(_same_structure(a, b), "incompatible block structures")
    if a.sym != b.sym:
        a, b = desymmetrize(a), desymmetrize(b)
    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    with timed("add"):
        merged, _, _ = merge_index(a.index, b.index)
        keys = store_layout(merged, a.tile).tile_keys()
        dtype = torch.promote_types(a.dtype, b.dtype)
        out = (_scalar(alpha, dtype, a.device) * _align_to(keys, a).to(dtype)
               + _scalar(beta, dtype, a.device) * _align_to(keys, b).to(dtype))
        return BCSRMatrix(name=a.name, index=merged, data=out, sym=a.sym,
                          dist=a.dist)


def scale(m: BCSRMatrix, alpha) -> BCSRMatrix:
    return m.with_data(m.data * _scalar(alpha, m.dtype, m.device))


def scale_by_vector(m: BCSRMatrix, vec, side: str = "right") -> BCSRMatrix:
    """Scale columns (side='right': A·diag(v)) or rows (side='left':
    diag(v)·A) — ``dbcsr_scale_by_vector``. The vector is re-tiled to
    [n_tiles, T] by a tile-level gather and broadcast-multiplied."""
    dbcsr_assert(side in ("left", "right"), "side must be left|right")
    lay = m.layout
    t = m.tile
    if side == "left":
        n, ntiles_dim, coord = m.index.nfullrows, lay.ntr, lay.tile_coords[:, 0]
    else:
        n, ntiles_dim, coord = m.index.nfullcols, lay.ntc, lay.tile_coords[:, 1]
    v = m.data.new_zeros(ntiles_dim * t)
    v[:n] = torch.as_tensor(vec, dtype=m.dtype, device=m.device).reshape(n)
    per_tile = v.reshape(ntiles_dim, t).index_select(
        0, torch.as_tensor(coord.astype(np.int64), device=m.device)
    )
    if side == "left":
        return m.with_data(m.data * per_tile[:, :, None])
    return m.with_data(m.data * per_tile[:, None, :])


def set_value(m: BCSRMatrix, value) -> BCSRMatrix:
    """Set every stored element (``dbcsr_set``); padding stays zero via the
    validity mask."""
    if value == 0:
        return zero(m)
    vm = valid_mask(m.index, m.tile, m.device).to(m.dtype)
    return m.with_data(vm * _scalar(value, m.dtype, m.device))


def zero(m: BCSRMatrix) -> BCSRMatrix:
    return m.with_data(torch.zeros_like(m.data))


def _diag_slots(m: BCSRMatrix) -> np.ndarray:
    lay = m.layout
    return np.flatnonzero(lay.tile_coords[:, 0] == lay.tile_coords[:, 1])


def _diag_tiles(m: BCSRMatrix, slots: np.ndarray) -> torch.Tensor:
    return m.data.index_select(0, torch.as_tensor(slots.astype(np.int64), device=m.device))


def _host_scalar(x: torch.Tensor):
    """A 0-d tensor as a Python ``complex`` (complex data) or ``float``."""
    return complex(x) if x.is_complex() else float(x)


def trace(m: BCSRMatrix):
    """Sum of diagonal elements (``dbcsr_trace``): a ``float``, or a
    ``complex`` for complex data. Only diagonal tiles (tr == tc) intersect
    the diagonal; padding zeros make the raw diagonal sum exact."""
    mm = desymmetrize(m)
    slots = _diag_slots(mm)
    if len(slots) == 0:
        return 0.0
    return _host_scalar(torch.diagonal(_diag_tiles(mm, slots), dim1=1, dim2=2).sum())


def dot(a: BCSRMatrix, b: BCSRMatrix):
    """Frobenius inner product Tr(A^H B) (``dbcsr_dot``; a ``complex`` for
    complex data, A conjugated): elementwise on the tile intersection —
    positions where either operand stores nothing are 0."""
    dbcsr_assert(_same_structure(a, b), "incompatible block structures")
    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    a = desymmetrize(a)
    b = desymmetrize(b)
    keys = np.intersect1d(a.layout.tile_keys(), b.layout.tile_keys())
    if len(keys) == 0:
        return 0.0
    # conj() is the identity on real data
    return _host_scalar(torch.sum(_align_to(keys, a).conj() * _align_to(keys, b)))


def hadamard_product(a: BCSRMatrix, b: BCSRMatrix) -> BCSRMatrix:
    """Elementwise product on the pattern intersection
    (``dbcsr_hadamard_product``). The store product is exact: positions
    covered by only one operand multiply against 0."""
    dbcsr_assert(_same_structure(a, b), "incompatible block structures")
    dbcsr_assert(a.tile == b.tile, "tile sizes differ")
    a = desymmetrize(a)
    b = desymmetrize(b)
    inter = a.index.pattern().astype(bool).multiply(b.index.pattern().astype(bool)).tocsr()
    inter.sort_indices()
    coo = inter.tocoo()
    new_index, _ = build_index(
        coo.row.astype(np.int32), coo.col.astype(np.int32),
        a.row_block_sizes, a.col_block_sizes,
    )
    keys = store_layout(new_index, a.tile).tile_keys()
    return BCSRMatrix(name=a.name, index=new_index,
                      data=_align_to(keys, a) * _align_to(keys, b), sym=SYM_NONE,
                      dist=a.dist)


def filter_blocks(m: BCSRMatrix, eps: Optional[float]) -> BCSRMatrix:
    """Drop blocks with Frobenius norm below eps (``dbcsr_filter``).
    Tile-level gather onto the surviving tile set + a block mask (indicator
    matmul) zeroing dropped blocks that share tiles with survivors."""
    if m.nblks == 0 or eps is None:
        return m
    with timed("filter"):
        keep = block_norms_sq(m).astype(np.float64) >= float(eps) ** 2
        if keep.all():
            return m
        # intern the filtered index by content: iterative filtered multiplies
        # re-derive the same surviving pattern every call, and a shared index
        # object carries its derived caches (store layout, valid_mask)
        from ..mm.plancache import array_fingerprint, get_plan_cache, index_fingerprint

        pcache = get_plan_cache()
        fkey = ("filter_index", index_fingerprint(m.index), array_fingerprint(keep))
        cached = pcache.get(fkey)
        if cached is not None:
            new_index = cached[0]
        else:
            new_index, _ = build_index(
                m.index.blk_rows[keep], m.index.col_idx[keep],
                m.index.row_block_sizes, m.index.col_block_sizes,
            )
            pcache.put(fkey, (new_index,))
        keys = store_layout(new_index, m.tile).tile_keys()
        data = _align_to(keys, m) * valid_mask(new_index, m.tile, m.device).to(m.dtype)
        return BCSRMatrix(name=m.name, index=new_index, data=data, sym=m.sym,
                          dist=m.dist)


def _safe_inverse(x: torch.Tensor) -> torch.Tensor:
    nz = x != 0
    return torch.where(nz, 1.0 / torch.where(nz, x, torch.ones_like(x)), torch.zeros_like(x))


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, torch.log(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


#: named element functions (the reference's ``dbcsr_func_*`` constants,
#: ``dbcsr_types.F:483-495``); ``function_of_elements`` also takes any
#: callable on a tensor
ELEMENT_FUNCTIONS: dict = {
    "inverse": _safe_inverse,
    "tanh": torch.tanh,
    "dtanh": lambda x: 1.0 - torch.tanh(x) ** 2,
    "ddtanh": lambda x: -2.0 * torch.tanh(x) * (1.0 - torch.tanh(x) ** 2),
    "artanh": torch.atanh,
    "dartanh": lambda x: 1.0 / (1.0 - x * x),
    "sin": torch.sin,
    "cos": torch.cos,
    "exp": torch.exp,
    "log": _safe_log,
    "sqrt": lambda x: torch.sqrt(torch.abs(x)),
    "inverse_special": lambda x: 1.0 / torch.where(x != 0, x, torch.ones_like(x)),
    "abs": torch.abs,
}


def function_of_elements(m: BCSRMatrix, fn) -> BCSRMatrix:
    """Apply an elementwise function to stored elements
    (``dbcsr_function_of_elements``): a name from :data:`ELEMENT_FUNCTIONS`
    or any callable on a tensor. The validity mask keeps padding at zero
    where fn(0) != 0."""
    if isinstance(fn, str):
        dbcsr_assert(fn in ELEMENT_FUNCTIONS, f"unknown element function {fn!r}")
        fn = ELEMENT_FUNCTIONS[fn]
    out = fn(m.data)
    vm = valid_mask(m.index, m.tile, m.device)
    return m.with_data(torch.where(vm > 0.5, out, torch.zeros_like(out)))


def get_block_diag(m: BCSRMatrix) -> BCSRMatrix:
    """Matrix holding only the diagonal BLOCKS (``dbcsr_get_block_diag``)."""
    dbcsr_assert(m.index.nblkrows == m.index.nblkcols, "needs square blocking")
    rows = m.index.blk_rows[m.index.blk_rows == m.index.col_idx]
    new_index, _ = build_index(rows, rows, m.index.row_block_sizes, m.index.col_block_sizes)
    keys = store_layout(new_index, m.tile).tile_keys()
    data = _align_to(keys, m) * valid_mask(new_index, m.tile, m.device).to(m.dtype)
    return BCSRMatrix(name=m.name + "_diag", index=new_index, data=data, sym=m.sym,
                      dist=m.dist)


def triu(m: BCSRMatrix) -> BCSRMatrix:
    """Zero the strictly-lower triangle of stored data (``dbcsr_triu``)."""
    mask = coord_mask(m.layout, lambda r, c: r <= c, m.device)
    return m.with_data(torch.where(mask, m.data, torch.zeros_like(m.data)))


def get_diag(m: BCSRMatrix) -> torch.Tensor:
    """Dense diagonal vector (``dbcsr_get_diag``), on the store's device."""
    dbcsr_assert(m.index.nfullrows == m.index.nfullcols, "diag needs square")
    mm = desymmetrize(m)
    lay = mm.layout
    out = mm.data.new_zeros((lay.ntr, mm.tile))
    slots = _diag_slots(mm)
    if len(slots):
        trs = torch.as_tensor(lay.tile_coords[slots, 0].astype(np.int64), device=mm.device)
        out[trs] = torch.diagonal(_diag_tiles(mm, slots), dim1=1, dim2=2)
    return out.reshape(-1)[: mm.index.nfullrows]


def _update_diag(m: BCSRMatrix, new_diag_tiles_fn) -> BCSRMatrix:
    """Shared scaffold for set_diag/add_on_diag: rewrite diagonal tiles
    (``new_diag_tiles_fn(tiles, stored_diagonal_mask, tile_rows)``)."""
    slots = _diag_slots(m)
    if len(slots) == 0:
        return m
    sl = torch.as_tensor(slots.astype(np.int64), device=m.device)
    d = m.data.index_select(0, sl)
    vm = valid_mask(m.index, m.tile, m.device).index_select(0, sl)
    eye = torch.eye(m.tile, dtype=torch.float32, device=m.device)
    diag_mask = (eye[None] * vm) > 0.5  # stored diagonal positions only
    data = m.data.clone()
    data[sl] = new_diag_tiles_fn(d, diag_mask, m.layout.tile_coords[slots, 0])
    return m.with_data(data)


def set_diag(m: BCSRMatrix, diag) -> BCSRMatrix:
    """Set stored diagonal elements from a dense vector (``dbcsr_set_diag``).
    Only elements inside stored blocks are set."""
    t = m.tile
    lay = m.layout
    n = m.index.nfullrows
    v = m.data.new_zeros(lay.ntr * t)
    v[:n] = torch.as_tensor(diag, dtype=m.dtype, device=m.device).reshape(n)
    v = v.reshape(lay.ntr, t)

    def upd(d, diag_mask, trs):
        vals = v.index_select(0, torch.as_tensor(trs.astype(np.int64), device=m.device))
        return torch.where(diag_mask, torch.diag_embed(vals), d)

    return _update_diag(m, upd)


def add_on_diag(m: BCSRMatrix, alpha) -> BCSRMatrix:
    """Add alpha to stored diagonal elements (``dbcsr_add_on_diag``)."""
    def upd(d, diag_mask, trs):
        return torch.where(diag_mask, d + _scalar(alpha, m.dtype, m.device), d)

    return _update_diag(m, upd)


def crop(
    m: BCSRMatrix,
    row_range: Optional[tuple] = None,
    col_range: Optional[tuple] = None,
) -> BCSRMatrix:
    """Zero data outside a block-index window (``dbcsr_crop_matrix``;
    element positions and index retained). Block keep mask applied via the
    indicator matmul."""
    r0, r1 = row_range if row_range else (0, m.nblkrows)
    c0, c1 = col_range if col_range else (0, m.nblkcols)
    keep = (
        (m.index.blk_rows >= r0) & (m.index.blk_rows < r1)
        & (m.index.col_idx >= c0) & (m.index.col_idx < c1)
    )
    mask = block_mask_store(m.index, m.tile, m.device, keep=keep.astype(np.float32))
    return m.with_data(m.data * mask.to(m.dtype))
