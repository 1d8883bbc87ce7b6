"""Tile-level stack planning for the sparse multiply path.

Copy of ``dbcsr_tpu/mm/tileplan.py``: the planner enumerates (c_tile,
a_tile, b_tile) triples over the T×T tile grids with vectorized numpy (or
the native C++ core, ``dbcsr_tpu/native/stackbuild.cpp``), sorts them by
output tile (the deterministic accumulation order every stack kernel keeps)
and emits the int32 stack the kernels in ``kernels.py`` and ``panel.py``
consume. Stack slots index the operand tile stores directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["TileStackPlan", "enumerate_tile_triples", "plan_tile_stacks_stores"]


@dataclass
class TileStackPlan:
    """Static description of one tile-sparse multiply over op-tile stores."""

    stack: np.ndarray  # int32 [S, 3] (c_slot, a_slot, b_slot), sorted by c
    n_c_tiles: int
    c_tile_keys: np.ndarray  # int64 [n_c_tiles] sorted row-major product keys
    tile_grid: Tuple[int, int, int]  # (Mt, Kt, Nt)


def _tile_csr(coords: np.ndarray, shape: Tuple[int, int]) -> sp.csr_matrix:
    """CSR over the tile grid with values = store slot + 1."""
    n = len(coords)
    return sp.csr_matrix(
        (
            np.arange(1, n + 1, dtype=np.int64),
            (coords[:, 0].astype(np.int64), coords[:, 1].astype(np.int64)),
        ),
        shape=shape,
    )


def enumerate_tile_triples(
    amat: sp.spmatrix, bmat: sp.spmatrix
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All (c_row, c_col, a_slot, b_slot) triples of two tile patterns
    (values = slot + 1). Fully vectorized: for each tile-column k of A and
    tile-row k of B, the cartesian product of their nonzero tiles
    contributes triples — built with repeat/arange arithmetic, no Python
    loop over k."""
    amat = amat.tocsc()
    bmat = bmat.tocsr()
    na_k = np.diff(amat.indptr).astype(np.int64)  # A tiles in tile-col k
    nb_k = np.diff(bmat.indptr).astype(np.int64)  # B tiles in tile-row k
    counts = na_k * nb_k
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z
    kt = len(na_k)
    k_of_t = np.repeat(np.arange(kt, dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t_local = np.arange(total, dtype=np.int64) - starts[k_of_t]
    nb = nb_k[k_of_t]
    a_pos = amat.indptr[k_of_t] + t_local // nb
    b_pos = bmat.indptr[k_of_t] + t_local % nb
    a_slot = (amat.data[a_pos] - 1).astype(np.int64)
    b_slot = (bmat.data[b_pos] - 1).astype(np.int64)
    c_row = amat.indices[a_pos].astype(np.int64)
    c_col = bmat.indices[b_pos].astype(np.int64)
    return c_row, c_col, a_slot, b_slot


def plan_tile_stacks_stores(
    a_coords: np.ndarray,  # [nA, 2] op-tile coords, row-major order = store slots
    a_grid: Tuple[int, int],  # (Mt, Kt)
    b_coords: np.ndarray,
    b_grid: Tuple[int, int],  # (Kt, Nt)
) -> TileStackPlan:
    """Enumerate all tile triples of op(A)·op(B) over the op tile stores."""
    mt, kt = a_grid
    kt2, nt = b_grid
    assert kt == kt2, "tile grid K mismatch"
    amat = _tile_csr(a_coords, (mt, kt))
    bmat = _tile_csr(b_coords, (kt, nt))

    # native (C++) fused enumerate+sort+slot-assign path (the analog of the
    # reference's compiled stack builder, see native/stackbuild.cpp)
    from ..core.config import get_config

    if get_config().use_native_planner:
        from ..native import stack_build

        acsc = amat.tocsc()
        bcsr_ = bmat.tocsr()
        nat = stack_build(
            kt, nt,
            acsc.indptr.astype(np.int64), acsc.indices.astype(np.int64),
            (acsc.data - 1).astype(np.int64),
            bcsr_.indptr.astype(np.int64), bcsr_.indices.astype(np.int64),
            (bcsr_.data - 1).astype(np.int64),
        )
        if nat is not None:
            stack, c_keys = nat
            return TileStackPlan(
                stack=stack,
                n_c_tiles=len(c_keys),
                c_tile_keys=c_keys.astype(np.int64),
                tile_grid=(mt, kt, nt),
            )

    c_row, c_col, a_slot, b_slot = enumerate_tile_triples(amat, bmat)
    if len(c_row) == 0:
        return TileStackPlan(
            stack=np.zeros((0, 3), dtype=np.int32),
            n_c_tiles=0,
            c_tile_keys=np.zeros(0, dtype=np.int64),
            tile_grid=(mt, kt, nt),
        )
    c_key = c_row * nt + c_col
    uniq, c_slot = np.unique(c_key, return_inverse=True)
    order = np.argsort(c_slot, kind="stable")
    stack = np.stack(
        [c_slot[order], a_slot[order], b_slot[order]], axis=1
    ).astype(np.int32)
    return TileStackPlan(
        stack=stack,
        n_c_tiles=len(uniq),
        c_tile_keys=uniq.astype(np.int64),
        tile_grid=(mt, kt, nt),
    )
