"""nd→2d index folding for block-sparse tensors.

Copy of ``dbcsr_tpu/tensors/index.py`` (numpy only). Analog of
``nd_to_2d_mapping`` (``src/tensors/dbcsr_tensor_index.F:40-56``): a rank-N
tensor's dimensions are partitioned into a row group ``map1`` and a column
group ``map2``; each group folds row-major into one 2-D matrix dimension, at
both block-index and element granularity. All folding here is vectorized
numpy over block multi-indices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..core.errors import dbcsr_assert

__all__ = ["NDMapping", "fold_indices", "unfold_indices", "grouped_block_sizes"]


def fold_indices(indices: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Row-major fold: ``indices`` [n, ndim] with extents ``dims`` → flat id
    [n] (first dim slowest, like the reference's row-major combine)."""
    indices = np.atleast_2d(np.asarray(indices, dtype=np.int64))
    flat = np.zeros(len(indices), dtype=np.int64)
    for d in range(indices.shape[1]):
        flat = flat * int(dims[d]) + indices[:, d]
    return flat


def unfold_indices(flat: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """Inverse of :func:`fold_indices`: flat ids → [n, ndim]."""
    flat = np.asarray(flat, dtype=np.int64)
    out = np.empty((len(flat), len(dims)), dtype=np.int64)
    for d in range(len(dims) - 1, -1, -1):
        out[:, d] = flat % int(dims[d])
        flat = flat // int(dims[d])
    return out


@dataclass(frozen=True)
class NDMapping:
    """Partition of tensor dims into (row group, col group).

    ``map1``/``map2`` — dim ids in fold order (the reference's
    ``map1_2d``/``map2_2d``); together they must be a permutation of
    ``range(ndim)``.
    """

    ndim: int
    map1: Tuple[int, ...]
    map2: Tuple[int, ...]

    def __post_init__(self):
        dbcsr_assert(
            sorted(self.map1 + self.map2) == list(range(self.ndim)),
            "map1+map2 must partition the tensor dimensions",
        )

    @property
    def dim_order(self) -> Tuple[int, ...]:
        """Storage dim order: map1 dims then map2 dims (elements inside a
        2-D block are row-major over this order)."""
        return self.map1 + self.map2

    def row_extents(self, nblk_per_dim: Sequence[int]) -> np.ndarray:
        return np.asarray([nblk_per_dim[d] for d in self.map1], dtype=np.int64)

    def col_extents(self, nblk_per_dim: Sequence[int]) -> np.ndarray:
        return np.asarray([nblk_per_dim[d] for d in self.map2], dtype=np.int64)

    def fold(
        self, block_indices: np.ndarray, nblk_per_dim: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """nd block multi-indices [n, ndim] → (block rows, block cols)."""
        bi = np.atleast_2d(np.asarray(block_indices, dtype=np.int64))
        rows = fold_indices(bi[:, list(self.map1)], self.row_extents(nblk_per_dim))
        cols = fold_indices(bi[:, list(self.map2)], self.col_extents(nblk_per_dim))
        return rows, cols

    def unfold(
        self, rows: np.ndarray, cols: np.ndarray, nblk_per_dim: Sequence[int]
    ) -> np.ndarray:
        """(block rows, block cols) → nd block multi-indices [n, ndim]."""
        r = unfold_indices(rows, self.row_extents(nblk_per_dim))
        c = unfold_indices(cols, self.col_extents(nblk_per_dim))
        out = np.empty((len(r), self.ndim), dtype=np.int64)
        out[:, list(self.map1)] = r
        out[:, list(self.map2)] = c
        return out


def grouped_block_sizes(
    block_sizes: List[np.ndarray], dims: Sequence[int]
) -> np.ndarray:
    """Block-size vector of one folded matrix dimension: the outer product
    of the per-dim block sizes over ``dims``, row-major (the folded block
    (i_0, .., i_g)'s size is the product of its per-dim sizes)."""
    if not dims:
        return np.ones(1, dtype=np.int32)
    out = np.asarray(block_sizes[dims[0]], dtype=np.int64)
    for d in dims[1:]:
        out = np.multiply.outer(out, np.asarray(block_sizes[d], dtype=np.int64))
    return out.reshape(-1).astype(np.int32)
