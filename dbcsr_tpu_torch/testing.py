"""Parity harness: carry a JAX-package matrix into the port.

A test builds a matrix in ``dbcsr_tpu``, hands its parts over as numpy
arrays (``np.asarray(m.data)``, the index arrays) and gets the port's
``BCSRMatrix`` with the same index and a bit-identical tile store; results
of both packages are then compared as numpy arrays. This module does not
import jax: the caller does the ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .block.bcsr import BCSRMatrix, SYM_NONE
from .block.index import build_index
from .block.store import store_layout
from .core.errors import dbcsr_assert

__all__ = ["matrix_from_arrays", "to_numpy"]


def matrix_from_arrays(
    row_block_sizes, col_block_sizes, rows, cols, data_np, *, device,
    name: str = "matrix", sym: str = SYM_NONE,
) -> BCSRMatrix:
    """The port's matrix with block sizes, block coordinates ``rows`` /
    ``cols`` (in the JAX matrix's canonical order: ``index.blk_rows``,
    ``index.col_idx``) and tile store ``data_np`` [n_tiles, T, T]."""
    data_np = np.asarray(data_np)
    dbcsr_assert(data_np.ndim == 3, "data must be a [n_tiles, T, T] store")
    index, order = build_index(rows, cols, row_block_sizes, col_block_sizes)
    dbcsr_assert(
        np.array_equal(order, np.arange(len(order))),
        "block coordinates must be in canonical (row, col) order",
    )
    lay = store_layout(index, int(data_np.shape[1]))
    dbcsr_assert(
        lay.n_tiles == data_np.shape[0],
        f"store has {data_np.shape[0]} tiles, the index needs {lay.n_tiles}",
    )
    return BCSRMatrix(
        name=name, index=index,
        data=torch.tensor(data_np, device=device),  # a copy: JAX arrays are read-only
        sym=sym,
    )


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16 widened to float32)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
