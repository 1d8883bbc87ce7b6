"""Parity harness: carry a JAX-package matrix or tensor into the port.

A test builds a matrix in ``dbcsr_tpu``, hands its parts over as numpy
arrays (``np.asarray(m.data)``, the index arrays, ``m.sym``) and gets the
port's ``BCSRMatrix`` with the same index, symmetry and a bit-identical
tile store — float64 stays float64 — so one numpy description reaches both
packages; results are then compared as numpy arrays. A tensor crosses the
same way, as its nd block sizes, its mapping and its folded matrix's block
coordinates and flat data (``tensor_from_arrays``). This module does not
import jax: the caller does the ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .block.bcsr import BCSRMatrix, SYM_NONE, _host_dtype, default_tile, torch_dtype
from .block.index import build_index
from .block.store import store_layout
from .core.errors import dbcsr_assert

__all__ = ["matrix_from_arrays", "tensor_from_arrays", "to_numpy"]


def matrix_from_arrays(
    row_block_sizes, col_block_sizes, rows, cols, data_np, *, device,
    name: str = "matrix", sym: str = SYM_NONE,
) -> BCSRMatrix:
    """The port's matrix with block sizes, block coordinates ``rows`` /
    ``cols`` (in the JAX matrix's canonical order: ``index.blk_rows``,
    ``index.col_idx``), tile store ``data_np`` [n_tiles, T, T] in its own
    dtype, and symmetry ``sym`` (symmetric storage holds the upper block
    triangle only, as the JAX package's builder requires)."""
    data_np = np.asarray(data_np)
    dbcsr_assert(data_np.ndim == 3, "data must be a [n_tiles, T, T] store")
    index, order = build_index(rows, cols, row_block_sizes, col_block_sizes)
    dbcsr_assert(
        np.array_equal(order, np.arange(len(order))),
        "block coordinates must be in canonical (row, col) order",
    )
    dbcsr_assert(
        sym == SYM_NONE or bool(np.all(index.blk_rows <= index.col_idx)),
        f"symmetric storage (sym={sym!r}) holds only blocks with row <= col",
    )
    lay = store_layout(index, int(data_np.shape[1]))
    dbcsr_assert(
        lay.n_tiles == data_np.shape[0],
        f"store has {data_np.shape[0]} tiles, the index needs {lay.n_tiles}",
    )
    return BCSRMatrix(
        name=name, index=index, sym=sym,
        data=torch.tensor(data_np, device=device),  # a copy: JAX arrays are read-only
    )


def tensor_from_arrays(
    block_sizes, map1, map2, rows, cols, flat, *, dtype, device, tile=None,
    name: str = "tensor",
):
    """The port's ``Tensor`` with nd ``block_sizes``, the mapping
    ``NDMapping(ndim, map1, map2)``, and a folded matrix whose block
    coordinates are ``rows`` / ``cols`` (the JAX tensor's
    ``matrix.index.blk_rows`` / ``col_idx``, canonical order) and whose flat
    block data is ``flat`` (its ``matrix.flat_host()``), in ``dtype`` with
    its tile store of edge ``tile`` on ``device``."""
    from .tensors.index import NDMapping, grouped_block_sizes
    from .tensors.tensor import Tensor

    bs = tuple(np.asarray(b, dtype=np.int32) for b in block_sizes)
    mapping = NDMapping(len(bs), tuple(map1), tuple(map2))
    rbs = grouped_block_sizes(list(bs), list(mapping.map1))
    cbs = grouped_block_sizes(list(bs), list(mapping.map2))
    index, _ = build_index(rows, cols, rbs, cbs)
    tdt = torch_dtype(dtype)
    store = store_layout(index, tile or default_tile()).store_from_flat(
        np.asarray(flat, dtype=_host_dtype(tdt)).reshape(-1)
    )
    m = matrix_from_arrays(rbs, cbs, rows, cols, store, device=device, name=name)
    return Tensor(name=name, block_sizes=bs, mapping=mapping, matrix=m.astype(tdt))


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16 widened to float32)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
