"""The part of ``dbcsr_tpu/ops/transform.py`` the local multiply needs.

``desymmetrize`` passes non-symmetric matrices through and raises on
symmetric ones: expanding the stored triangle is not ported yet.
``make_dense``/``make_undense`` convert between block structures through
the dense matrix (``dbcsr_make_dense``/``dbcsr_make_undense``).
"""
from __future__ import annotations

import numpy as np

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..core.timing import timed

__all__ = ["desymmetrize", "make_dense", "make_undense"]


def desymmetrize(m: BCSRMatrix) -> BCSRMatrix:
    """``m`` itself when it is stored in full ('N'). Symmetric storage
    raises: the desymmetrizing expansion is not ported yet."""
    if m.sym != SYM_NONE:
        raise NotImplementedError(
            f"symmetric operands (sym={m.sym!r}) are not ported yet: "
            "desymmetrize comes with the rest of ops/ (ROADMAP Queue 1 item 4)"
        )
    return m


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
            device=m.device, tile=m.tile,
        )
