"""The plain product ``C = A·B`` of two block-sparse matrices of one block
pattern, from the benchmark's own tile stores: B whole as a dense matrix,
A and C in dense blocks of tile rows, every product and sum in the
reference's type (TF32 off, so float32 stays IEEE float32). A chunk's
quantities are summed over blocks (``layout.block_sums``), so what is kept
of the product is a few numbers a block. Plain PyTorch, numpy and scipy on
whatever device the stores are."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .layout import Blocks, block_sums, dense_rows, element_owner, offsets

#: bytes of one dense chunk of rows
CHUNK_BYTES = 1 << 30


def sq(x: torch.Tensor) -> torch.Tensor:
    """|x|² elementwise, real for complex ``x``."""
    return x.real.square() + x.imag.square() if x.is_complex() else x.square()


def superset(p: Blocks) -> Blocks:
    """C's superset pattern: every block (i, j) with some k such that A's
    block (i, k) and B's block (k, j) are stored (row-major)."""
    nb = len(p.row_sizes)
    m = sp.csr_matrix((np.ones(p.n), (p.rows, p.cols)), shape=(nb, nb))
    c = (m @ m).tocoo()
    order = np.lexsort((c.col, c.row))
    return Blocks(rows=c.row[order].astype(np.int64), cols=c.col[order].astype(np.int64),
                  row_sizes=p.row_sizes, col_sizes=p.col_sizes)


@contextmanager
def ieee():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Product:
    """``A·B`` over the pattern ``p`` in ``dtype``, with B's store fixed."""

    def __init__(self, p: Blocks, keys: np.ndarray, b_store: torch.Tensor, dtype):
        self.p, self.keys, self.dtype = p, keys, dtype
        self.tile = int(b_store.shape[-1])
        self.nb = len(p.row_sizes)
        self.n = int(offsets(p.row_sizes)[-1])
        self.nt = -(-self.n // self.tile)
        self.dev = b_store.device
        self.owner = element_owner(p.row_sizes, self.nt * self.tile, self.dev)
        self.b = dense_rows(b_store, keys, self.nt, 0, self.nt, dtype)
        self.real = torch.empty(0, dtype=dtype).real.dtype
        self.step = max(1, CHUNK_BYTES // (self.tile * self.nt * self.tile
                                           * torch.empty(0, dtype=dtype).element_size()))
        self.b_norm = self.norms(self.b)

    def sums(self, x: torch.Tensor, t0: int) -> torch.Tensor:
        rows = self.owner[t0 * self.tile: t0 * self.tile + x.shape[0]]
        return block_sums(x, rows, self.owner, self.nb, self.nb)

    def norms(self, x: torch.Tensor) -> torch.Tensor:
        """``[nb, nb]`` Frobenius norms of the blocks of a whole dense matrix."""
        return self.sums(sq(x), 0)[:-1, :-1].sqrt()

    def bound(self, a_store: torch.Tensor) -> torch.Tensor:
        """``W_ij = Σ_k |A_ik|_F·|B_kj|_F``, ``[nb, nb]``: zero exactly off
        C's superset pattern."""
        acc = torch.zeros((self.nb + 1, self.nb + 1), dtype=self.real, device=self.dev)
        for t0, a in self.a_rows(a_store):
            acc += self.sums(sq(a), t0)
        with ieee():
            return acc[:-1, :-1].sqrt() @ self.b_norm

    def a_rows(self, a_store: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
        for t0 in range(0, self.nt, self.step):
            t1 = min(self.nt, t0 + self.step)
            yield t0, dense_rows(a_store, self.keys, self.nt, t0, t1, self.dtype)

    def rows(self, a_store: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
        """``(t0, C's dense rows from tile row t0)``, chunk by chunk."""
        with ieee():
            for t0, a in self.a_rows(a_store):
                yield t0, a @ self.b
