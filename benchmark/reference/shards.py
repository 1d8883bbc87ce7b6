"""The plain reference of a product held in shards: C = A·B where no
process holds the whole C and no card holds a dense B.

Each process judges the C tiles it holds (``Held``). The reference works
C out in dense rows of tiles: a chunk of tile rows takes only the k tiles
that its A rows hold, and B's rows of those k tiles in column pieces, so
B is never dense whole. The judge works out the rows and columns of every
block that meets a held tile, whole, so a block whose tiles lie on several
processes still has its whole norm for the keep decision, and reads only
the elements of the held tiles:

    e_b = |P_b - R_b·keep_b|_F (held elements) / W_b,  block_err = max_b e_b

with ``keep_b``, the tie rule and the readings of a wrong block as in
``judge.block_err``. Every element of C is held by one process, so the
processes' judgements together read every element once. Process 0 also
holds the plan's tiles of every rank, and checks that they cover C's
superset tiles exactly once (else inf).

Plain PyTorch and numpy, nothing of the program under test.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .judge import listed
from .layout import Blocks, dense_rows, element_owner, offsets, tile_keys, tile_rows
from .product import CHUNK_BYTES, ieee, sq, superset


@dataclass
class Held:
    """The C tiles one process holds, as row-major tile ids in the order of
    its store; on process 0 also each rank's tile ids from the program's
    plan (None elsewhere)."""

    keys: np.ndarray
    ranks: Optional[List[np.ndarray]] = None


def _sums_into(acc: torch.Tensor, x: torch.Tensor, row_owner: torch.Tensor,
               col_owner: torch.Tensor) -> None:
    """``acc[I, J] += Σ x`` over the elements of block (I, J), for the dense
    ``x`` whose rows belong to ``row_owner`` and columns to ``col_owner``
    (the last block of either: padding)."""
    ncb = acc.shape[1]
    per_col = torch.zeros((x.shape[0], ncb), dtype=x.dtype, device=x.device)
    per_col.index_add_(1, col_owner, x)
    i0, i1 = int(row_owner.min()), int(row_owner.max()) + 1
    part = torch.zeros((i1 - i0, ncb), dtype=x.dtype, device=x.device)
    part.index_add_(0, row_owner - i0, per_col)
    acc[i0:i1] += part


class RowsProduct:
    """``A·B`` over the pattern ``p`` in ``dtype`` in dense rows of tiles,
    B's tile store fixed (A and B share the pattern and the store keys)."""

    def __init__(self, p: Blocks, keys: np.ndarray, b_store: torch.Tensor, dtype):
        self.p, self.keys, self.dtype = p, keys, dtype
        self.b_store = b_store
        self.tile = int(b_store.shape[-1])
        self.nb = len(p.row_sizes)
        self.n = int(offsets(p.row_sizes)[-1])
        self.nt = -(-self.n // self.tile)
        self.dev = b_store.device
        self.owner = element_owner(p.row_sizes, self.nt * self.tile, self.dev)
        self.real = torch.empty(0, dtype=dtype).real.dtype
        self.item = torch.empty(0, dtype=dtype).element_size()
        self.step = max(1, CHUNK_BYTES // (self.tile * self.nt * self.tile * self.item))
        acc = self.zeros()
        for t0, x in self._dense_rows(b_store):
            _sums_into(acc, sq(x), self._row_owner(t0, x), self.owner)
        self.b_norm = acc[:-1, :-1].sqrt()

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.nb + 1, self.nb + 1), dtype=self.real, device=self.dev)

    def _row_owner(self, t0: int, x: torch.Tensor) -> torch.Tensor:
        return self.owner[t0 * self.tile: t0 * self.tile + x.shape[0]]

    def _dense_rows(self, store: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
        for t0 in range(0, self.nt, self.step):
            t1 = min(self.nt, t0 + self.step)
            yield t0, dense_rows(store, self.keys, self.nt, t0, t1, self.dtype)

    def sums_into(self, acc: torch.Tensor, x: torch.Tensor, rows: torch.Tensor,
                  cols: Optional[torch.Tensor] = None) -> None:
        """Block sums of ``x``, C's dense rows ``rows`` at columns ``cols``
        (all without it)."""
        _sums_into(acc, x, self.owner[rows], self.owner if cols is None else self.owner[cols])

    def bound(self, a_store: torch.Tensor) -> torch.Tensor:
        """``W_ij = Σ_k |A_ik|_F·|B_kj|_F``, ``[nb, nb]``."""
        acc = self.zeros()
        for t0, a in self._dense_rows(a_store):
            _sums_into(acc, sq(a), self._row_owner(t0, a), self.owner)
        with ieee():
            return acc[:-1, :-1].sqrt() @ self.b_norm

    def _b_rows(self, ktiles: np.ndarray, c0: int, c1: int) -> torch.Tensor:
        """B's tile rows ``ktiles`` over tile columns ``[c0, c1)``, dense."""
        t, nt = self.tile, self.nt
        out = torch.zeros((len(ktiles), t, c1 - c0, t), dtype=self.dtype, device=self.dev)
        k = self.keys
        row, col = k // nt, k % nt
        sel = np.flatnonzero(np.isin(row, ktiles) & (col >= c0) & (col < c1))
        if len(sel):
            r = torch.as_tensor(np.searchsorted(ktiles, row[sel]), device=self.dev)
            c = torch.as_tensor(col[sel] - c0, device=self.dev)
            s = torch.as_tensor(sel, device=self.dev)
            out.permute(0, 2, 1, 3)[r, c] = self.b_store.index_select(0, s).to(self.dtype)
        return out.view(len(ktiles) * t, (c1 - c0) * t)

    def meeting(self, tiles: np.ndarray) -> np.ndarray:
        """int64: the elements (of either axis, A and B share the block
        sizes) of every block that meets a tile of ``tiles`` along it."""
        owner = self.owner.cpu().numpy()
        meets = np.isin(np.arange(len(owner)) // self.tile, tiles) & (owner < self.nb)
        return np.flatnonzero(np.isin(owner, np.unique(owner[meets])))

    def rows(self, a_store: torch.Tensor, rows: Optional[np.ndarray] = None,
             cols: Optional[np.ndarray] = None
             ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        """``(t0, r, R)`` chunk by chunk: ``R`` is C's dense rows ``r``
        (global element rows within tile rows ``t0`` on, of ``rows``; all
        without it) at columns ``cols`` (all without it)."""
        t, nt = self.tile, self.nt
        ci = None if cols is None else torch.as_tensor(cols, device=self.dev)
        for t0, a in self._dense_rows(a_store):
            t1 = t0 + a.shape[0] // t
            if rows is None:
                r = torch.arange(t0 * t, t1 * t, device=self.dev)
            else:
                lo, hi = np.searchsorted(rows, [t0 * t, t1 * t])
                if hi == lo:
                    continue
                r = torch.as_tensor(rows[lo:hi], device=self.dev)
                a = a.index_select(0, r - t0 * t)
            lo, hi = tile_rows(self.keys, nt, t0, t1)
            ktiles = np.unique(self.keys[lo:hi] % nt)
            width = nt * t if ci is None else len(ci)
            c = torch.zeros((a.shape[0], width), dtype=self.dtype, device=self.dev)
            if len(ktiles):
                kc = (torch.as_tensor(ktiles, device=self.dev)[:, None] * t
                      + torch.arange(t, device=self.dev)).reshape(-1)
                ak = a.index_select(1, kc)
                step = max(1, CHUNK_BYTES // (len(ktiles) * t * t * self.item))
                with ieee():
                    for c0 in range(0, nt, step):
                        c1 = min(nt, c0 + step)
                        b = self._b_rows(ktiles, c0, c1)
                        if ci is None:
                            c[:, c0 * t:c1 * t] = ak @ b
                            continue
                        j0, j1 = np.searchsorted(cols, [c0 * t, c1 * t])
                        if j1 > j0:
                            c[:, j0:j1] = ak @ b.index_select(1, ci[j0:j1] - c0 * t)
                del ak
            del a
            yield t0, r, c


def held_block_err(ref: RowsProduct, a_store: torch.Tensor, held: Held, store: torch.Tensor,
                   eps: Optional[float] = None, tie_rel: float = 0.0) -> float:
    """``block_err`` over the elements of the tiles ``held`` names."""
    nb, tile, nt = ref.nb, ref.tile, ref.nt
    sup = superset(ref.p)
    sup_keys = tile_keys(sup, tile)
    keys = np.asarray(held.keys, dtype=np.int64)
    if tuple(store.shape) != (len(keys), tile, tile):
        return math.inf
    if len(np.unique(keys)) != len(keys) or not np.isin(keys, sup_keys).all():
        return math.inf
    if held.ranks is not None:
        every = np.concatenate([np.asarray(k, dtype=np.int64) for k in held.ranks])
        if len(every) != len(sup_keys) or not np.array_equal(np.sort(every), sup_keys):
            return math.inf
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    if not np.array_equal(order, np.arange(len(order))):
        store = store.index_select(0, torch.as_tensor(order, device=store.device))
    on_tile = torch.zeros(nt * nt, dtype=torch.bool, device=ref.dev)
    on_tile[torch.as_tensor(keys, device=ref.dev)] = True
    # the rows and columns of every block that meets a held tile: the
    # blocks' whole norms, and nothing of the tiles no block of them meets
    rows, cols = ref.meeting(np.unique(keys // nt)), ref.meeting(np.unique(keys % nt))
    ci = torch.as_tensor(cols, device=ref.dev)
    have = listed(sup, nb, ref.dev)[:, ref.owner[ci]]
    w = ref.bound(a_store)
    sr, sp_, sd = ref.zeros(), ref.zeros(), ref.zeros()
    zero = torch.zeros((), dtype=ref.dtype, device=ref.dev)
    for t0, ri, r in ref.rows(a_store, rows, cols):
        t1 = t0 + -(-(int(ri.max()) + 1 - t0 * tile) // tile)
        li = ri - t0 * tile
        p = dense_rows(store, keys, nt, t0, t1, ref.dtype).index_select(0, li)
        p = p.index_select(1, ci)
        mine = on_tile.view(nt, nt)[(ri // tile)[:, None], (ci // tile)[None, :]]
        mine &= have[ref.owner[ri]]
        p = torch.where(mine, p, zero)
        if not bool(torch.isfinite(p).all()):
            return math.inf
        ref.sums_into(sr, sq(r), ri, ci)
        ref.sums_into(sp_, sq(p), ri, ci)
        ref.sums_into(sd, sq(torch.where(mine, p - r, zero)), ri, ci)
        del p, r, mine
    sr, sp_, sd = sr[:-1, :-1], sp_[:-1, :-1], sd[:-1, :-1]
    if eps is None:
        diff = sd
    else:
        thr = float(eps) ** 2
        diff = torch.where(sr >= thr, sd, sp_)
        tie = (sr - thr).abs() <= tie_rel * thr
        diff = torch.where(tie, torch.minimum(sd, sp_), diff)
    on = w > 0
    if not bool(on.any()):
        return 0.0
    return float((diff[on].sqrt() / w[on]).max())
