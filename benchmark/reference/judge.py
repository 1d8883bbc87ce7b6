"""The number that decides ``correct``: ``block_err``.

For every block b of C's superset pattern, with the reference's block R_b,
its bound W_b = Σ_k |A_ik|_F·|B_kj|_F and the program's block P_b (zero
where the program's output does not list b):

    e_b = |P_b - R_b·keep_b|_F / W_b,   block_err = max_b e_b

``keep_b`` is 1 without a filter. With a filter it is |R_b|_F² >= eps²;
the program takes its norms in single precision, as DBCSR does, so a block
whose norm² lies within ``tie_rel`` of eps² may go either way, and its e_b
is the smaller of the two readings. Rounding in float64 gives e_b of order
1e-16·sqrt(k terms); a wrong, missing, stale or wrongly kept or dropped
block gives order 0.1-1; a listed block outside the product's pattern, a
store of the wrong shape or a value that is not finite gives inf. Only the
elements of listed blocks are read: what a store holds between them does
not count.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .layout import Blocks, dense_rows, tile_keys
from .product import Product, sq


def listed(out: Blocks, nb: int, device) -> torch.Tensor:
    """``[nb + 1, nb + 1]`` bool: the blocks ``out`` lists (the last row
    and column, padding, never)."""
    m = torch.zeros((nb + 1, nb + 1), dtype=torch.bool, device=device)
    if out.n:
        m[torch.as_tensor(out.rows, device=device), torch.as_tensor(out.cols, device=device)] = True
    return m


def block_err(ref: Product, a_store: torch.Tensor, out: Blocks, store: torch.Tensor,
              eps: Optional[float] = None, tie_rel: float = 0.0) -> float:
    nb, tile = ref.nb, ref.tile
    okeys = tile_keys(out, tile)
    if tuple(store.shape) != (len(okeys), tile, tile):
        return math.inf
    if out.n and (out.rows.max() >= nb or out.cols.max() >= nb):
        return math.inf
    w = ref.bound(a_store)
    have = listed(out, nb, ref.dev)
    if bool((have[:-1, :-1] & (w == 0)).any()):
        return math.inf
    sr = torch.zeros((nb + 1, nb + 1), dtype=ref.real, device=ref.dev)
    sp_, sd = torch.zeros_like(sr), torch.zeros_like(sr)
    for t0, r in ref.rows(a_store):
        p = dense_rows(store, okeys, ref.nt, t0, t0 + r.shape[0] // tile, ref.dtype)
        own = ref.owner[t0 * tile: t0 * tile + r.shape[0]]
        p = torch.where(have[own][:, ref.owner], p, torch.zeros((), dtype=p.dtype,
                                                                device=p.device))
        if not bool(torch.isfinite(p).all()):
            return math.inf
        sr += ref.sums(sq(r), t0)
        sp_ += ref.sums(sq(p), t0)
        sd += ref.sums(sq(p - r), t0)
        del p, r
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
