"""Tensor contraction: C[map_1, map_2] := alpha · A · B + beta · C.

Port of ``dbcsr_tpu/tensors/contract.py``. Analog of ``dbcsr_t_contract``
→ ``dbcsr_t_contract_expert`` (``src/tensors/dbcsr_tensor.F:418-537,541+``):
align each operand's index groups with its (contract, notcontract) dim sets
— re-folding/permuting the 2-D representation where needed (``dbcsr_t_copy``
machinery / ``dbcsr_t_reshape``) — then run the folded product through the
TAS layer (``dbcsr_tas_multiply``) and fold the result into the output
tensor's layout. Supports ``bounds`` (block-aligned index-range batching, the
reference's ``bounds_1/2/3``), ``filter_eps`` and flop reporting. The
folded product runs on the operands' device through the port's multiply;
``dist=`` reaches it and runs it over the distribution's process grid
(Cannon or SUMMA, ``mm/cannon.py``, ``mm/summa.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.errors import dbcsr_assert
from ..block.bcsr import BCSRMatrix
from ..core.stats import get_stats
from ..core.timing import timed
from ..mm.plancache import index_fingerprint
from ..tas.matrix import extract_block_subset
from ..tas.mm import BatchedTAS, tas_multiply
from .index import NDMapping
from .tensor import Tensor

__all__ = ["contract", "copy_tensor", "contraction_layouts", "BatchedContract"]


def contraction_layouts(
    ndim_a: int,
    contract_1: Sequence[int],
    notcontract_1: Sequence[int],
    ndim_b: int,
    contract_2: Sequence[int],
    notcontract_2: Sequence[int],
    map_1: Optional[Sequence[int]] = None,
    map_2: Optional[Sequence[int]] = None,
):
    """The (A, B, C) fold mappings that make :func:`contract` refold-free.

    Analog of the reference's ``optimize_dist`` / returned optimal pgrids
    (``dbcsr_t_contract`` parameters): build or copy tensors into these
    layouts up front and every contraction in the loop skips the refold
    entirely.
    """
    c1 = tuple(int(x) for x in contract_1)
    c2 = tuple(int(x) for x in contract_2)
    nc1 = tuple(int(x) for x in notcontract_1)
    nc2 = tuple(int(x) for x in notcontract_2)
    ndim_c = len(nc1) + len(nc2)
    m1 = tuple(int(x) for x in (map_1 if map_1 is not None else range(len(nc1))))
    m2 = tuple(
        int(x) for x in (map_2 if map_2 is not None else range(len(nc1), ndim_c))
    )
    return (
        NDMapping(ndim_a, nc1, c1),
        NDMapping(ndim_b, c2, nc2),
        NDMapping(ndim_c, m1, m2),
    )


def copy_tensor(
    t: Tensor,
    *,
    order: Optional[Sequence[int]] = None,
    mapping: Optional[NDMapping] = None,
    name: Optional[str] = None,
) -> Tensor:
    """Permuted copy (``dbcsr_t_copy`` with ``order``): output dim ``i`` is
    input dim ``order[i]``. Dim relabeling is free (the fold mapping is
    rewritten); an explicit target ``mapping`` triggers one device gather.
    """
    if order is not None:
        order = tuple(int(x) for x in order)
        dbcsr_assert(sorted(order) == list(range(t.ndim)), "bad dim order")
        new_of_old = {o: i for i, o in enumerate(order)}
        relabeled = Tensor(
            name=name or t.name,
            block_sizes=tuple(t.block_sizes[d] for d in order),
            mapping=NDMapping(
                t.ndim,
                tuple(new_of_old[d] for d in t.mapping.map1),
                tuple(new_of_old[d] for d in t.mapping.map2),
            ),
            matrix=t.matrix,
            offsets=None if t.offsets is None else tuple(t.offsets[d] for d in order),
        )
        t = relabeled
    if mapping is not None:
        t = t.with_layout(mapping)
    if name is not None and t.name != name:
        from dataclasses import replace

        t = replace(t, name=name)
    return t


def _blockdim_range(block_sizes: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Block ids of the element range [lo, hi) — must be block-aligned
    (the reference's batched-contraction bounds are block ranges in
    practice; element-splitting a block is ``dbcsr_t_split_blocks``' job)."""
    off = np.concatenate([[0], np.cumsum(block_sizes, dtype=np.int64)])
    b0 = int(np.searchsorted(off, lo))
    b1 = int(np.searchsorted(off, hi))
    dbcsr_assert(
        off[b0] == lo and off[b1] == hi,
        f"bounds [{lo},{hi}) not aligned with block boundaries",
    )
    return np.arange(b0, b1, dtype=np.int64)


def _fold_keep(
    t: Tensor, dims: Tuple[int, ...], bounds: Optional[Dict[int, Tuple[int, int]]]
) -> Optional[np.ndarray]:
    """Folded ids (over ``dims``' fold space) selected by per-dim bounds."""
    if not bounds or not any(d in bounds for d in dims):
        return None
    sel = []
    for d in dims:
        if d in bounds:
            lo, hi = bounds[d]
            sel.append(_blockdim_range(t.block_sizes[d], lo, hi))
        else:
            sel.append(np.arange(len(t.block_sizes[d]), dtype=np.int64))
    extents = [len(t.block_sizes[d]) for d in dims]
    flat = np.zeros(1, dtype=np.int64)
    for e, s in zip(extents, sel):
        flat = (flat[:, None] * e + s[None, :]).reshape(-1)
    return flat


def contract(
    alpha,
    a: Tensor,
    b: Tensor,
    beta=0.0,
    c: Optional[Tensor] = None,
    *,
    contract_1: Sequence[int],
    notcontract_1: Sequence[int],
    contract_2: Sequence[int],
    notcontract_2: Sequence[int],
    map_1: Optional[Sequence[int]] = None,
    map_2: Optional[Sequence[int]] = None,
    c_block_sizes: Optional[Sequence[np.ndarray]] = None,
    filter_eps: Optional[float] = None,
    bounds: Optional[Dict[str, Dict[int, Tuple[int, int]]]] = None,
    nsplit: Optional[int] = None,
    dist=None,
    return_flops: bool = False,
):
    """Contract ``contract_1`` dims of ``a`` with ``contract_2`` dims of
    ``b``; ``map_1``/``map_2`` place ``notcontract_1``/``notcontract_2``
    into the output's dims (defaults: notcontract_1 dims first).

    ``bounds`` batches over index ranges (block-aligned element ranges):
    ``{"contract": {dim_of_a: (lo, hi)}, "nc1": {...}, "nc2": {...}}`` —
    the reference's ``bounds_1/2/3`` (``src/tensors/dbcsr_tensor.F:476-486``).
    """
    contract_1 = tuple(int(x) for x in contract_1)
    contract_2 = tuple(int(x) for x in contract_2)
    nc1 = tuple(int(x) for x in notcontract_1)
    nc2 = tuple(int(x) for x in notcontract_2)
    dbcsr_assert(len(contract_1) == len(contract_2), "contract sets differ")
    dbcsr_assert(
        sorted(contract_1 + nc1) == list(range(a.ndim)),
        "contract_1+notcontract_1 must cover tensor A dims",
    )
    dbcsr_assert(
        sorted(contract_2 + nc2) == list(range(b.ndim)),
        "contract_2+notcontract_2 must cover tensor B dims",
    )
    for da, db in zip(contract_1, contract_2):
        dbcsr_assert(
            np.array_equal(a.block_sizes[da], b.block_sizes[db]),
            f"contracted dims {da}(A)/{db}(B) have different block sizes",
        )

    ndim_c = len(nc1) + len(nc2)
    map_1 = tuple(int(x) for x in (map_1 if map_1 is not None else range(len(nc1))))
    map_2 = tuple(
        int(x) for x in (map_2 if map_2 is not None else range(len(nc1), ndim_c))
    )
    dbcsr_assert(
        sorted(map_1 + map_2) == list(range(ndim_c)),
        "map_1+map_2 must cover the output dims",
    )

    with timed("t_contract"):
        # --- align operand layouts (dbcsr_t_contract_expert's reshape) ----
        a2 = a.with_layout(NDMapping(a.ndim, nc1, contract_1))
        b2 = b.with_layout(NDMapping(b.ndim, contract_2, nc2))
        ma, mb = a2.matrix, b2.matrix

        # --- bounds cropping (the reference's bounds_1/2/3 batching) -------
        # contract-dim ranges (bounds_1) restrict the summation; ranges on
        # the non-contracted dims (bounds_2/3) restrict the computed window
        # of C — the window product is re-expanded into the full C index
        # space below, with beta*C applying to the whole C (batched callers
        # accumulate windows with beta=1).
        m_keep = n_keep = None
        if bounds:
            cb = bounds.get("contract")
            if cb:
                k_keep = _fold_keep(a2, contract_1, cb)
                if k_keep is not None:
                    kb_bounds = {
                        contract_2[i]: cb[contract_1[i]]
                        for i in range(len(contract_1))
                        if contract_1[i] in cb
                    }
                    kb_keep = _fold_keep(b2, contract_2, kb_bounds)
                    ma = extract_block_subset(ma, col_blocks=k_keep)
                    mb = extract_block_subset(mb, row_blocks=kb_keep)
            m_keep = _fold_keep(a2, nc1, bounds.get("nc1"))
            n_keep = _fold_keep(b2, nc2, bounds.get("nc2"))
            if m_keep is not None:
                ma = extract_block_subset(ma, row_blocks=m_keep)
            if n_keep is not None:
                mb = extract_block_subset(mb, col_blocks=n_keep)

        # --- output bookkeeping -------------------------------------------
        c_bs: list = [None] * ndim_c
        for i, d in enumerate(nc1):
            c_bs[map_1[i]] = a.block_sizes[d]
        for i, d in enumerate(nc2):
            c_bs[map_2[i]] = b.block_sizes[d]
        if c_block_sizes is not None:
            for i, bs in enumerate(c_block_sizes):
                dbcsr_assert(
                    np.array_equal(np.asarray(bs, np.int32), c_bs[i]),
                    "output block sizes inconsistent with operands",
                )
        inter_map = NDMapping(ndim_c, map_1, map_2)

        window_mode = m_keep is not None or n_keep is not None
        c_in_matrix = None
        if c is not None and beta != 0.0 and not window_mode:
            c_in_matrix = c.with_layout(inter_map).matrix

        # --- folded product through the TAS layer --------------------------
        out_tas, fl = tas_multiply(
            "N", "N", alpha, ma, mb,
            0.0 if window_mode else beta,
            None if window_mode else c_in_matrix,
            filter_eps=filter_eps, nsplit=nsplit, dist=dist,
            return_flops=True,
        )
        out_m = out_tas.matrix

        if window_mode:
            # re-expand the window into C's full folded index space: the
            # window's canonical block order is preserved under the
            # (ascending) selections, so data transplants block-for-block
            from ..block.bcsr import BCSRMatrix
            from ..block.gather import apply_flat_gather
            from ..block.index import build_index
            from .index import grouped_block_sizes

            full_rbs = grouped_block_sizes(list(c_bs), list(map_1))
            full_cbs = grouped_block_sizes(list(c_bs), list(map_2))
            rows_sel = (
                m_keep if m_keep is not None
                else np.arange(len(full_rbs), dtype=np.int64)
            )
            cols_sel = (
                n_keep if n_keep is not None
                else np.arange(len(full_cbs), dtype=np.int64)
            )
            full_index, order = build_index(
                rows_sel[out_m.index.blk_rows],
                cols_sel[out_m.index.col_idx],
                full_rbs, full_cbs,
            )
            dbcsr_assert(
                np.array_equal(order, np.arange(len(order))),
                "window expansion must preserve block order",
            )
            data = apply_flat_gather(
                full_index, out_m.tile, out_m,
                np.arange(full_index.nelems, dtype=np.int64),
            )
            out_m = BCSRMatrix(
                name="contraction", index=full_index, data=data
            )
            if c is not None and beta != 0.0:
                from ..ops.arithmetic import add

                out_m = add(1.0, out_m, beta, c.with_layout(inter_map).matrix)

        result = Tensor(
            name=(c.name if c is not None else "contraction"),
            block_sizes=tuple(c_bs),
            mapping=inter_map,
            matrix=out_m,
        )
        if c is not None:
            result = result.with_layout(c.mapping)

    if return_flops:
        return result, fl
    return result


class BatchedContract:
    """Batched tensor contraction (``dbcsr_t_batched_contract_init/finalize``,
    ``src/tensors/dbcsr_tensor.F``): contractions repeated over fixed
    sparsity patterns, each distinct (operand patterns, bounds, eps)
    planned once through :class:`~dbcsr_tpu_torch.tas.mm.BatchedTAS`
    (span ``tensor/plan``) and then run as device work alone (span
    ``tensor/batch``, counter ``tensor_batches``).

    ``bounds`` are :func:`contract`'s (``{"contract": {dim_of_a: (lo, hi)},
    "nc1": {...}, "nc2": {...}}``, block-aligned element ranges, the
    reference's ``bounds_1/2/3``), in the index that each operand's
    ``offsets`` start from. A window stays in its own compact index: a
    bounded free dim of the result holds the window's blocks alone,
    numbered from its first, and the result's ``offsets`` record where it
    starts. An operand is cut to a bound in its own index (the bound less
    its offset; a bound that reaches outside what it holds raises), so the
    window result of one contraction feeds the next as it is. The
    contracted dims of the two operands start at the same offset. The
    operands' layout alignments are refolds (:meth:`Tensor.with_layout`,
    block-granular).

    ``c`` with ``beta`` = 1 accumulates: the result is ``c + a·b`` over the
    union of the two patterns (``beta`` = 0 ignores ``c``). With ``filter_eps`` a complete contraction
    into a fresh result is filtered at once (in mask form: the product's
    superset index, the dropped blocks zero); a batch over a contracted
    index, or one summed into ``c``, sums unfiltered, and its result is
    filtered in place at :meth:`filter` or :meth:`finalize`. A combination
    it does not support raises; nothing falls back to :func:`contract`."""

    def __init__(self):
        self._tas = BatchedTAS()
        self._accum: Dict[tuple, tuple] = {}
        self._pending: list = []  # [(result, eps)]: filters owed

    def contract(
        self,
        a: Tensor,
        b: Tensor,
        *,
        contract_1: Sequence[int],
        notcontract_1: Sequence[int],
        contract_2: Sequence[int],
        notcontract_2: Sequence[int],
        map_1: Optional[Sequence[int]] = None,
        map_2: Optional[Sequence[int]] = None,
        bounds: Optional[Dict[str, Dict[int, Tuple[int, int]]]] = None,
        filter_eps: Optional[float] = None,
        beta=0.0,
        c: Optional[Tensor] = None,
    ) -> Tensor:
        nc1 = tuple(int(x) for x in notcontract_1)
        nc2 = tuple(int(x) for x in notcontract_2)
        c1 = tuple(int(x) for x in contract_1)
        c2 = tuple(int(x) for x in contract_2)
        dbcsr_assert(len(c1) == len(c2), "contract sets differ")
        dbcsr_assert(sorted(c1 + nc1) == list(range(a.ndim)),
                     "contract_1+notcontract_1 must cover tensor A dims")
        dbcsr_assert(sorted(c2 + nc2) == list(range(b.ndim)),
                     "contract_2+notcontract_2 must cover tensor B dims")
        bounds = dict(bounds or {})
        dbcsr_assert(set(bounds) <= {"contract", "nc1", "nc2"},
                     f"unknown bounds {sorted(set(bounds) - {'contract', 'nc1', 'nc2'})}")
        cb = dict(bounds.get("contract") or {})
        dbcsr_assert(set(cb) <= set(c1), "contract bounds name a dim A does not contract")
        ndim_c = len(nc1) + len(nc2)
        m1 = tuple(int(x) for x in (map_1 if map_1 is not None else range(len(nc1))))
        m2 = tuple(
            int(x)
            for x in (map_2 if map_2 is not None else range(len(nc1), ndim_c))
        )
        dbcsr_assert(sorted(m1 + m2) == list(range(ndim_c)),
                     "map_1+map_2 must cover the output dims")
        with timed("tensor/batch"):
            a2 = a.with_layout(NDMapping(a.ndim, nc1, c1))
            b2 = b.with_layout(NDMapping(b.ndim, c2, nc2))
            nb1, nb2 = dict(bounds.get("nc1") or {}), dict(bounds.get("nc2") or {})
            dbcsr_assert(set(nb1) <= set(nc1) and set(nb2) <= set(nc2),
                         "nc1/nc2 bounds name a dim that is contracted")
            nb1.update(cb)
            nb2.update({db: cb[da] for da, db in zip(c1, c2) if da in cb})
            # each operand's cuts (its own dim -> (lo, hi) in its own index)
            # and where each dim starts once cut
            cut_a, off_a = _own_cuts(a2, nb1, "A")
            cut_b, off_b = _own_cuts(b2, nb2, "B")
            bs_a = _cut_sizes(a2, cut_a)
            bs_b = _cut_sizes(b2, cut_b)
            for da, db in zip(c1, c2):
                dbcsr_assert(off_a[da] == off_b[db],
                             f"contracted dims {da}(A)/{db}(B) start at elements "
                             f"{off_a[da]} and {off_b[db]}")
                dbcsr_assert(np.array_equal(bs_a[da], bs_b[db]),
                             f"contracted dims {da}(A)/{db}(B) have different block "
                             "sizes in the window")
            ma = _window(a2, nc1, c1, cut_a)
            mb = _window(b2, c2, nc2, cut_b)
            c_bs: list = [None] * ndim_c
            c_off: list = [0] * ndim_c
            for i, d in enumerate(nc1):
                c_bs[m1[i]], c_off[m1[i]] = bs_a[d], off_a[d]
            for i, d in enumerate(nc2):
                c_bs[m2[i]], c_off[m2[i]] = bs_b[d], off_b[d]
            inter = NDMapping(ndim_c, m1, m2)
            dbcsr_assert(beta in (0.0, 1.0), "beta is 0 (c is overwritten) or 1 (summed into)")
            accumulate = c is not None and beta == 1.0
            # a batch over a contracted index is a partial sum: its filter waits
            now = filter_eps is not None and not cb and not accumulate
            out = self._tas.multiply("N", "N", ma, mb,
                                     filter_eps=float(filter_eps) if now else None)
            if accumulate:
                dbcsr_assert(c.starts == tuple(c_off),
                             f"c starts at {c.starts}, the contraction's result at "
                             f"{tuple(c_off)}")
                out = self._accumulate(c, inter, c_bs, out)
            result = Tensor(name="contraction" if c is None else c.name,
                            block_sizes=tuple(c_bs), mapping=inter, matrix=out,
                            offsets=tuple(c_off) if any(c_off) else None)
            get_stats().tensor_batches += 1
        self._pending = [(t, e) for t, e in self._pending if t is not c]
        if filter_eps is not None and not now:
            self._pending.append((result, float(filter_eps)))
        return result

    def _accumulate(self, c: Tensor, inter: NDMapping, c_bs: list,
                    prod: BCSRMatrix) -> BCSRMatrix:
        """``c + prod`` over the union of their patterns, tile by tile (the
        two stores are zero off their blocks)."""
        dbcsr_assert(c.ndim == len(c_bs) and all(
            np.array_equal(x, y) for x, y in zip(c.block_sizes, c_bs)),
            "c's block sizes differ from the contraction's result")
        cm = c.with_layout(inter).matrix
        dbcsr_assert(cm.tile == prod.tile and cm.device == prod.device,
                     "c lies on another device or tile edge")
        key = (index_fingerprint(cm.index), index_fingerprint(prod.index), prod.tile,
               str(prod.device))
        if key not in self._accum:
            with timed("tensor/plan"):
                self._accum[key] = _union_plan(cm.index, prod.index, prod.tile, prod.device)
        index, c_slots, p_slots, n_tiles, same = self._accum[key]
        dtype = torch.promote_types(cm.dtype, prod.dtype)
        if same:
            data = cm.data.to(dtype, copy=True)
        else:
            t = prod.tile
            data = torch.zeros((n_tiles, t, t), dtype=dtype, device=prod.device)
            data.index_copy_(0, c_slots, cm.data.to(dtype))
        data.index_add_(0, p_slots, prod.data.to(dtype))
        return BCSRMatrix(name=c.name, index=index, data=data)

    def filter(self, t: Tensor, filter_eps: Optional[float] = None) -> Tensor:
        """``t`` filtered in place (its store in mask form: the blocks of
        norm below eps zero), at ``filter_eps`` or at the eps its
        contractions deferred; returns ``t``."""
        owed = [e for x, e in self._pending if x is t]
        eps = filter_eps if filter_eps is not None else (owed[-1] if owed else None)
        dbcsr_assert(eps is not None, "no filter_eps given or owed for this tensor")
        self._pending = [(x, e) for x, e in self._pending if x is not t]
        from ..mm.filtered import filter_store_

        m = t.matrix
        filter_store_(m.data, m.index, m.tile, float(eps))
        return t

    def finalize(self):
        """Filter every result whose filter its contractions deferred, then
        drop the plans."""
        for t, _ in list(self._pending):
            self.filter(t)
        self._tas.finalize()
        self._accum.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
        return False


def _own_cuts(t: Tensor, bounds: Dict[int, Tuple[int, int]], what: str):
    """(``t``'s cuts in its own index: dim -> (lo, hi), each bound less the
    dim's offset, left out where it is all ``t`` holds; the element where
    each dim of ``t`` starts once cut)."""
    starts = list(t.starts)
    cut = {}
    for d, (lo, hi) in bounds.items():
        lo, hi, off, ext = int(lo), int(hi), starts[d], t.shape[d]
        dbcsr_assert(off <= lo <= hi <= off + ext,
                     f"bounds [{lo},{hi}) of dim {d} of {what} reach outside the "
                     f"elements [{off},{off + ext}) it holds")
        if (lo - off, hi - off) != (0, ext):
            cut[d] = (lo - off, hi - off)
        starts[d] = lo
    return cut, starts


def _window(t: Tensor, rows: Tuple[int, ...], cols: Tuple[int, ...],
            cut: Dict[int, Tuple[int, int]]) -> BCSRMatrix:
    """``t``'s matrix cut to the blocks of ``cut`` (its own dims)."""
    rsel = _fold_keep(t, rows, cut)
    csel = _fold_keep(t, cols, cut)
    if rsel is None and csel is None:
        return t.matrix
    return extract_block_subset(t.matrix, row_blocks=rsel, col_blocks=csel)


def _cut_sizes(t: Tensor, cut: Dict[int, Tuple[int, int]]) -> list:
    """``t``'s per-dim block sizes with the dims of ``cut`` cut to their
    window."""
    out = list(t.block_sizes)
    for d, (lo, hi) in cut.items():
        out[d] = np.asarray(t.block_sizes[d])[_blockdim_range(t.block_sizes[d], int(lo), int(hi))]
    return out


def _union_plan(c_index, p_index, tile: int, device):
    """(union index, c's tile slots in its store, the product's, its tile
    count, whether the union is c's own pattern)."""
    from ..block.index import build_index
    from ..block.store import store_layout

    same = index_fingerprint(c_index) == index_fingerprint(p_index)
    rows = np.concatenate([c_index.blk_rows, p_index.blk_rows]).astype(np.int64)
    cols = np.concatenate([c_index.col_idx, p_index.col_idx]).astype(np.int64)
    key = np.unique(rows * max(1, c_index.nblkcols) + cols)
    union, _ = build_index(key // max(1, c_index.nblkcols), key % max(1, c_index.nblkcols),
                           c_index.row_block_sizes, c_index.col_block_sizes)
    same = same or union.nblks == c_index.nblks
    if same:
        union = c_index
    ukeys = store_layout(union, tile).tile_keys()

    def slots(index):
        keys = store_layout(index, tile).tile_keys()
        pos = np.searchsorted(ukeys, keys)
        return torch.as_tensor(pos, dtype=torch.int64, device=device)

    return union, slots(c_index), slots(p_index), len(ukeys), same
