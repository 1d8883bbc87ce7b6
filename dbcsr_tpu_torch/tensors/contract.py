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

from ..core.errors import dbcsr_assert
from ..core.timing import timed
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
    layouts up front and every contraction in the loop skips the
    element-granular refold entirely.
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
    """Batched tensor contraction (``dbcsr_t_batched_contract_init/finalize``):
    caches the folded-product executor across a batch of contractions over
    fixed sparsity patterns. The operands' layout alignments are refolds,
    whose maps the plan cache keeps (:meth:`Tensor.with_layout`)."""

    def __init__(self):
        self._tas = BatchedTAS()

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
    ) -> Tensor:
        nc1 = tuple(int(x) for x in notcontract_1)
        nc2 = tuple(int(x) for x in notcontract_2)
        c1 = tuple(int(x) for x in contract_1)
        c2 = tuple(int(x) for x in contract_2)
        a2 = a.with_layout(NDMapping(a.ndim, nc1, c1))
        b2 = b.with_layout(NDMapping(b.ndim, c2, nc2))
        out = self._tas.multiply("N", "N", a2.matrix, b2.matrix)
        ndim_c = len(nc1) + len(nc2)
        m1 = tuple(int(x) for x in (map_1 if map_1 is not None else range(len(nc1))))
        m2 = tuple(
            int(x)
            for x in (map_2 if map_2 is not None else range(len(nc1), ndim_c))
        )
        c_bs: list = [None] * ndim_c
        for i, d in enumerate(nc1):
            c_bs[m1[i]] = a.block_sizes[d]
        for i, d in enumerate(nc2):
            c_bs[m2[i]] = b.block_sizes[d]
        return Tensor(
            name="contraction",
            block_sizes=tuple(c_bs),
            mapping=NDMapping(ndim_c, m1, m2),
            matrix=out,
        )

    def finalize(self):
        self._tas.finalize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
        return False
