"""TAS multiply: split the long dimension, replicate the small operand,
multiply per group, merge/sum.

Port of ``dbcsr_tpu/tas/mm.py``'s single-process path (reference
``dbcsr_tas_multiply``, ``src/tas/dbcsr_tas_mm.F:79-782``):

1. pick the largest of (m, k, n) (reference ``max_mm_dim``);
2. estimate the split factor from occupancies (``split_factor_estimate``,
   ``dbcsr_tas_mm.F:1427``; copied unchanged, so both packages choose the
   same ``(long_dim, nsplit)``);
3. extract each group's blocks of the two matrices touching the long
   dimension; the small operand is reused by every group as it is;
4. run an ordinary multiply per group (``mm/engine.py``, the port's
   kernels on a CUDA device);
5. merge disjoint results (m/n split, ``dbcsr_tas_merge:477``) or chain
   the partial products through ``beta`` = 1 (k split,
   ``redistribute_and_sum:783``), filtering once at the end.

``dist=`` reaches the port's ``multiply``: each group multiply then runs
over the distribution's process grid. The mesh-parallel form, every group
at once on ranks of its own, is ``tas/parallel.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..block.bcsr import BCSRMatrix
from ..core.timing import timed
from ..mm.engine import build_multiply_executor, multiply
from ..mm.plan import symbolic_product
from ..mm.plancache import index_fingerprint
from ..ops.norms import block_norms_sq
from ..ops.transform import desymmetrize, transpose
from .matrix import TASMatrix, extract_block_subset, merge_row_groups, tas_from_matrix
from .split import COLSPLIT, ROWSPLIT, TASSplit

__all__ = [
    "tas_multiply",
    "split_factor_estimate",
    "result_index_estimate",
    "BatchedTAS",
]


def _op_dims(m: BCSRMatrix, trans: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(row_block_sizes, col_block_sizes) of op(M)."""
    if trans:
        return m.index.col_block_sizes, m.index.row_block_sizes
    return m.index.row_block_sizes, m.index.col_block_sizes


def split_factor_estimate(
    m_elems: int, k_elems: int, n_elems: int, *, occ_hint: float = 1.0
) -> Tuple[str, int]:
    """Pick the split dimension and factor.

    Reference heuristic (``split_factor_estimate``,
    ``src/tas/dbcsr_tas_mm.F:1427``): split the largest of (m, k, n) so each
    group is roughly square against the geometric mean of the short
    dimensions, weighted by occupancy. Returns (dim, nsplit) with dim in
    {'m','k','n'}. The estimate has no cap (ROADMAP Queue 3).
    """
    dims = {"m": max(m_elems, 1), "k": max(k_elems, 1), "n": max(n_elems, 1)}
    long_dim = max(dims, key=dims.get)
    others = [v for d, v in dims.items() if d != long_dim]
    short = float(np.sqrt(others[0] * others[1]))
    nsplit = max(1, int(round(dims[long_dim] * max(occ_hint, 1e-6) / short)))
    return long_dim, nsplit


def result_index_estimate(
    a: BCSRMatrix,
    transa: str,
    b: BCSRMatrix,
    transb: str,
    *,
    filter_eps: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Predict the product's block index (and effective flops) via the
    norms-matrix trial multiply (``dbcsr_tas_result_index``/
    ``create_block_norms_matrix``, ``src/tas/dbcsr_tas_mm.F:1353,1466``):
    the reference multiplies 1×1 "norm blocks"; the planner runs exactly
    this as a scipy sparse product over block norms."""
    a = desymmetrize(a)
    b = desymmetrize(b)
    ta = transa.upper() in ("T", "C")
    tb = transb.upper() in ("T", "C")
    a_nsq = block_norms_sq(a) if filter_eps is not None else None
    b_nsq = block_norms_sq(b) if filter_eps is not None else None
    symb = symbolic_product(
        a.index, ta, b.index, tb,
        a_norms_sq=a_nsq, b_norms_sq=b_nsq, filter_eps=filter_eps,
    )
    return symb.rows, symb.cols, symb.eff_flops


def _matrix_of(x: Union[TASMatrix, BCSRMatrix]) -> BCSRMatrix:
    """The matrix of a TAS operand (a plain matrix needs no split: the JAX
    package wraps it in a trivial one first, a host array over its long
    dimension on every call)."""
    return x.matrix if isinstance(x, TASMatrix) else x


def tas_multiply(
    transa: str,
    transb: str,
    alpha,
    a: Union[TASMatrix, BCSRMatrix],
    b: Union[TASMatrix, BCSRMatrix],
    beta=0.0,
    c: Optional[Union[TASMatrix, BCSRMatrix]] = None,
    *,
    filter_eps: Optional[float] = None,
    nsplit: Optional[int] = None,
    split_kind: str = "cyclic",
    dist=None,
    return_flops: bool = False,
):
    """Tall-and-skinny multiply ``C := alpha·op(A)·op(B) + beta·C``.

    ``nsplit=None`` uses the occupancy-weighted estimate; ``nsplit=1``
    degenerates to a plain multiply. Returns a :class:`TASMatrix` (or
    ``(result, eff_flops)`` with ``return_flops``).
    """
    ta = transa.upper() in ("T", "C")
    tb = transb.upper() in ("T", "C")
    A = desymmetrize(_matrix_of(a))
    B = desymmetrize(_matrix_of(b))
    Cin = None if c is None else desymmetrize(_matrix_of(c))

    m_bs, ka_bs = _op_dims(A, ta)
    kb_bs, n_bs = _op_dims(B, tb)
    m_e, k_e, n_e = int(m_bs.sum()), int(ka_bs.sum()), int(n_bs.sum())

    if nsplit is None:
        occ = max(A.occupation(), B.occupation(), 1e-6)
        long_dim, nsplit = split_factor_estimate(m_e, k_e, n_e, occ_hint=occ)
    else:
        long_dim = {0: "m", 1: "k", 2: "n"}[int(np.argmax([m_e, k_e, n_e]))]
    nsplit = int(max(1, nsplit))
    mk_split = TASSplit.cyclic if split_kind == "cyclic" else TASSplit.contiguous

    eff_flops = 0.0
    with timed("tas_multiply"):
        if nsplit == 1:
            out, fl = multiply(
                transa, transb, alpha, A, B, beta, Cin,
                filter_eps=filter_eps, dist=dist, return_flops=True,
            )
            eff_flops += fl
        elif long_dim == "m":
            # split op(A) rows; C row groups are disjoint -> merge
            split = mk_split(ROWSPLIT, len(m_bs), nsplit)
            parts: List[Tuple[BCSRMatrix, np.ndarray]] = []
            for g in range(nsplit):
                blocks = split.blocks_of_group(g)
                a_g = (
                    extract_block_subset(A, col_blocks=blocks)
                    if ta
                    else extract_block_subset(A, row_blocks=blocks)
                )
                c_g = None
                if Cin is not None:
                    c_g = extract_block_subset(Cin, row_blocks=blocks)
                out_g, fl = multiply(
                    transa, transb, alpha, a_g, B, beta, c_g,
                    filter_eps=filter_eps, dist=dist, return_flops=True,
                )
                eff_flops += fl
                parts.append((out_g, blocks))
            out = merge_row_groups(parts, m_bs, n_bs, name="tas_product")
        elif long_dim == "n":
            # split op(B) cols; work in the transposed problem and merge
            # rows there: C^T = op(B)^T · op(A)^T (col groups ≡ row groups)
            split = mk_split(COLSPLIT, len(n_bs), nsplit)
            parts = []
            for g in range(nsplit):
                blocks = split.blocks_of_group(g)
                b_g = (
                    extract_block_subset(B, row_blocks=blocks)
                    if tb
                    else extract_block_subset(B, col_blocks=blocks)
                )
                c_g = None
                if Cin is not None:
                    c_g = extract_block_subset(Cin, col_blocks=blocks)
                out_g, fl = multiply(
                    transa, transb, alpha, A, b_g, beta, c_g,
                    filter_eps=filter_eps, dist=dist, return_flops=True,
                )
                eff_flops += fl
                parts.append((transpose(out_g), blocks))
            out_t = merge_row_groups(parts, n_bs, m_bs, name="tas_product^T")
            out = transpose(out_t)
        else:  # long_dim == "k": partial products summed over groups
            split = mk_split(ROWSPLIT, len(ka_bs), nsplit)
            out = Cin
            first = True
            for g in range(nsplit):
                blocks = split.blocks_of_group(g)
                a_g = (
                    extract_block_subset(A, row_blocks=blocks)
                    if ta
                    else extract_block_subset(A, col_blocks=blocks)
                )
                b_g = (
                    extract_block_subset(B, col_blocks=blocks)
                    if tb
                    else extract_block_subset(B, row_blocks=blocks)
                )
                out, fl = multiply(
                    transa, transb, alpha, a_g, b_g,
                    (beta if first else 1.0),
                    out,
                    filter_eps=None,  # filter once at the end, not per partial
                    dist=dist, return_flops=True,
                )
                eff_flops += fl
                first = False
            if filter_eps is not None:
                from ..ops.arithmetic import filter_blocks

                out = filter_blocks(out, filter_eps)

    result = tas_from_matrix(out)
    if return_flops:
        return result, eff_flops
    return result


class BatchedTAS:
    """Batched-multiply state machine
    (``dbcsr_tas_batched_mm_init/finalize``, ``src/tas/dbcsr_tas_mm.F:
    1595-1713``): iterative callers repeat contractions over fixed sparsity
    patterns; the reference caches replicated buffers and split decisions
    across the batch. Here the cache holds plan-once executors keyed by the
    operand patterns' content and the filter: without ``filter_eps``
    :func:`~dbcsr_tpu_torch.mm.engine.build_multiply_executor`, with it
    :func:`~dbcsr_tpu_torch.mm.filtered.build_filtered_executor`, whose
    product comes in mask form (C's superset index, the dropped blocks
    zero). A steady-state call is the device work of one executor; a new
    key is planned under the span ``tensor/plan``.
    """

    def __init__(self):
        self._cache: Dict[tuple, object] = {}

    @staticmethod
    def _pattern_key(transa: str, transb: str, a: BCSRMatrix, b: BCSRMatrix):
        # the content hash of each index (block sizes, row_ptr, col_idx:
        # what the JAX package keys by as raw bytes), cached on the index
        return (transa.upper(), transb.upper(), a.tile, str(a.dtype),
                str(a.device), index_fingerprint(a.index),
                index_fingerprint(b.index))

    def multiply(
        self,
        transa: str,
        transb: str,
        a: Union[TASMatrix, BCSRMatrix],
        b: Union[TASMatrix, BCSRMatrix],
        *,
        filter_eps: Optional[float] = None,
    ) -> BCSRMatrix:
        from ..mm.filtered import build_filtered_executor

        A = desymmetrize(_matrix_of(a))
        B = desymmetrize(_matrix_of(b))
        eps = None if filter_eps is None else float(filter_eps)
        key = self._pattern_key(transa, transb, A, B) + (eps,)
        if key not in self._cache:
            with timed("tensor/plan"):
                self._cache[key] = (
                    build_multiply_executor(transa, transb, A, B) if eps is None
                    else build_filtered_executor(transa, transb, A, B, eps))
        plan = self._cache[key]
        if eps is None:
            fn, c_index, _ = plan
            data = fn(A.data, B.data)
        else:
            c_index = plan.c_index
            data = plan.step(A.data, B.data)[0]
        return BCSRMatrix(name="batched_product", index=c_index, data=data)

    def finalize(self) -> None:
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
        return False
