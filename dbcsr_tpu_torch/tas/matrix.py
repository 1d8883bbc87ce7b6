"""TAS matrix type + block-subset extraction/merge utilities.

Port of ``dbcsr_tpu/tas/matrix.py`` (reference ``dbcsr_tas_type``,
``src/tas/dbcsr_tas_types.F:78-100``): a TAS matrix wraps an ordinary BCSR
matrix plus split info for its long dimension. The group map is
materialized (int32 per block of the long dimension only).

Extraction and merge are a host index rebuild plus element gathers through
``block/gather.py``, as in the JAX package. Iterative callers extract and
merge the same patterns every call, so the prepared device form of each
gather (``prepare_flat_gather``) is kept in the plan cache under the
content of the indices and selections, within the cache's byte budget
(``PlanCache.max_bytes``; the JAX package keeps none of these maps), and a
repeated call uploads nothing. The merge writes each part's elements into
one store: the parts are disjoint, so that is the JAX package's sum of
per-part stores without ``nsplit`` full-size temporaries.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.gather import apply_prepared_gather, concat_ranges, prepare_flat_gather
from ..block.index import build_index
from ..core.errors import dbcsr_assert
from ..mm.plancache import array_fingerprint, get_plan_cache, index_fingerprint
from .split import COLSPLIT, ROWSPLIT, TASSplit

__all__ = [
    "TASMatrix", "tas_from_matrix", "extract_block_subset", "merge_row_groups",
    "merge_col_groups",
]


@dataclass(frozen=True)
class TASMatrix:
    """A BCSR matrix + split of its long dimension."""

    matrix: BCSRMatrix
    split: TASSplit

    def __post_init__(self):
        nblk = (
            self.matrix.nblkrows
            if self.split.rowcol == ROWSPLIT
            else self.matrix.nblkcols
        )
        dbcsr_assert(
            self.split.nblk_long == nblk,
            "split length does not match the split dimension",
        )

    @property
    def nsplit(self) -> int:
        return self.split.nsplit

    @property
    def name(self) -> str:
        return self.matrix.name

    @property
    def shape(self) -> Tuple[int, int]:
        return self.matrix.shape

    def group_matrix(self, g: int) -> Tuple[BCSRMatrix, np.ndarray]:
        """The compacted submatrix of group ``g`` plus the global block ids
        of its (compacted) long dimension — the analog of the reference's
        per-subgroup local matrix (``dbcsr_tas_split.F`` subgroup views)."""
        blocks = self.split.blocks_of_group(g)
        if self.split.rowcol == ROWSPLIT:
            sub = extract_block_subset(self.matrix, row_blocks=blocks)
        else:
            sub = extract_block_subset(self.matrix, col_blocks=blocks)
        return sub, blocks

    def with_split(self, split: TASSplit) -> "TASMatrix":
        """Change the split layout (``dbcsr_tas_reshape`` analog,
        ``src/tas/dbcsr_tas_reshape_ops.F:95``): metadata only, group
        extraction picks different blocks."""
        return replace(self, split=split)


def tas_from_matrix(
    m: BCSRMatrix,
    *,
    rowcol: Optional[str] = None,
    nsplit: int = 1,
    split: Optional[TASSplit] = None,
) -> TASMatrix:
    """Wrap a matrix as TAS. With no explicit split, the longer block
    dimension is chosen and split cyclically."""
    if split is None:
        if rowcol is None:
            rowcol = ROWSPLIT if m.nblkrows >= m.nblkcols else COLSPLIT
        nblk = m.nblkrows if rowcol == ROWSPLIT else m.nblkcols
        split = TASSplit.cyclic(rowcol, nblk, nsplit)
    return TASMatrix(matrix=m, split=split)


def extract_block_subset(
    m: BCSRMatrix,
    *,
    row_blocks: Optional[np.ndarray] = None,
    col_blocks: Optional[np.ndarray] = None,
) -> BCSRMatrix:
    """Compacted submatrix over a subset of block rows and/or columns.

    The new matrix's block dimensions are the subsets themselves (global
    block ``row_blocks[i]`` becomes block row ``i``). One host index rebuild
    plus one device gather (prepared once per pattern and selection) — the
    form of the reference's subgroup matrix extraction inside TAS reshape
    (``dbcsr_tas_reshape_ops.F``).
    """
    dbcsr_assert(m.sym == SYM_NONE, "desymmetrize before subset extraction")
    idx = m.index
    rows_sel = (
        np.arange(idx.nblkrows, dtype=np.int32)
        if row_blocks is None
        else np.asarray(row_blocks, dtype=np.int32)
    )
    cols_sel = (
        np.arange(idx.nblkcols, dtype=np.int32)
        if col_blocks is None
        else np.asarray(col_blocks, dtype=np.int32)
    )
    pcache = get_plan_cache()
    key = ("extract_block_subset", index_fingerprint(idx), m.tile, str(m.device),
           array_fingerprint(rows_sel, cols_sel))
    hit = pcache.get(key)
    if hit is not None:
        new_index, gather = hit
    else:
        # old -> new block-row/col id (-1 = dropped)
        rmap = np.full(idx.nblkrows, -1, dtype=np.int64)
        rmap[rows_sel] = np.arange(len(rows_sel))
        cmap = np.full(idx.nblkcols, -1, dtype=np.int64)
        cmap[cols_sel] = np.arange(len(cols_sel))
        old_rows = idx.blk_rows
        old_cols = idx.col_idx
        keep = (rmap[old_rows] >= 0) & (cmap[old_cols] >= 0)
        kept = np.flatnonzero(keep)
        new_index, order = build_index(
            rmap[old_rows[kept]],
            cmap[old_cols[kept]],
            idx.row_block_sizes[rows_sel],
            idx.col_block_sizes[cols_sel],
        )
        src_blks = kept[order].astype(np.int64)
        # flat-layout gather map (blocks are contiguous runs), composed with
        # the tile-store layouts into one device gather
        from ..block.gather import block_permutation_gather

        gather = None
        if new_index.nblks:
            gmap = block_permutation_gather(new_index, idx, src_blks)
            gather = prepare_flat_gather(new_index, m.tile, m, gmap)
        pcache.put(key, (new_index, gather), nbytes=gather.nbytes if gather else 0)
    if gather is not None:
        data = apply_prepared_gather(m.data, gather)
    else:
        data = m.data.new_zeros((0, m.tile, m.tile))
    return BCSRMatrix(name=m.name, index=new_index, data=data, sym=SYM_NONE)


def merge_row_groups(
    parts: List[Tuple[BCSRMatrix, np.ndarray]],
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
    *,
    name: str = "merged",
    dtype=None,
    device=None,
) -> BCSRMatrix:
    """Assemble a full matrix from disjoint row-group submatrices.

    ``parts`` — (submatrix, global row-block ids of its rows). The inverse
    of per-group extraction; analog of ``dbcsr_tas_merge``
    (``src/tas/dbcsr_tas_mm.F:477``) for the row-split case. ``dtype`` and
    ``device`` serve an empty ``parts`` only.
    """
    return _merge_groups(
        parts, row_block_sizes, col_block_sizes, map_rows=True, name=name,
        dtype=dtype, device=device,
    )


def merge_col_groups(
    parts: List[Tuple[BCSRMatrix, np.ndarray]],
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
    *,
    name: str = "merged",
    dtype=None,
    device=None,
) -> BCSRMatrix:
    """Assemble a full matrix from disjoint column-group submatrices
    (``parts`` carry global col-block ids) — the colsplit twin of
    :func:`merge_row_groups` (``dbcsr_tas_merge`` handles both via the
    split's rowcol flag, ``src/tas/dbcsr_tas_split.F:60``)."""
    return _merge_groups(
        parts, row_block_sizes, col_block_sizes, map_rows=False, name=name,
        dtype=dtype, device=device,
    )


def _merge_groups(
    parts: List[Tuple[BCSRMatrix, np.ndarray]],
    row_block_sizes: np.ndarray,
    col_block_sizes: np.ndarray,
    *,
    map_rows: bool,
    name: str,
    dtype=None,
    device=None,
) -> BCSRMatrix:
    nnz = sum(sub.nblks for sub, _ in parts)
    if nnz == 0:
        dbcsr_assert(bool(parts) or device is not None,
                     "merging no parts needs an explicit device")
        return BCSRMatrix.empty(
            row_block_sizes, col_block_sizes, name=name,
            dtype=dtype or (parts[0][0].dtype if parts else torch.float32),
            device=parts[0][0].device if parts else device,
            tile=parts[0][0].tile if parts else None,
        )
    tile = parts[0][0].tile
    dev = parts[0][0].device
    pcache = get_plan_cache()
    key = ("merge_groups", map_rows, tile, str(dev),
           array_fingerprint(row_block_sizes, col_block_sizes),
           tuple((index_fingerprint(sub.index), array_fingerprint(blocks))
                 for sub, blocks in parts))
    hit = pcache.get(key)
    if hit is not None:
        new_index, gathers = hit
    else:
        rows_all: List[np.ndarray] = []
        cols_all: List[np.ndarray] = []
        part_of_blk: List[np.ndarray] = []
        offsets = []
        for p, (sub, blocks_of) in enumerate(parts):
            bmap = np.asarray(blocks_of, dtype=np.int64)
            if map_rows:
                rows_all.append(bmap[sub.index.blk_rows].astype(np.int32))
                cols_all.append(sub.index.col_idx)
            else:
                rows_all.append(sub.index.blk_rows)
                cols_all.append(bmap[sub.index.col_idx].astype(np.int32))
            part_of_blk.append(np.full(sub.nblks, p, dtype=np.int32))
            offsets.append(sub.index.blk_offset[:-1])
        rows = np.concatenate(rows_all)
        cols = np.concatenate(cols_all)
        part_ids = np.concatenate(part_of_blk)
        blk_src_off = np.concatenate(offsets)
        new_index, order = build_index(rows, cols, row_block_sizes, col_block_sizes)
        # per-part flat gather maps into the merged matrix (block row groups
        # are disjoint: each merged block is one part's block, copied whole)
        new_off = new_index.blk_offset
        sizes = np.diff(new_off)
        src_off = blk_src_off[order]
        part_of_new = part_ids[order]
        gathers = []
        for p, (sub, _) in enumerate(parts):
            nb = np.flatnonzero(part_of_new == p)
            gathers.append(prepare_flat_gather(
                new_index, tile, sub, concat_ranges(src_off[nb], sizes[nb]),
                elems=concat_ranges(new_off[nb], sizes[nb]),
            ))
        pcache.put(key, (new_index, gathers), nbytes=sum(g.nbytes for g in gathers))
    out_dtype = parts[0][0].dtype
    for sub, _ in parts[1:]:
        out_dtype = torch.promote_types(out_dtype, sub.dtype)
    data = None
    for (sub, _), g in zip(parts, gathers):
        data = apply_prepared_gather(
            sub.data,
            g,
            out=data if data is not None else torch.zeros(
                (g.n_tiles, tile, tile), dtype=out_dtype, device=dev),
        )
    if len(parts) > 1:
        # the JAX package sums the parts' stores; x + 0 turns -0.0 into +0.0,
        # and so does this, so that both give the same bits
        data.add_(0.0)
    return BCSRMatrix(name=name, index=new_index, data=data, sym=SYM_NONE)
