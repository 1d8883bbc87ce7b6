"""Element-level gather maps for block permutation / transposition.

Port of ``dbcsr_tpu/block/gather.py``. Transformations that cannot be
written at tile granularity (sub-matrix extraction across arbitrary block
subsets, block permutations) are a new index built on the host plus ONE
device element gather through a host-built map. The map builders are numpy
and identical to the JAX package's; ``apply_store_gather`` is the torch
device half. Element gathers are slow compared with tile gathers, so hot
paths do not use them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .index import BCSRIndex

__all__ = [
    "block_permutation_gather",
    "block_subset_gather",
    "flat_gather_store_map",
    "apply_store_gather",
    "apply_flat_gather",
]


def block_permutation_gather(
    new_index: BCSRIndex,
    src_index: BCSRIndex,
    src_blk_of_new: np.ndarray,
    transpose_src: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gather map (int64 [new nelems]) pulling each element of the new
    layout from the source flat buffer.

    ``src_blk_of_new[b]`` is the source block id for new block ``b``;
    ``transpose_src[b]`` marks blocks whose source is stored transposed
    (new block = src block **T**).
    """
    if new_index.nblks == 0:
        return np.zeros((0,), dtype=np.int64)
    b = new_index.elem_to_blk.astype(np.int64)
    t = np.arange(new_index.nelems, dtype=np.int64) - new_index.blk_offset[b]
    bm_new, bn_new = new_index.blk_shapes
    bn = bn_new.astype(np.int64)[b]
    r = t // bn
    c = t - r * bn
    src_blk = src_blk_of_new.astype(np.int64)[b]
    base = src_index.blk_offset[src_blk]
    if transpose_src is None:
        return base + t
    tr = transpose_src[b]
    # source stored (bn_new, bm_new) row-major when transposed
    bm = bm_new.astype(np.int64)[b]
    straight = r * bn + c
    flipped = c * bm + r
    return base + np.where(tr, flipped, straight)


def block_subset_gather(index: BCSRIndex, keep_mask: np.ndarray) -> np.ndarray:
    """Element indices (int64) of the blocks kept by ``keep_mask``, in
    canonical order — the data-compaction map for filtering."""
    keep_elem = keep_mask[index.elem_to_blk]
    return np.flatnonzero(keep_elem).astype(np.int64)


def flat_gather_store_map(
    new_index, tile, src_layout, src_flat_of_new: np.ndarray
) -> np.ndarray:
    """Host half of the flat gather: compose the flat-element map with
    both tile-store layouts into one store-position gather map (int64
    [new n_tiles * tile * tile], -1 = gather 0)."""
    from .store import store_layout

    new_lay = store_layout(new_index, tile)
    fmap = np.asarray(src_flat_of_new, np.int64)
    if len(src_layout.elem_dest):
        src_store_pos = np.where(
            fmap >= 0,
            src_layout.elem_dest[np.minimum(fmap, len(src_layout.elem_dest) - 1)],
            -1,
        )
    else:
        src_store_pos = np.full(len(fmap), -1, dtype=np.int64)
    inv = np.full(new_lay.n_tiles * tile * tile, -1, dtype=np.int64)
    inv[new_lay.elem_dest] = src_store_pos
    return inv


def apply_store_gather(src_data: torch.Tensor, inv: np.ndarray, n_tiles: int,
                       tile: int) -> torch.Tensor:
    """Device half: one element gather through a precomposed map; -1
    positions come out 0 (torch has no fill-mode gather, so the hits are
    copied into a zero-initialised output)."""
    out = src_data.new_zeros(n_tiles * tile * tile)
    hit = np.flatnonzero(inv >= 0)
    if len(hit) and src_data.numel():
        dev = src_data.device
        out[torch.as_tensor(hit, device=dev)] = src_data.reshape(-1)[
            torch.as_tensor(inv[hit], device=dev)
        ]
    return out.reshape(n_tiles, tile, tile)


def apply_flat_gather(new_index, tile, src, src_flat_of_new: np.ndarray):
    """Build a new matrix's tile store from a FLAT-layout gather map:
    ``src_flat_of_new[e]`` is the source flat-element position of the new
    matrix's flat element ``e``."""
    from .store import store_layout

    inv = flat_gather_store_map(new_index, tile, src.layout, src_flat_of_new)
    n_tiles = store_layout(new_index, tile).n_tiles
    return apply_store_gather(src.data, inv, n_tiles, tile)
