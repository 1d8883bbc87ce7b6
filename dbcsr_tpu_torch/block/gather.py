"""Element-level gather maps for block permutation / transposition.

Port of ``dbcsr_tpu/block/gather.py``. Transformations that cannot be
written at tile granularity (sub-matrix extraction across arbitrary block
subsets, block permutations) are a new index built on the host plus ONE
device element gather through a host-built map. The map builders are numpy
and identical to the JAX package's; ``apply_store_gather`` is the torch
device half, and ``prepare_flat_gather`` a flat map's device form made
once, for callers that repeat a gather (TAS group extraction and merge;
the tensor refold moves whole blocks instead, ``block/refold.py``). Element gathers are slow compared with tile gathers,
so hot paths do not use them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .index import BCSRIndex

__all__ = [
    "block_permutation_gather",
    "block_subset_gather",
    "flat_gather_store_map",
    "StoreGather",
    "apply_prepared_gather",
    "apply_store_gather",
    "apply_flat_gather",
    "prepare_flat_gather",
    "concat_ranges",
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
    src_blk = src_blk_of_new.astype(np.int64)[b]
    base = src_index.blk_offset[src_blk]
    if transpose_src is None:
        return base + t
    bm_new, bn_new = new_index.blk_shapes
    bn = bn_new.astype(np.int64)[b]
    r = t // bn
    c = t - r * bn
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


@dataclass(frozen=True)
class StoreGather:
    """A store-position gather map prepared once on the device: the new
    store's hit positions ``dst`` and the source store positions ``src``
    they copy (int32 when both stores stay under 2³¹ elements, else int64).
    Every other position of the new ``[n_tiles, tile, tile]`` store is 0.
    Iterative callers cache this form, so a call uploads nothing."""

    n_tiles: int
    tile: int
    dst: torch.Tensor
    src: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Device bytes the two index tensors hold."""
        return (self.dst.numel() * self.dst.element_size()
                + self.src.numel() * self.src.element_size())


def _store_gather(n_tiles: int, tile: int, dst: np.ndarray, src: np.ndarray,
                  n_src: int, device) -> StoreGather:
    small = max(n_tiles * tile * tile, n_src) < np.iinfo(np.int32).max
    idt = np.int32 if small else np.int64
    return StoreGather(
        n_tiles=n_tiles, tile=tile,
        dst=torch.as_tensor(dst.astype(idt), device=device),
        src=torch.as_tensor(src.astype(idt), device=device),
    )


def apply_prepared_gather(src_data: torch.Tensor, g: StoreGather,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device half: one element gather through a prepared map; the hits
    are copied into a zero-initialised output (torch has no fill-mode
    gather), or into ``out`` (a ``[n_tiles, tile, tile]`` store, written in
    place: disjoint gathers fill one store). Hit positions are distinct, so
    the copy is deterministic."""
    if out is None:
        out = src_data.new_zeros((g.n_tiles, g.tile, g.tile))
    if g.dst.numel() and src_data.numel():
        out.view(-1)[g.dst] = src_data.reshape(-1)[g.src].to(out.dtype)
    return out


def apply_store_gather(src_data: torch.Tensor, inv: np.ndarray, n_tiles: int,
                       tile: int) -> torch.Tensor:
    """Device half: one element gather through a precomposed map; -1
    positions come out 0 (torch has no fill-mode gather, so the hits are
    copied into a zero-initialised output). Uploads the map on every call:
    callers that repeat a gather hold a ``prepare_flat_gather`` result."""
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
    return apply_prepared_gather(
        src.data, prepare_flat_gather(new_index, tile, src, src_flat_of_new)
    )


def prepare_flat_gather(new_index, tile, src, src_flat_of_new: np.ndarray,
                        elems: Optional[np.ndarray] = None) -> StoreGather:
    """The prepared device form of :func:`apply_flat_gather`'s map: the
    (new store position, source store position) pairs of every new flat
    element with a source (``src_flat_of_new[e] >= 0``). With ``elems``,
    ``src_flat_of_new[i]`` is the source of new flat element ``elems[i]``
    and the others gather 0. The hits of ``flat_gather_store_map``'s map,
    composed per element instead of through a map over the whole new store
    (in flat order, not store order: the positions are distinct, so the
    gather gives the same bits)."""
    from .store import store_layout

    new_lay = store_layout(new_index, tile)
    fmap = np.asarray(src_flat_of_new, np.int64)
    if elems is None:
        hit = fmap >= 0
        if not hit.all():
            elems = np.flatnonzero(hit)
            fmap = fmap[elems]
    dst = new_lay.elem_dest if elems is None else new_lay.elem_dest[elems]
    return _store_gather(new_lay.n_tiles, tile, dst, src.layout.elem_dest[fmap],
                         src.data.numel(), src.device)


def concat_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s + n) for s, n in zip(starts, lengths)])``
    (int64) in three vectorized passes."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    before = np.cumsum(lengths) - lengths
    return np.repeat(starts - before, lengths) + np.arange(int(lengths.sum()), dtype=np.int64)
