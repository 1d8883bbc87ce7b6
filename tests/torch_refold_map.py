"""The refold's element-granular form, which the port's block-granular
refold (``dbcsr_tpu_torch/block/refold.py``) is held to: the JAX package's
per-block loop of ``with_layout``, as it is, and the store gather through
it."""
from typing import Dict, Tuple

import numpy as np

from dbcsr_tpu_torch.block.gather import apply_store_gather, flat_gather_store_map
from dbcsr_tpu_torch.block.index import build_index
from dbcsr_tpu_torch.block.store import store_layout
from dbcsr_tpu_torch.tensors.index import grouped_block_sizes


def refold_flat_map(block_sizes, old, new, bis: np.ndarray, old_offsets: np.ndarray,
                    order: np.ndarray, nelems: int) -> np.ndarray:
    """The refold's flat element map (int64 [nelems]): per block of the new
    index (``order[nb]`` is its source block), the source block's elements
    transposed from the old storage order to the new one."""
    old_order = old.dim_order
    new_order = new.dim_order
    # axes to pass to transpose: position of each new-order dim in old order
    axes = tuple(old_order.index(d) for d in new_order)
    gmap = np.empty(nelems, dtype=np.int64)
    pos = 0
    perm_cache: Dict[Tuple[int, ...], np.ndarray] = {}
    for nb in range(len(order)):
        ob = int(order[nb])  # source block id (build_index perm)
        bi = bis[ob]
        shp_old = tuple(int(block_sizes[d][bi[d]]) for d in old_order)
        if shp_old not in perm_cache:
            perm_cache[shp_old] = np.transpose(
                np.arange(int(np.prod(shp_old)), dtype=np.int64).reshape(shp_old),
                axes=axes,
            ).reshape(-1)
        n = perm_cache[shp_old].size
        gmap[pos:pos + n] = int(old_offsets[ob]) + perm_cache[shp_old]
        pos += n
    return gmap


def element_map_refold(t, target):
    """``t``'s tile store refolded to ``target`` through the element map."""
    bis = t.block_indices()
    rows, cols = target.fold(bis, t.nblk_per_dim)
    new_index, order = build_index(rows, cols,
                                   grouped_block_sizes(list(t.block_sizes), list(target.map1)),
                                   grouped_block_sizes(list(t.block_sizes), list(target.map2)))
    gmap = refold_flat_map(t.block_sizes, t.mapping, target, bis,
                           t.matrix.index.blk_offset, order, new_index.nelems)
    inv = flat_gather_store_map(new_index, t.matrix.tile, t.matrix.layout, gmap)
    return apply_store_gather(t.matrix.data, inv, store_layout(new_index, t.matrix.tile).n_tiles,
                              t.matrix.tile)
