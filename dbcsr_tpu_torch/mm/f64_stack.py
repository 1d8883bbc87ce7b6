"""The float64 stack product: the port of K6, with its plain version.

Counterparts in the JAX package: the fused Ozaki panel kernel
``dbcsr_tpu/mm/ozaki_panel.py`` (``_ozaki_panel_kernel``, K6) and its XLA
twin ``dbcsr_tpu/ops/f64_emu.py:194`` (``tile_stack_matmul_ozaki``). Both
emulate float64 with bf16 slices because the TPU has no float64 unit; the
H100 has one, so the port computes the same stack product
``C[c] = Σ A[a]·B[b]`` in native float64.

- ``tile_stack_matmul_f64`` is the wrapper of the hand-written kernel in
  ``csrc/stack_matmul_f64.cu``: it takes the same ``DeviceStack`` as K1
  (``kernels.py``), every tile edge in ``KERNEL_TILES`` and runs of any
  length (K6 admits only T = 128 and at most 8 entries per C tile). CPU
  tensors run the plain version; CUDA tensors launch the kernel or raise.
- ``tile_stack_matmul_f64_plain`` is gather + float64 ``bmm`` + the ordered
  run sums of K1's plain version.

K occupancy: at T = 64 and 128 (``CHUNKED_TILES``) the kernel runs on the
FP64 tensor cores one mma depth (``MMA_DEPTH`` = 8) of K at a time, and a
stack may carry, for every tile of the op(A) and op(B) stores, a bitmask of
the depths that hold a stored block (``tile_chunk_masks``,
``operand_chunk_masks``: from the block index alone, never from data). The
kernel then issues only the depths set in both tiles of an entry; the others
multiply padding, which is exactly 0 by the store invariant, so the product
is the same up to the sign of a zero. The plain version multiplies every
depth, and ``chunked_hw_flops`` counts what the kernel issues.

The route: ``engine._select_route`` sends every float64 sparse stack
product here, whatever the sparse driver ("auto", "stack" or "panel"), as
the JAX package never gives float64 to its f32 panel or flat kernels. Only
the dense class stays a plain float64 ``torch.mm``. ``f64_method`` selects
between the JAX package's emulations and has nothing to select here;
``f64_slices`` raises (``engine._check_config``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..block.index import BCSRIndex
from ..block.store import store_layout
from .kernels import DeviceStack, _check_stores, check_cuda_operands, run_sums_plain

__all__ = [
    "CHUNKED_TILES",
    "MMA_DEPTH",
    "chunked_hw_flops",
    "operand_chunk_masks",
    "tile_chunk_masks",
    "tile_stack_matmul_f64",
    "tile_stack_matmul_f64_plain",
]

#: K columns one float64 mma consumes: the granularity of the masks
MMA_DEPTH = 8
#: tile edges at which the kernel reads the masks (its tensor-core routine)
CHUNKED_TILES = (64, 128)


def _range_bits(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Bitmask of the depths that [lo, hi) (tile-local, hi > lo) touches."""
    first, last = lo // MMA_DEPTH, (hi - 1) // MMA_DEPTH
    return ((np.int64(1) << (last + 1)) - 1) & ~((np.int64(1) << first) - 1)


def tile_chunk_masks(index: BCSRIndex, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(rows, cols)``, int32 ``[n_tiles]`` each, over the store of ``index``
    at tile edge ``tile`` in store order: bit h of ``rows[s]`` is set iff a
    stored block overlaps rows ``8h .. 8h+7`` of tile s, bit h of ``cols[s]``
    the same for its columns. Blocks that straddle depths or tiles set a bit
    in every tile and depth they touch. Cached on the index."""
    if tile % MMA_DEPTH or tile // MMA_DEPTH > 31:
        raise ValueError(f"tile_chunk_masks: tile edge {tile} is not a multiple of "
                         f"{MMA_DEPTH} up to {31 * MMA_DEPTH}")

    def mk():
        lay = store_layout(index, tile)
        r0 = index.row_offsets[index.blk_rows]
        c0 = index.col_offsets[index.col_idx]
        bm, bn = (x.astype(np.int64) for x in index.blk_shapes)
        keep = (bm > 0) & (bn > 0)
        r0, c0, bm, bn = r0[keep], c0[keep], bm[keep], bn[keep]
        tr0, tc0 = r0 // tile, c0 // tile
        nr = (r0 + bm - 1) // tile - tr0 + 1
        nc = (c0 + bn - 1) // tile - tc0 + 1
        # one piece for every (block, tile it touches)
        per = nr * nc
        blk = np.repeat(np.arange(len(r0)), per)
        j = np.arange(len(blk)) - np.repeat(np.cumsum(per) - per, per)
        tr = tr0[blk] + j // nc[blk]
        tc = tc0[blk] + j % nc[blk]
        base_r, base_c = tr * tile, tc * tile
        rbits = _range_bits(np.maximum(r0[blk], base_r) - base_r,
                            np.minimum(r0[blk] + bm[blk], base_r + tile) - base_r)
        cbits = _range_bits(np.maximum(c0[blk], base_c) - base_c,
                            np.minimum(c0[blk] + bn[blk], base_c + tile) - base_c)
        slot = np.searchsorted(lay.tile_keys(), tr * lay.ntc + tc)
        rows = np.zeros(lay.n_tiles, np.int64)
        cols = np.zeros(lay.n_tiles, np.int64)
        for h in range(tile // MMA_DEPTH):
            for out, bits in ((rows, rbits), (cols, cbits)):
                hit = np.zeros(lay.n_tiles, bool)
                hit[slot[((bits >> h) & 1).astype(bool)]] = True
                out |= hit.astype(np.int64) << h
        return rows.astype(np.int32), cols.astype(np.int32)

    return index._cached(("chunk_masks", tile), mk)


def operand_chunk_masks(index: BCSRIndex, tile: int, trans: bool,
                        perm: Optional[np.ndarray], side: str) -> np.ndarray:
    """The masks over K of op(M)'s store, op slot by op slot: for ``side``
    "a" its columns, for "b" its rows. op(M) = Mᵀ swaps M's rows and columns
    and orders the slots by ``perm`` (op slot i is store slot ``perm[i]``)."""
    rows, cols = tile_chunk_masks(index, tile)
    m = cols if (side == "a") != trans else rows
    return m if perm is None else m[perm]


def chunked_hw_flops(a_chunks: np.ndarray, b_chunks: np.ndarray, a_idx: np.ndarray,
                     b_idx: np.ndarray, tile: int, depth: int = MMA_DEPTH) -> float:
    """The flops the kernel issues over the stack's entries with these masks:
    2·T²·``depth`` for each bit set in both tiles of an entry, a bit standing
    for ``depth`` K columns (the kernel's masks: one mma depth). With every
    bit set it is the tile figure, 2·T³ an entry."""
    both = a_chunks[a_idx] & b_chunks[b_idx]
    bits = sum(int(np.count_nonzero((both >> h) & 1)) for h in range(tile // depth))
    return 2.0 * tile * tile * depth * bits


def tile_stack_matmul_f64_plain(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """Plain PyTorch version of the float64 stack kernel (any device): the
    same sums in the same order of runs; the kernel differs only in the
    order of each tile product's own k-sum."""
    _check_stores(a, b, "tile_stack_matmul_f64_plain")
    if a.dtype != torch.float64:
        raise TypeError(f"tile_stack_matmul_f64_plain: needs float64, got {a.dtype}")
    return run_sums_plain(
        a, b, stack.c_ptr_host, stack.a_idx.to(a.device).long(),
        stack.b_idx.to(a.device).long(), torch.float64,
    )


def tile_stack_matmul_f64(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """``[n_c, T, T]`` float64 tile store of the stack product. CPU tensors
    run the plain version; CUDA tensors launch the kernel, or raise on
    another dtype (TypeError), a tile edge outside ``KERNEL_TILES``,
    non-contiguous stores, plan arrays elsewhere (ValueError) or stack
    slots beyond the stores (IndexError)."""
    what = "tile_stack_matmul_f64"
    if a.device.type == "cpu":
        return tile_stack_matmul_f64_plain(a, b, stack)
    chunks = () if stack.a_chunks is None else (stack.a_chunks, stack.b_chunks)
    tile = check_cuda_operands(
        a, b, (stack.c_ptr, stack.a_idx, stack.b_idx, *chunks), what, (torch.float64,)
    )
    if stack.a_end > a.shape[0] or stack.b_end > b.shape[0]:
        raise IndexError(f"{what}: stack slot beyond the tile stores")
    if chunks and (len(chunks[0]) < stack.a_end or len(chunks[1]) < stack.b_end):
        raise IndexError(f"{what}: stack slot beyond the K occupancy masks")
    from .._build import check_launch, kernels

    out = torch.empty((stack.n_c, tile, tile), dtype=torch.float64, device=a.device)
    if stack.n_c:
        lib = kernels()
        chunk_ptrs = [m.data_ptr() for m in chunks] if chunks else [None, None]
        rc = lib.dbcsr_torch_stack_matmul_f64(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), stack.c_ptr.data_ptr(),
            stack.a_idx.data_ptr(), stack.b_idx.data_ptr(), *chunk_ptrs,
            stack.n_c, tile, a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, what)
        tile_stack_matmul_f64.launches += 1
    return out


#: launches of the float64 stack kernel since the last reset (set it to 0
#: to reset)
tile_stack_matmul_f64.launches = 0
