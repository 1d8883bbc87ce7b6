"""Block-granular refold of a tensor's tile store: every stored block moves
from one fold (its nd→2d mapping) to another, its elements permuted inside
the block, through maps of a few numbers a block.

A rank-N tensor's block of natural sizes (s_0, .., s_{N-1}) is a 2-D block
of its fold: rows run row-major over the fold's row dims, columns over its
column dims (``tensors/index.py``). A refold keeps the nd blocks and
changes the fold, so element (i_0, .., i_{N-1}) of a block moves from
(row, col) of the old fold to (row', col') of the new one, each given by
the block's sizes and the two mappings alone. ``refold_plan`` keeps, for
every block of the new index, its natural sizes and the element origins of
its old and new 2-D blocks; ``apply_refold`` moves the data:

* on a card, ``block_refold_kernel`` (``csrc/block_refold.cu``): one
  thread block a tensor block, a thread an element in the new block's
  storage order, each position found through a dense lookup of the two
  stores' tiles (``int32 [tile rows × tile cols]``, -1 where no tile). A
  card's refold the kernel does not take (a rank above 4, a tile grid of
  more than ``MAX_LUT_CELLS`` cells) raises;
* on the CPU, the plain version: a class of equal block sizes at a time,
  the in-block permutation of the class once, the store positions by
  ``searchsorted`` over the tile keys.

Both copy each element's bits, so they equal the element-granular gather
of the JAX package's ``with_layout`` bit for bit, padding zero.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.errors import dbcsr_assert
from ..core.stats import get_stats
from .index import BCSRIndex
from .store import store_layout

__all__ = ["RefoldPlan", "refold_plan", "apply_refold", "refold_plain", "MAX_REFOLD_DIMS"]

#: tensor ranks the kernel takes (the plain version takes any)
MAX_REFOLD_DIMS = 4
#: tile-grid cells past which the lookups are not built (1 GiB of int32)
MAX_LUT_CELLS = 1 << 28
#: elements a chunk of the plain version handles at once
_PLAIN_CHUNK = 1 << 24


@dataclass(frozen=True)
class RefoldPlan:
    """What moving a store from ``old`` to ``new`` fold takes. Per block of
    the new index (in its order): ``sizes`` the natural sizes (1 past the
    rank), ``src`` and ``dst`` the element row and column where the old and
    the new 2-D block start."""

    tile: int
    ndim: int
    old_order: Tuple[int, ...]  # storage dim order of the old fold
    old_nrow: int  # its row dims
    new_order: Tuple[int, ...]
    new_nrow: int
    sizes: np.ndarray  # int32 [n_blocks, max(ndim, MAX_REFOLD_DIMS)]
    src: np.ndarray  # int64 [n_blocks, 2]
    dst: np.ndarray  # int64 [n_blocks, 2]
    src_keys: np.ndarray  # sorted row-major tile ids of the old store
    src_ntc: int
    dst_keys: np.ndarray
    dst_ntc: int
    nelems: int
    max_block: int  # elements of the largest block
    device: torch.device
    # the kernel's device arrays (None off a card, and where the kernel
    # does not take the refold: ``refusal`` says why)
    refusal: Optional[str] = None
    meta: Optional[torch.Tensor] = None  # int64 [n_blocks, 4]: src row, col, dst row, col
    dims: Optional[torch.Tensor] = None  # int32 [n_blocks, MAX_REFOLD_DIMS]
    src_lut: Optional[torch.Tensor] = None
    dst_lut: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        return len(self.sizes)

    @property
    def n_tiles(self) -> int:
        return len(self.dst_keys)

    @property
    def nbytes(self) -> int:
        """Device memory the plan holds (the plan cache's budget)."""
        dev = [x for x in (self.meta, self.dims, self.src_lut, self.dst_lut) if x is not None]
        return sum(x.numel() * x.element_size() for x in dev)

    def moved_bytes(self, itemsize: int) -> int:
        """Block elements read and written."""
        return 2 * self.nelems * itemsize


def _positions(order: Sequence[int]) -> np.ndarray:
    pos = np.arange(MAX_REFOLD_DIMS, dtype=np.int64)
    pos[list(order)] = np.arange(len(order))
    return pos


def refold_plan(old_index: BCSRIndex, new_index: BCSRIndex, src_blk_of_new: np.ndarray,
                natural_sizes: np.ndarray, old_order: Sequence[int], old_nrow: int,
                new_order: Sequence[int], new_nrow: int, tile: int, device) -> RefoldPlan:
    """The plan that moves a store over ``old_index`` to one over
    ``new_index``: new block b is old block ``src_blk_of_new[b]`` whose
    natural sizes are ``natural_sizes[b]`` (``[n_blocks, ndim]``), stored in
    the old fold with storage dim order ``old_order`` (its first
    ``old_nrow`` dims the rows) and in the new with ``new_order``,
    ``new_nrow``."""
    ndim = len(old_order)
    dbcsr_assert(sorted(old_order) == sorted(new_order) == list(range(ndim)),
                 "refold: the orders must permute the same dims")
    nb = new_index.nblks
    sizes = np.ones((nb, max(ndim, MAX_REFOLD_DIMS)), dtype=np.int32)
    sizes[:, :ndim] = natural_sizes
    ob = np.asarray(src_blk_of_new, dtype=np.int64)
    src = np.stack([old_index.row_offsets[old_index.blk_rows[ob]],
                    old_index.col_offsets[old_index.col_idx[ob]]], axis=1).astype(np.int64)
    dst = np.stack([new_index.row_offsets[new_index.blk_rows],
                    new_index.col_offsets[new_index.col_idx]], axis=1).astype(np.int64)
    elems = np.prod(sizes.astype(np.int64), axis=1)
    src_lay, dst_lay = store_layout(old_index, tile), store_layout(new_index, tile)
    dev = torch.device(device)
    kw = {}
    cells = max(src_lay.ntr * src_lay.ntc, dst_lay.ntr * dst_lay.ntc)
    if ndim > MAX_REFOLD_DIMS:
        kw = dict(refusal=f"a rank-{ndim} tensor (the kernel takes up to {MAX_REFOLD_DIMS})")
    elif cells > MAX_LUT_CELLS:
        kw = dict(refusal=f"a tile grid of {cells} cells (the kernel's lookups take up to "
                          f"{MAX_LUT_CELLS})")
    elif dev.type == "cuda":
        kw = dict(meta=torch.as_tensor(np.concatenate([src, dst], axis=1), device=dev),
                  dims=torch.as_tensor(sizes, device=dev),
                  src_lut=_lut(src_lay.tile_keys(), src_lay.ntr * src_lay.ntc, dev),
                  dst_lut=_lut(dst_lay.tile_keys(), dst_lay.ntr * dst_lay.ntc, dev))
    return RefoldPlan(
        tile=tile, ndim=ndim, old_order=tuple(int(x) for x in old_order), old_nrow=int(old_nrow),
        new_order=tuple(int(x) for x in new_order), new_nrow=int(new_nrow), sizes=sizes,
        src=src, dst=dst, src_keys=src_lay.tile_keys(), src_ntc=src_lay.ntc,
        dst_keys=dst_lay.tile_keys(), dst_ntc=dst_lay.ntc,
        nelems=int(elems.sum()), max_block=int(elems.max(initial=0)), device=dev, **kw)


def _lut(keys: np.ndarray, cells: int, device) -> torch.Tensor:
    lut = torch.full((max(cells, 1),), -1, dtype=torch.int32, device=device)
    lut[torch.as_tensor(keys, device=device)] = torch.arange(
        len(keys), dtype=torch.int32, device=device)
    return lut


def _in_block(plan: RefoldPlan, shape: Tuple[int, ...]) -> Tuple[np.ndarray, ...]:
    """For one class of natural sizes, each element in the new block's
    storage order: its (row, col) in the new 2-D block and in the old."""
    s = np.asarray(shape, dtype=np.int64)
    grid = np.indices([int(s[d]) for d in plan.new_order]).reshape(plan.ndim, -1)
    nat = np.empty_like(grid)
    nat[list(plan.new_order)] = grid

    def fold(dims):
        out = np.zeros(grid.shape[1], dtype=np.int64)
        for d in dims:
            out = out * s[d] + nat[d]
        return out

    no, oo = plan.new_order, plan.old_order
    return (fold(no[:plan.new_nrow]), fold(no[plan.new_nrow:]),
            fold(oo[:plan.old_nrow]), fold(oo[plan.old_nrow:]))


def refold_plain(src: torch.Tensor, plan: RefoldPlan, out: torch.Tensor) -> None:
    """Plain version of the kernel (any device; ``apply_refold`` runs it on
    the CPU alone): ``out`` (zero) gets every block's elements from
    ``src``, one class of equal sizes at a time."""
    dev, t = src.device, plan.tile
    flat_src, flat_dst = src.reshape(-1), out.view(-1)
    skeys = torch.as_tensor(plan.src_keys, device=dev)
    dkeys = torch.as_tensor(plan.dst_keys, device=dev)
    code = np.ravel_multi_index(plan.sizes[:, :plan.ndim].T.astype(np.int64),
                                np.full(plan.ndim, int(plan.sizes.max(initial=1)) + 1))
    order = np.argsort(code, kind="stable")
    bounds = list(np.flatnonzero(np.r_[True, np.diff(code[order]) != 0])) + [len(order)]
    for i in range(len(bounds) - 1):
        ids = order[bounds[i]:bounds[i + 1]]
        shape = tuple(int(x) for x in plan.sizes[ids[0], :plan.ndim])
        rn, cn, ro, co = (torch.as_tensor(x, device=dev) for x in _in_block(plan, shape))
        step = max(1, _PLAIN_CHUNK // max(1, len(rn)))
        for s in range(0, len(ids), step):
            part = ids[s:s + step]
            base_s = torch.as_tensor(plan.src[part], device=dev)
            base_d = torch.as_tensor(plan.dst[part], device=dev)
            spos = _store_pos(base_s[:, :1] + ro, base_s[:, 1:] + co, skeys, plan.src_ntc, t)
            dpos = _store_pos(base_d[:, :1] + rn, base_d[:, 1:] + cn, dkeys, plan.dst_ntc, t)
            flat_dst[dpos.reshape(-1)] = flat_src[spos.reshape(-1)]


def _store_pos(r: torch.Tensor, c: torch.Tensor, keys: torch.Tensor, ntc: int,
               t: int) -> torch.Tensor:
    slot = torch.searchsorted(keys, (r // t) * ntc + c // t)
    return slot * (t * t) + (r % t) * t + c % t


def _check(src: torch.Tensor, plan: RefoldPlan) -> None:
    t = plan.tile
    if src.dim() != 3 or tuple(src.shape[1:]) != (t, t) or src.shape[0] != len(plan.src_keys):
        raise ValueError(f"apply_refold: store of shape {tuple(src.shape)}, the plan "
                         f"reads [{len(plan.src_keys)}, {t}, {t}]")
    if not src.is_contiguous():
        raise ValueError("apply_refold: the store must be contiguous")
    if src.device != plan.device:
        raise ValueError(f"apply_refold: store on {src.device}, plan on {plan.device}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"apply_refold: no kernel for device {src.device}")
    if src.device.type == "cuda" and plan.meta is None:
        raise ValueError(f"apply_refold: {plan.refusal}, which the kernel does not take")


def apply_refold(src: torch.Tensor, plan: RefoldPlan) -> torch.Tensor:
    """The store in the new fold: ``[plan.n_tiles, T, T]``, every block
    moved, zero elsewhere. A CUDA store launches ``block_refold_kernel``
    (and raises where the kernel does not take the plan); a CPU store runs
    the plain version."""
    _check(src, plan)
    t = plan.tile
    out = torch.zeros((plan.n_tiles, t, t), dtype=src.dtype, device=src.device)
    if not plan.n_blocks:
        return out
    if src.device.type == "cpu":
        refold_plain(src, plan, out)
    else:
        _launch(src, out, plan)
    get_stats().refold_bytes += plan.moved_bytes(src.element_size())
    return out


def _pack(order: Sequence[int]) -> int:
    """Each dim's position in a storage order, 4 bits a dim."""
    return int(sum(int(p) << (4 * d) for d, p in enumerate(_positions(order))))


def _launch(src: torch.Tensor, out: torch.Tensor, plan: RefoldPlan) -> None:
    from .._build import check_launch, kernels

    t = plan.tile
    if t & (t - 1) or src.element_size() not in (2, 4, 8, 16) or plan.max_block >= 1 << 31:
        raise ValueError(f"apply_refold: tile {t}, element size {src.element_size()} "
                         "or a block of 2^31 elements, which the kernel does not take")
    lib = kernels()
    rc = lib.dbcsr_torch_block_refold(
        src.data_ptr(), out.data_ptr(), plan.meta.data_ptr(), plan.dims.data_ptr(),
        plan.src_lut.data_ptr(), plan.dst_lut.data_ptr(), plan.src_ntc, plan.dst_ntc,
        plan.n_blocks, plan.old_nrow, plan.new_nrow, _pack(plan.old_order),
        _pack(plan.new_order), int(t).bit_length() - 1, src.element_size(),
        src.device.index, torch.cuda.current_stream(src.device).cuda_stream)
    check_launch(lib, rc, "apply_refold")
    apply_refold.launches += 1


#: kernel launches since the last reset (set it to 0 to reset)
apply_refold.launches = 0
