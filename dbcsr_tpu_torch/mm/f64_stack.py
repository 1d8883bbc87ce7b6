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

Run segments: the kernel gives each C tile's run one thread block, and at
T = 128 one block fills an SM, so a launch of a few long runs (RI-HFX's K
product: 144 runs of up to 3,650 entries on 132 SMs) waits on its longest.
``plan_run_segments`` cuts every run whose issued work passes w* = W /
(4·S) (W the launch's issued work, S the card's SMs,
``device_sm_count``) at entry boundaries into ⌈w/w*⌉ segments of about
equal work. A masked stack always carries its segments (``RunSegments``,
built by ``f64_device_stack`` from the entries' issued depths, the same
``entry_depths`` that give the plan's issued flops); where no run is cut,
as in every launch of the water products and on the CPU, they are one
segment a run, the blocks the kernel had without them. A run's first
segment writes its C tile, the others tiles of a workspace (fewer than 4·S
tiles), and ``segment_sum_f64`` (S1, ``csrc/stack_matmul_f64.cu``) adds
those into C in segment order. The plain version sums every run whole, in
stack order, so it never reads the segment plan; S1's own plain version is
``segment_sum_f64_plain``.

The route: ``engine._select_route`` sends every float64 sparse stack
product here, whatever the sparse driver ("auto", "stack" or "panel"), as
the JAX package never gives float64 to its f32 panel or flat kernels. Only
the dense class stays a plain float64 ``torch.mm``. ``f64_method`` selects
between the JAX package's emulations and has nothing to select here;
``f64_slices`` raises (``engine._check_config``).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..block.index import BCSRIndex
from ..block.store import store_layout
from .kernels import (
    DeviceStack,
    _check_stores,
    check_cuda_operands,
    device_stack,
    run_sums_plain,
)

__all__ = [
    "CHUNKED_TILES",
    "MMA_DEPTH",
    "SEGMENTS_PER_SM",
    "SM_FLOPS",
    "SPLIT_LAUNCH_S",
    "HBM_BYTES_PER_S",
    "RunSegments",
    "chunked_hw_flops",
    "depth_flops",
    "device_sm_count",
    "entry_depths",
    "f64_device_stack",
    "list_makespan",
    "split_pays",
    "operand_chunk_masks",
    "plan_run_segments",
    "segment_sum_f64",
    "segment_sum_f64_plain",
    "tile_chunk_masks",
    "tile_stack_matmul_f64",
    "tile_stack_matmul_f64_plain",
]

#: K columns one float64 mma consumes: the granularity of the masks
MMA_DEPTH = 8
#: tile edges at which the kernel reads the masks (its tensor-core routine)
CHUNKED_TILES = (64, 128)
#: a run is cut when its issued work passes W / (SEGMENTS_PER_SM · S): the
#: longest segment is then a quarter of a balanced SM's share
SEGMENTS_PER_SM = 4
#: what a cut has to pay for, measured on an H100 80GB HBM3 (PERF.md, the
#: K6 row): one SM's issued float64 rate on the kernel's tensor-core routine
#: (the water product: 4,044 GFLOP in 100.4 ms on 132 SMs), S1's launch
#: (its CUDA-event time at a few workspace tiles, in seconds), and the HBM
#: rate that S1's bytes move at
SM_FLOPS = 3.05e11
SPLIT_LAUNCH_S = 2.5e-5
HBM_BYTES_PER_S = 3.35e12
#: set bits of every 16-bit word
_POP16 = np.unpackbits(np.arange(1 << 16, dtype=">u2").view(np.uint8)).reshape(-1, 16).sum(
    axis=1).astype(np.int64)


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


def entry_depths(a_chunks: np.ndarray, b_chunks: np.ndarray, a_idx: np.ndarray,
                 b_idx: np.ndarray) -> np.ndarray:
    """int64 [S]: the bits set in both tiles' masks of each stack entry, the
    mma depths the kernel issues for it (the masks never set a bit past
    the tile's depths)."""
    both = (a_chunks[a_idx] & b_chunks[b_idx]).astype(np.int64) & 0xFFFFFFFF
    return _POP16[both & 0xFFFF] + _POP16[both >> 16]


def depth_flops(depths: np.ndarray, tile: int, depth: int = MMA_DEPTH) -> float:
    """The flops the kernel issues for ``depths`` (``entry_depths``): 2·T²·
    ``depth`` for each, a depth standing for ``depth`` K columns."""
    return 2.0 * tile * tile * depth * int(np.asarray(depths).sum())


def chunked_hw_flops(a_chunks: np.ndarray, b_chunks: np.ndarray, a_idx: np.ndarray,
                     b_idx: np.ndarray, tile: int, depth: int = MMA_DEPTH) -> float:
    """The flops the kernel issues over the stack's entries with these masks:
    2·T²·``depth`` for each bit set in both tiles of an entry, a bit standing
    for ``depth`` K columns (the kernel's masks: one mma depth). With every
    bit set it is the tile figure, 2·T³ an entry."""
    return depth_flops(entry_depths(a_chunks, b_chunks, a_idx, b_idx), tile, depth)


def device_sm_count(device) -> int:
    """The SMs of a CUDA device, which a segment plan balances over; 0 for
    any other device (the plain version has no blocks to balance)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.get_device_properties(device).multi_processor_count)


def plan_run_segments(c_ptr: np.ndarray, work: np.ndarray, sms: int):
    """The run segments of a c-sorted stack (runs ``[c_ptr[c], c_ptr[c+1])``)
    whose entries issue ``work`` (any additive unit, int64 [S]), over
    ``sms`` SMs: ``(seg_ptr, seg_out, red_c, red_ptr)`` int64, or None when
    no run is split.

    With W the total work and w* = W / (``SEGMENTS_PER_SM`` · sms), a run of
    work w > w* is cut into ⌈w/w*⌉ segments at the entry boundaries nearest
    to its k·w/⌈w/w*⌉ points (fewer where entries are coarser than that);
    every other run, empty ones included, stays one segment. Segment q
    takes entries ``[seg_ptr[q], seg_ptr[q+1])``, segments in entry order;
    ``seg_out[q]`` is its run's C tile for the run's first segment and -1 -
    w for workspace tile w otherwise, numbered in segment order. Split run
    r (ascending C tiles ``red_c``) owns workspace tiles ``[red_ptr[r],
    red_ptr[r+1])``. Each extra segment stands for more than w* of work, so
    there are fewer than ``SEGMENTS_PER_SM`` · sms workspace tiles."""
    c_ptr = np.asarray(c_ptr, dtype=np.int64)
    cw = np.concatenate(([0], np.cumsum(np.asarray(work, dtype=np.int64))))
    total = int(cw[-1])
    quota = SEGMENTS_PER_SM * int(sms)
    if quota <= 0 or total <= 0:
        return None
    run_w = cw[c_ptr[1:]] - cw[c_ptr[:-1]]
    split = np.flatnonzero(run_w * quota > total)
    if not len(split):
        return None
    parts = -(-run_w[split] * quota // total)
    cuts_per = parts - 1
    run = np.repeat(split, cuts_per)
    k = np.arange(len(run)) - np.repeat(np.cumsum(cuts_per) - cuts_per, cuts_per) + 1
    e0, e1 = c_ptr[run], c_ptr[run + 1]
    target = cw[e0] + run_w[run] * k // np.repeat(parts, cuts_per)
    j = np.clip(np.searchsorted(cw, target), e0 + 1, e1)
    j = np.where(target - cw[j - 1] < cw[j] - target, j - 1, j)  # the nearer boundary
    inside = (j > e0) & (j < e1)
    cuts, first = np.unique(j[inside], return_index=True)
    if not len(cuts):
        return None
    run = run[inside][first]
    n_c = len(c_ptr) - 1
    starts = np.concatenate((c_ptr[:-1], cuts))
    runs = np.concatenate((np.arange(n_c), run))
    order = np.lexsort((starts, runs))
    is_first = order < n_c
    seg_out = np.where(is_first, runs[order], -np.cumsum(~is_first))
    red_c = np.unique(run)
    red_ptr = np.concatenate(([0], np.cumsum(np.bincount(run, minlength=n_c)[red_c])))
    return np.append(starts[order], c_ptr[-1]), seg_out, red_c, red_ptr


@dataclass(frozen=True)
class RunSegments:
    """A float64 stack's run segments (``plan_run_segments``) on the stack's
    device (int32), with their host copies."""

    seg_ptr: torch.Tensor
    seg_out: torch.Tensor
    red_c: torch.Tensor
    red_ptr: torch.Tensor
    seg_ptr_host: np.ndarray
    seg_out_host: np.ndarray
    red_c_host: np.ndarray
    red_ptr_host: np.ndarray

    @classmethod
    def whole(cls, stack: DeviceStack) -> "RunSegments":
        """One segment a run of ``stack``: its blocks as without a table."""
        dev = stack.c_ptr.device
        out = np.arange(stack.n_c, dtype=np.int64)
        return cls(stack.c_ptr, torch.arange(stack.n_c, dtype=torch.int32, device=dev),
                   torch.zeros(0, dtype=torch.int32, device=dev),
                   torch.zeros(1, dtype=torch.int32, device=dev),
                   stack.c_ptr_host, out, np.zeros(0, np.int64), np.zeros(1, np.int64))

    @property
    def n_seg(self) -> int:
        return len(self.seg_out_host)

    @property
    def n_split(self) -> int:
        """Runs cut into more than one segment."""
        return len(self.red_c_host)

    @property
    def n_ws(self) -> int:
        """Workspace tiles: the segments after each split run's first."""
        return int(self.red_ptr_host[-1])


def list_makespan(work: np.ndarray, sms: int) -> float:
    """The finish of a list schedule of blocks of ``work`` (in launch order)
    over ``sms`` SMs, each block to the SM that frees first."""
    free = [0.0] * sms
    for w in np.asarray(work, dtype=np.float64).tolist():
        heapq.heappush(free, heapq.heappop(free) + w)
    return max(free)


def split_pays(c_ptr: np.ndarray, depths: np.ndarray, plan, tile: int, sms: int) -> bool:
    """Whether a segment plan (``plan_run_segments`` of runs ``c_ptr`` whose
    entries issue ``depths``) saves more time than it costs: the list
    schedule of the runs over ``sms`` SMs, one block an SM at ``SM_FLOPS``,
    against that of the segments, and S1's launch and bytes (each workspace
    tile read once, each split C tile read and written once). A launch of
    whole waves of equal runs, or of runs under about an entry's work, is
    not cut: its blocks balance as they are."""
    per_depth = 2.0 * tile * tile * MMA_DEPTH / SM_FLOPS
    _, _, red_c, red_ptr = plan
    cost = SPLIT_LAUNCH_S + (int(red_ptr[-1]) + 2 * len(red_c)) * tile * tile * 8 / HBM_BYTES_PER_S
    cw = np.concatenate(([0], np.cumsum(np.asarray(depths, dtype=np.int64))))
    run_w = cw[c_ptr[1:]] - cw[c_ptr[:-1]]
    if run_w.max() * per_depth <= cost:  # a list schedule ends within W/S + the longest run
        return False
    seg_ptr = plan[0]
    saved = list_makespan(run_w, sms) - list_makespan(cw[seg_ptr[1:]] - cw[seg_ptr[:-1]], sms)
    return saved * per_depth > cost


def f64_device_stack(stack_np: np.ndarray, n_c_tiles: int, device,
                     chunks: Tuple[np.ndarray, np.ndarray], tile: int,
                     depths: Optional[np.ndarray] = None) -> DeviceStack:
    """``device_stack`` with the K masks ``chunks`` of edge-``tile`` tiles
    (64 or 128) and the run segments the float64 kernel launches with: the
    runs of the entries' issued ``depths`` (``entry_depths``, computed here
    when None) planned over the device's SMs (``plan_run_segments``), where
    the cut pays (``split_pays``); else, and on the CPU, one segment a
    run."""
    ds = device_stack(stack_np, n_c_tiles, device, chunks)
    if depths is None:
        stack = np.asarray(stack_np).reshape(-1, 3)
        depths = entry_depths(chunks[0], chunks[1], stack[:, 1], stack[:, 2])
    sms = device_sm_count(device)
    plan = plan_run_segments(ds.c_ptr_host, depths, sms)
    if plan is None or not split_pays(ds.c_ptr_host, depths, plan, tile, sms):
        return replace(ds, segments=RunSegments.whole(ds))

    def upload(x):
        return torch.as_tensor(x.astype(np.int32), device=ds.c_ptr.device)

    return replace(ds, segments=RunSegments(*(upload(x) for x in plan), *plan))


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


def segment_sum_f64_plain(c: torch.Tensor, ws: torch.Tensor, seg: RunSegments) -> torch.Tensor:
    """Plain version of S1 (any device): ``c[red_c[r]] += ws[w]`` for each
    of split run r's workspace tiles w in order, in place; returns ``c``."""
    counts = np.diff(seg.red_ptr_host)
    for j in range(int(counts.max()) if len(counts) else 0):
        rs = np.flatnonzero(counts > j)
        dst = torch.as_tensor(seg.red_c_host[rs], device=c.device)
        src = torch.as_tensor(seg.red_ptr_host[rs] + j, device=c.device)
        c[dst] += ws.index_select(0, src)
    return c


def segment_sum_f64(c: torch.Tensor, ws: torch.Tensor, seg: RunSegments) -> torch.Tensor:
    """S1, the fix-up of a segmented launch of the float64 stack kernel:
    adds each split run's workspace tiles into its C tile, in segment
    order, in place (``[n_c, T, T]`` and ``[n_ws, T, T]`` float64 at T = 64
    or 128). CPU tensors run the plain version; returns ``c``."""
    what = "segment_sum_f64"
    if c.device.type == "cpu":
        return segment_sum_f64_plain(c, ws, seg)
    tile = check_cuda_operands(c, ws, (seg.red_c, seg.red_ptr), what, (torch.float64,))
    if tile not in CHUNKED_TILES:
        raise ValueError(f"{what}: tile edge {tile} not in {CHUNKED_TILES}")
    if ws.shape[0] < seg.n_ws or (seg.n_split and c.shape[0] <= int(seg.red_c_host[-1])):
        raise IndexError(f"{what}: segment table beyond the stores")
    if seg.n_split:
        from .._build import check_launch, kernels

        lib = kernels()
        rc = lib.dbcsr_torch_segment_sum_f64(
            c.data_ptr(), ws.data_ptr(), seg.red_c.data_ptr(), seg.red_ptr.data_ptr(),
            seg.n_split, tile, c.device.index, torch.cuda.current_stream(c.device).cuda_stream,
        )
        check_launch(lib, rc, what)
        segment_sum_f64.launches += 1
    return c


#: launches of S1 since the last reset (set it to 0 to reset)
segment_sum_f64.launches = 0


def tile_stack_matmul_f64(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """``[n_c, T, T]`` float64 tile store of the stack product. CPU tensors
    run the plain version; CUDA tensors launch the kernel (and, for a stack
    with a split run, S1 after it), or raise on another dtype (TypeError),
    a tile edge outside ``KERNEL_TILES``, non-contiguous stores, plan arrays
    elsewhere (ValueError) or stack slots beyond the stores (IndexError)."""
    what = "tile_stack_matmul_f64"
    if a.device.type == "cpu":
        return tile_stack_matmul_f64_plain(a, b, stack)
    chunks = () if stack.a_chunks is None else (stack.a_chunks, stack.b_chunks)
    seg = stack.segments
    seg_arrays = () if seg is None else (seg.seg_ptr, seg.seg_out)
    tile = check_cuda_operands(
        a, b, (stack.c_ptr, stack.a_idx, stack.b_idx, *chunks, *seg_arrays), what,
        (torch.float64,)
    )
    if stack.a_end > a.shape[0] or stack.b_end > b.shape[0]:
        raise IndexError(f"{what}: stack slot beyond the tile stores")
    if chunks and (len(chunks[0]) < stack.a_end or len(chunks[1]) < stack.b_end):
        raise IndexError(f"{what}: stack slot beyond the K occupancy masks")
    if bool(chunks) != (seg is not None):
        raise ValueError(f"{what}: the K masks come with run segments (f64_device_stack)")
    if seg is not None and tile not in CHUNKED_TILES:
        raise ValueError(f"{what}: run segments need a tile edge in {CHUNKED_TILES}")
    from .._build import check_launch, kernels

    out = torch.empty((stack.n_c, tile, tile), dtype=torch.float64, device=a.device)
    if stack.n_c:
        lib = kernels()
        chunk_ptrs = [m.data_ptr() for m in chunks] if chunks else [None, None]
        ws, seg_ptrs, n_seg = None, [None, None, None], 0
        if seg is not None:
            if seg.n_ws:
                ws = torch.empty((seg.n_ws, tile, tile), dtype=torch.float64, device=a.device)
            seg_ptrs = [seg.seg_ptr.data_ptr(), seg.seg_out.data_ptr(),
                        None if ws is None else ws.data_ptr()]
            n_seg = seg.n_seg
        rc = lib.dbcsr_torch_stack_matmul_f64(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), stack.c_ptr.data_ptr(),
            stack.a_idx.data_ptr(), stack.b_idx.data_ptr(), *chunk_ptrs, *seg_ptrs,
            stack.n_c, n_seg, tile, a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, what)
        tile_stack_matmul_f64.launches += 1
        if ws is not None:
            segment_sum_f64(out, ws, seg)
    return out


#: launches of the float64 stack kernel since the last reset (set it to 0
#: to reset)
tile_stack_matmul_f64.launches = 0
