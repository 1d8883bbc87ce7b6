"""K1, the flat tile-stack kernel, and K4, the grouped kernel: wrappers,
plain versions and CUDA bindings.

``tile_stack_matmul`` computes ``C[c] = Σ A[a]·B[b]`` over a stack of
(c, a, b) tile triples sorted by c — the port of
``dbcsr_tpu/mm/kernels.py:tile_stack_matmul_pallas``. For CUDA tensors it
launches the hand-written kernel in ``csrc/stack_matmul.cu`` (one block per
C tile walking that tile's run of entries in stack order; f32
accumulation; each C tile written once, no atomics) or raises. For CPU
tensors, and only for them, it runs the plain version
``tile_stack_matmul_plain``: ``index_select`` + ``bmm`` + a sorted-segment
reduction that adds each run's products in stack order.

Precision is fixed by the input dtype, never by ambient torch state:
float32 inputs are multiplied in IEEE float32 (the kernel runs FFMA; the
plain version turns TF32 off around its ``bmm``); bfloat16 inputs are
widened to float32 first, so every product is exact and only the float32
sums round. float64 stacks take their own kernel (``f64_stack.py``); the
plain version here sums float64 in float64.

``tile_stack_matmul_grouped`` computes the same product by the group plan
of ``dbcsr_tpu/mm/kernels.py:_plan_groups`` (copied here): groups of at most
``group`` C tiles whose distinct A tiles fit ``cache`` slots, entries packed
``[out_local:3][a_slot:8][b_tile:20]`` — the port of
``tile_stack_matmul_grouped`` there. CUDA tensors launch
``csrc/grouped_matmul.cu`` (one block per output row walking that row's
contiguous entries in stack order) or raise. When no C run is split across
groups the kernel writes the ``[n_c, T, T]`` C store itself through the
plan's row → slot map (no padded copy of C, no join); when one is, it
writes a padded ``[n_groups·group, T, T]`` array whose partial sums are
joined by the ordered segment sum of ``block/tileops.py``, never
``index_add_``. CPU tensors run ``tile_stack_matmul_grouped_plain``. The
grouped kernel also takes float64 stores (float64 sums), for an explicit
``mm_driver="grouped"`` on float64 data.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from .f64_stack import RunSegments

__all__ = [
    "KERNEL_TILES",
    "accumulator_dtype",
    "DeviceStack",
    "device_stack",
    "stack_of_runs",
    "tf32_matmul",
    "tile_stack_matmul",
    "tile_stack_matmul_plain",
    "DeviceGroupPlan",
    "device_group_plan",
    "tile_stack_matmul_grouped",
    "tile_stack_matmul_grouped_plain",
]

#: tile edges the CUDA kernels are instantiated for
KERNEL_TILES = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: dtype codes of the kernels that are also instantiated for float64 (K4, K5)
DTYPE_CODE_F64 = {**_DTYPE_CODE, torch.float64: 2}
#: stack entries gathered per step of the plain version (bounds its scratch:
#: 3 · 8192 · T² floats, 1.6 GB at T=128)
PLAIN_CHUNK = 8192


@contextmanager
def tf32_matmul(enabled: bool) -> Iterator[None]:
    """Pin torch's float32 matmul precision for the enclosed calls (TF32 on
    or off), restoring the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@dataclass(frozen=True)
class DeviceStack:
    """A c-sorted stack as the flat kernel reads it, resident on one
    device: run offsets ``c_ptr`` (C tile c owns entries
    ``[c_ptr[c], c_ptr[c+1])``) and the a/b columns. Built once per plan
    (``device_stack``) and reused by every call."""

    n_c: int
    c_ptr: torch.Tensor  # int32 [n_c+1]
    a_idx: torch.Tensor  # int32 [S]
    b_idx: torch.Tensor  # int32 [S]
    c_ptr_host: np.ndarray  # int64 [n_c+1]
    a_end: int  # 1 + largest a slot (0 when empty): A must hold this many
    b_end: int
    #: the float64 kernel's K occupancy of each op(A) and op(B) tile (int32,
    #: one entry a tile of the stores, ``f64_stack.py``), or None: every depth
    a_chunks: Optional[torch.Tensor] = None
    b_chunks: Optional[torch.Tensor] = None
    #: the float64 kernel's run segments (``f64_stack.RunSegments``), with
    #: the masks, or None (no masks)
    segments: Optional[RunSegments] = None

    @property
    def split_runs(self) -> int:
        """Runs cut into more than one segment."""
        return 0 if self.segments is None else self.segments.n_split

    @property
    def run_segments(self) -> int:
        """Blocks of the float64 kernel's launch of a stack with segments:
        one a run, and one more for each cut; 0 for any other stack."""
        return 0 if self.segments is None else self.segments.n_seg


def stack_of_runs(c_ptr: np.ndarray, a_idx: np.ndarray, b_idx: np.ndarray) -> np.ndarray:
    """The c-sorted int32 [S, 3] stack whose C tile ``c`` owns entries
    ``[c_ptr[c], c_ptr[c+1])`` of the a/b columns: the owned stacks of the
    band and run plans in the form ``device_stack`` takes."""
    c = np.repeat(np.arange(len(c_ptr) - 1), np.diff(c_ptr))
    return np.stack([c, a_idx, b_idx], axis=1).astype(np.int32)


def device_stack(stack_np: np.ndarray, n_c_tiles: int, device,
                 chunks: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> DeviceStack:
    """Upload a host stack (int32 [S, 3], sorted by c, every c in
    [0, n_c_tiles)) for the flat kernel; validates it on the host.
    ``chunks``: the K occupancy masks of the op(A) and op(B) tiles, for the
    float64 kernel (``f64_stack.py``, whose ``f64_device_stack`` adds the
    run segments it launches with)."""
    stack = np.asarray(stack_np).reshape(-1, 3)
    s = len(stack)
    if s >= 2**31:
        raise ValueError("stack too large for int32 entry offsets")
    c = stack[:, 0].astype(np.int64)
    if s and (c.min() < 0 or c.max() >= n_c_tiles or np.any(np.diff(c) < 0)):
        raise ValueError("stack c column must be sorted and lie in [0, n_c_tiles)")
    if s and (stack[:, 1:].min() < 0):
        raise ValueError("negative tile slot in stack")
    c_ptr = np.searchsorted(c, np.arange(n_c_tiles + 1)).astype(np.int64)

    def upload(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=device)

    def col(j):
        return upload(stack[:, j])

    return DeviceStack(
        n_c=int(n_c_tiles),
        c_ptr=torch.as_tensor(c_ptr.astype(np.int32), device=device),
        a_idx=col(1),
        b_idx=col(2),
        c_ptr_host=c_ptr,
        a_end=int(stack[:, 1].max()) + 1 if s else 0,
        b_end=int(stack[:, 2].max()) + 1 if s else 0,
        a_chunks=None if chunks is None else upload(chunks[0]),
        b_chunks=None if chunks is None else upload(chunks[1]),
    )


def _check_stores(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    if a.dim() != 3 or b.dim() != 3 or a.shape[1] != a.shape[2] or (
        b.shape[1:] != a.shape[1:]
    ):
        raise ValueError(
            f"{what}: tile stores must be [n, T, T] with one T, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: A is {a.dtype}, B is {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what}: A on {a.device}, B on {b.device}")
    return int(a.shape[1])


def check_store_alignment(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    """The kernels copy 16 bytes at a time (``cp.async``, 128-bit loads), so
    a tile store must be contiguous and start on a 16-byte boundary: every
    row of a tile then does too. Stores from ``torch.empty`` always do; a
    view that starts inside another tensor may not."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: tile stores must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{what}: tile stores must start on a 16-byte boundary")


def check_cuda_operands(a, b, index_tensors, what: str, dtypes) -> int:
    """Checks shared by the CUDA wrappers: device, dtype (one of
    ``dtypes``), tile edge, contiguity and 16-byte alignment of the stores
    and contiguity of the plan arrays; returns the tile edge."""
    tile = _check_stores(a, b, what)
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    if a.dtype not in dtypes:
        hint = (" (float64 stacks take mm/f64_stack.py)" if a.dtype == torch.float64
                else " (complex stacks take mm/c_stack.py)" if a.dtype.is_complex else "")
        raise TypeError(f"{what}: no kernel for dtype {a.dtype}{hint}")
    if tile not in KERNEL_TILES:
        raise ValueError(f"{what}: tile edge {tile} not in {KERNEL_TILES}")
    check_store_alignment(a, b, what)
    for t in index_tensors:
        if t.device != a.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{what}: plan arrays must be contiguous int32 on {a.device}"
            )
    return tile


def check_kernel_operands(a, b, index_tensors, out_dtype, what: str) -> int:
    """``check_cuda_operands`` for K1/K2 (float32 or bfloat16 inputs, float32
    or bfloat16 output); returns the kernel's dtype code."""
    check_cuda_operands(a, b, index_tensors, what, _DTYPE_CODE)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: output dtype {out_dtype} not supported")
    return _DTYPE_CODE[a.dtype]


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a stack product sums in: float64 and complex stores in
    their own type (a float32 accumulator would drop a complex product's
    imaginary part), float32 and bfloat16 in float32."""
    if dtype == torch.float64 or dtype.is_complex:
        return dtype
    return torch.float32


def run_sums_plain(
    a: torch.Tensor, b: torch.Tensor, c_ptr: np.ndarray,
    a_idx: torch.Tensor, b_idx: torch.Tensor, out_dtype,
) -> torch.Tensor:
    """``out[c] = Σ_{e in [c_ptr[c], c_ptr[c+1])} a[a_idx[e]] @ b[b_idx[e]]``
    with each run summed left to right in stack order: ``index_select`` +
    ``bmm``, then for j = 0, 1, ... the j-th product of every run of length
    > j is added to its C tile. Destinations within one step are distinct,
    so the reduction is deterministic (no ``index_add_``). Entries are
    gathered ``PLAIN_CHUNK`` at a time, at C-run boundaries. The sums are
    taken in ``accumulator_dtype(a.dtype)``."""
    tile = a.shape[1]
    n_c = len(c_ptr) - 1
    acc = accumulator_dtype(a.dtype)
    out = torch.zeros((n_c, tile, tile), dtype=acc, device=a.device)
    run_len = np.diff(c_ptr)
    c0 = 0
    with tf32_matmul(False):
        while c0 < n_c:
            c1 = int(np.searchsorted(c_ptr, c_ptr[c0] + PLAIN_CHUNK, side="right")) - 1
            c1 = min(max(c1, c0 + 1), n_c)
            e0, e1 = int(c_ptr[c0]), int(c_ptr[c1])
            if e1 > e0:
                prods = torch.bmm(
                    a.index_select(0, a_idx[e0:e1]).to(acc),
                    b.index_select(0, b_idx[e0:e1]).to(acc),
                )
                lens = run_len[c0:c1]
                starts = c_ptr[c0:c1] - e0
                for j in range(int(lens.max())):
                    cs = np.flatnonzero(lens > j)
                    dst = torch.as_tensor(c0 + cs, device=a.device)
                    src = torch.as_tensor(starts[cs] + j, device=a.device)
                    out[dst] += prods.index_select(0, src)
            c0 = c1
    return out.to(out_dtype)


def tile_stack_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack, *, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): same sums, same order of
    runs; the kernel differs only in the order of each tile product's own
    k-sum."""
    _check_stores(a, b, "tile_stack_matmul_plain")
    return run_sums_plain(
        a, b, stack.c_ptr_host, stack.a_idx.to(a.device).long(),
        stack.b_idx.to(a.device).long(), out_dtype or a.dtype,
    )


def tile_stack_matmul(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack, *, out_dtype=None,
) -> torch.Tensor:
    """K1: ``[n_c, T, T]`` tile store of the stack product. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise (dtypes other
    than float32/bfloat16 — float64 has ``f64_stack.tile_stack_matmul_f64``
    — tile edges outside ``KERNEL_TILES``, non-contiguous stores:
    TypeError/ValueError)."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return tile_stack_matmul_plain(a, b, stack, out_dtype=out_dtype)
    code = check_kernel_operands(
        a, b, (stack.c_ptr, stack.a_idx, stack.b_idx), out_dtype,
        "tile_stack_matmul",
    )
    if stack.a_end > a.shape[0] or stack.b_end > b.shape[0]:
        raise IndexError("tile_stack_matmul: stack slot beyond the tile stores")
    from .._build import check_launch, kernels

    tile = a.shape[1]
    out = torch.empty((stack.n_c, tile, tile), dtype=torch.float32, device=a.device)
    if stack.n_c:
        lib = kernels()
        rc = lib.dbcsr_torch_stack_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), stack.c_ptr.data_ptr(),
            stack.a_idx.data_ptr(), stack.b_idx.data_ptr(), stack.n_c, tile,
            code, a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, "tile_stack_matmul")
        tile_stack_matmul.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: launches of the K1 kernel since the last reset (set it to 0 to reset)
tile_stack_matmul.launches = 0


# ---------------------------------------------------------------------------
# K4: the grouped kernel
# ---------------------------------------------------------------------------

# int32 entry packing: [out_local:3][a_cache_slot:8][b_tile:20] (the top bit
# stays clear)
_GROUP_MAX = 8     # out_local < 8
_CACHE_MAX = 256   # a cache slot < 256
_B_BITS = 20       # b tile index < 2^20


def _plan_groups(
    stack_np: np.ndarray, n_c_tiles: int, group: int, cache: int
):
    """Host grouping pass: split the c-sorted stack into groups of up to
    ``group`` output rows whose distinct A tiles fit the ``cache``-slot
    panel. A c-run larger than one group's budget is split across groups
    (its partial sums are segment-summed on device afterwards).

    Returns (ebounds, abounds, aload, packed_entries, seg, n_groups) where
    ``seg[n_groups*group]`` maps each padded output row to its c slot
    (n_c_tiles for padding rows)."""
    S = len(stack_np)
    ebounds = [0]
    abounds = [0]
    aload: list = []
    seg: list = []
    e_packed = np.empty(S, dtype=np.int32)
    cache_map: dict = {}
    locals_used = 0
    cur_c = -1
    cur_local = -1
    st = stack_np

    def flush(pos):
        nonlocal cache_map, locals_used, cur_c, cur_local
        aload.extend(cache_map.keys())
        abounds.append(len(aload))
        ebounds.append(pos)
        seg.extend([n_c_tiles] * (group - locals_used))  # padding rows
        cache_map = {}
        locals_used = 0
        cur_c = -1
        cur_local = -1

    for pos in range(S):
        c = int(st[pos, 0])
        aa = int(st[pos, 1])
        bb = int(st[pos, 2])
        need_local = c != cur_c
        new_a = aa not in cache_map
        if (need_local and locals_used == group) or (
            new_a and len(cache_map) == cache
        ):
            flush(pos)
            need_local = True
            new_a = True
        if new_a:
            cache_map[aa] = len(cache_map)
        if need_local:
            cur_local = locals_used
            locals_used += 1
            seg.append(c)
            cur_c = c
        e_packed[pos] = np.int32(
            (cur_local << (_B_BITS + 8)) | (cache_map[aa] << _B_BITS) | bb
        )
    if locals_used or cache_map:
        flush(S)

    n_groups = len(ebounds) - 1
    return (
        np.asarray(ebounds, dtype=np.int32),
        np.asarray(abounds, dtype=np.int32),
        np.asarray(aload, dtype=np.int32),
        e_packed,
        np.asarray(seg, dtype=np.int32),
        n_groups,
    )


@dataclass(frozen=True)
class DeviceGroupPlan:
    """A group plan resident on one device (built once per plan by
    ``device_group_plan``): ``_plan_groups``' arrays, the per-output-row
    entry bounds ``lbounds`` the kernel walks (a group's entries are
    c-sorted, so one row's entries are contiguous), and where the rows go.
    ``join`` is None when no C run was split: every C slot has at most one
    row, ``out_slot`` maps a row to its C slot (-1 for a padding row) and
    the kernel writes the ``[n_c, T, T]`` store itself; the C slots that no
    row produces are ``zero_slots``. When a run was split, ``out_slot`` is
    the identity over the padded rows and ``join`` is the ordered segment
    sum that adds a run's partial sums in row order."""

    n_c: int
    n_groups: int
    group: int
    cache: int
    seg_host: np.ndarray      # int32 [n_groups*group] row -> c slot (n_c = padding)
    lbounds: torch.Tensor     # int32 [n_groups*group+1]
    abounds: torch.Tensor     # int32 [n_groups+1]
    aload: torch.Tensor       # int32 [n_aload]
    entries: torch.Tensor     # int32 [S]
    out_slot: torch.Tensor    # int32 [n_groups*group] row -> tile the kernel writes
    zero_slots: torch.Tensor  # int64 C slots without a row (join is None)
    join: Optional[object]    # None or an OrderedSegmentSum
    a_end: int
    b_end: int

    @property
    def split_runs(self) -> int:
        """C slots whose run was split across groups."""
        seg = self.seg_host[self.seg_host < self.n_c]
        return int(len(seg) - len(np.unique(seg)))

    def entry_slots(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row bounds, A store slot per entry, B store slot per entry) on
        the host, int64, decoded from the arrays the kernel reads: what the
        plain version walks."""
        lb = self.lbounds.cpu().numpy().astype(np.int64)
        ent = self.entries.cpu().numpy().astype(np.int64)
        if not len(ent):
            return lb, ent, ent
        g_of_entry = np.repeat(np.arange(len(lb) - 1), np.diff(lb)) // self.group
        a_slot = self.aload.cpu().numpy().astype(np.int64)[
            self.abounds.cpu().numpy().astype(np.int64)[g_of_entry]
            + ((ent >> _B_BITS) & 0xFF)
        ]
        return lb, a_slot, ent & ((1 << _B_BITS) - 1)


def device_group_plan(
    stack_np: np.ndarray, n_c_tiles: int, n_b_tiles: int, device, *,
    group: int = 8, cache: int = 128,
) -> DeviceGroupPlan:
    """Plan the grouped kernel for a host stack (int32 [S, 3], sorted by c)
    and upload it. Raises ValueError beyond the entry packing's limits
    (``n_b_tiles`` < 2^20, ``group`` ≤ 8, ``cache`` ≤ 256)."""
    from ..block.tileops import ordered_segment_sum

    if n_b_tiles >= (1 << _B_BITS) or group > _GROUP_MAX or cache > _CACHE_MAX:
        raise ValueError("grouped kernel limits exceeded")
    stack = np.asarray(stack_np).reshape(-1, 3)
    if len(stack) and int(stack[:, 2].max()) >= n_b_tiles:
        raise IndexError("grouped plan: stack b slot beyond n_b_tiles")
    ebounds, abounds, aload, entries, seg, n_groups = _plan_groups(
        stack, n_c_tiles, group, cache
    )
    n_rows = n_groups * group
    ent = entries.astype(np.int64)
    g_of_entry = np.repeat(np.arange(n_groups, dtype=np.int64), np.diff(ebounds))
    row = g_of_entry * group + (ent >> (_B_BITS + 8))
    lbounds = np.searchsorted(row, np.arange(n_rows + 1))
    produced = seg[seg < n_c_tiles]
    if len(np.unique(produced)) == len(produced):
        # no run was split: a row is its C slot's whole sum
        join = None
        out_slot = np.where(seg < n_c_tiles, seg, -1)
        zero_slots = np.setdiff1d(np.arange(n_c_tiles), produced)
    else:
        join = ordered_segment_sum(seg, n_c_tiles, device)
        out_slot = np.arange(n_rows)
        zero_slots = np.zeros(0, np.int64)

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=device)

    return DeviceGroupPlan(
        n_c=int(n_c_tiles), n_groups=n_groups, group=group, cache=cache,
        seg_host=seg,
        lbounds=up(lbounds), abounds=up(abounds), aload=up(aload),
        entries=up(entries),
        out_slot=up(out_slot),
        zero_slots=torch.as_tensor(zero_slots, dtype=torch.int64, device=device),
        join=join,
        a_end=int(aload.max(initial=-1)) + 1,
        b_end=int(stack[:, 2].max()) + 1 if len(stack) else 0,
    )


def tile_stack_matmul_grouped_plain(
    a: torch.Tensor, b: torch.Tensor, plan: DeviceGroupPlan, *, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of K4 (any device): the same rows, each summed
    over its entries in stack order, then placed by the plan's row → slot
    map or joined by its ordered segment sum."""
    _check_stores(a, b, "tile_stack_matmul_grouped_plain")
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    lbounds, a_slot, b_slot = plan.entry_slots()
    rows = run_sums_plain(
        a, b, lbounds, torch.as_tensor(a_slot, device=a.device),
        torch.as_tensor(b_slot, device=a.device), acc,
    )
    if plan.join is None:
        out_slot = plan.out_slot.to(a.device).long()
        real = out_slot >= 0
        out = rows.new_zeros((plan.n_c,) + tuple(rows.shape[1:]))
        out[out_slot[real]] = rows[real]
    else:
        out = plan.join(rows)
    return out.to(out_dtype or a.dtype)


def tile_stack_matmul_grouped(
    a: torch.Tensor, b: torch.Tensor, plan: DeviceGroupPlan, *, out_dtype=None,
) -> torch.Tensor:
    """K4: ``[n_c, T, T]`` tile store of the stack product by the group
    plan. CPU tensors run the plain version; CUDA tensors launch the kernel
    or raise (same rules as ``tile_stack_matmul``; float64 is taken)."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return tile_stack_matmul_grouped_plain(a, b, plan, out_dtype=out_dtype)
    tile = check_cuda_operands(
        a, b, (plan.lbounds, plan.abounds, plan.aload, plan.entries, plan.out_slot),
        "tile_stack_matmul_grouped", DTYPE_CODE_F64,
    )
    if plan.a_end > a.shape[0] or plan.b_end > b.shape[0]:
        raise IndexError("tile_stack_matmul_grouped: plan slot beyond the tile stores")
    from .._build import check_launch, kernels

    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    n_rows = plan.n_groups * plan.group
    # the tiles the kernel writes: the C store itself, or the padded rows
    n_out = plan.n_c if plan.join is None else n_rows
    out = torch.empty((n_out, tile, tile), dtype=acc, device=a.device)
    if len(plan.zero_slots):
        out[plan.zero_slots] = 0
    if n_rows:
        lib = kernels()
        rc = lib.dbcsr_torch_grouped_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), plan.lbounds.data_ptr(),
            plan.abounds.data_ptr(), plan.aload.data_ptr(),
            plan.entries.data_ptr(), plan.out_slot.data_ptr(), n_rows,
            plan.group, tile, DTYPE_CODE_F64[a.dtype], a.device.index,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, "tile_stack_matmul_grouped")
        tile_stack_matmul_grouped.launches += 1
    if plan.join is not None:
        out = plan.join(out)
    return out.to(out_dtype)


#: launches of the K4 kernel since the last reset (set it to 0 to reset)
tile_stack_matmul_grouped.launches = 0
