"""K2, the panel kernel: plan, wrapper, plain version and CUDA binding.

The host planner is a copy of ``dbcsr_tpu/mm/panel.py``'s
(``PanelPlan``, ``_plan_slab_groups``, ``plan_panel_stack``): the c-sorted
stack is cut into groups of exactly ``c_win`` consecutive C store slots
(the last group clamped to end at ``n_c_tiles``), each group's A and B
tiles span one contiguous slot range of their stores, and each entry is
packed as ``a_local << 16 | b_local`` relative to the group's span starts
``a_lo``/``b_lo``. Admission is decided on the host: the spans must fit
the caps and, in "auto" mode, the group-span traffic must undercut the
flat kernel's 2 tiles/entry by ``admit_ratio``. Banded and clustered
patterns pass; uniform-random ones keep the flat kernel (``kernels.py``).

``tile_stack_matmul_panel`` evaluates a plan — for CUDA tensors with the
hand-written kernel in ``csrc/panel_matmul.cu`` (one block per (group,
slot, sub-tile); neighbouring blocks share the group's A/B tiles through
L2, the job the TPU's VMEM slab caches did), for CPU tensors with the plain
version ``tile_stack_matmul_panel_plain``. Each slot's entries keep stack
order, so K2 sums in exactly K1's order on the same stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .kernels import _check_stores, check_kernel_operands, run_sums_plain

__all__ = [
    "PanelPlan",
    "plan_panel_stack",
    "DevicePanelPlan",
    "device_panel_plan",
    "tile_stack_matmul_panel",
    "tile_stack_matmul_panel_plain",
]

#: packed-entry limits: a_local << 16 stays clear of the int32 sign bit
_A_LOCAL_LIMIT = 1 << 15
_B_LOCAL_LIMIT = 1 << 16


@dataclass
class PanelPlan:
    """Host plan of one panel-kernel launch (field for field the JAX
    package's ``PanelPlan`` without its TPU launch knob ``unroll``)."""

    gstart: np.ndarray      # int32 [n_groups] first C store slot of the group
    a_lo: np.ndarray        # int32 [n_groups] first A slot of the group span
    a_nch: np.ndarray       # int32 [n_groups] A span length in chunks
    b_lo: np.ndarray        # int32 [n_groups]
    b_nch: np.ndarray       # int32 [n_groups]
    obounds: np.ndarray     # int32 [n_groups*c_win+1] entry offsets per slot
    entries: np.ndarray     # int32 [S'] packed (a_local<<16 | b_local)
    n_groups: int
    c_win: int
    a_cap: int
    b_cap: int
    chunk: int
    n_c_tiles: int
    loaded_tiles: int       # group-span traffic in tiles (admission, stats)
    stack_size: int         # original S (entries may exceed it: the
                            # clamped last group repeats overlap slots)

    @property
    def traffic_ratio(self) -> float:
        """Span traffic relative to the flat kernel's 2 tiles/entry, over
        the ORIGINAL stack size (what ``admit_ratio`` tests)."""
        return self.loaded_tiles / (2.0 * max(self.stack_size, 1))


@dataclass
class _SlabGroups:
    """Group windows, ragged per-group entries and chunk-padded A/B spans
    (``b_map``, when given, remaps B slots before spans are taken)."""

    gstart: np.ndarray      # int64 [n_groups]
    slot_bounds: np.ndarray  # int64 [n_c_tiles+1]
    e0: np.ndarray          # int64 [n_groups]
    glens: np.ndarray       # int64 [n_groups]
    base: np.ndarray        # int64 [n_groups+1]
    idx: np.ndarray         # int64 [tot] global stack row per entry
    g_of_entry: np.ndarray  # int64 [tot]
    a_col: np.ndarray       # int64 [tot]
    b_col: np.ndarray       # int64 [tot] (remapped when b_map given)
    a_lo: np.ndarray        # int64 [n_groups]
    a_nch: np.ndarray       # int32 [n_groups]
    b_lo: np.ndarray        # int64 [n_groups]
    b_nch: np.ndarray       # int32 [n_groups]
    chunk: int
    c_win: int
    n_groups: int
    loaded: int


def _plan_slab_groups(
    stack_np, n_c_tiles, n_a_tiles, n_b_tiles, *,
    c_win, a_cap, b_cap, chunk, admit_ratio, b_map=None,
):
    S = len(stack_np)
    if S == 0 or n_c_tiles == 0:
        return None
    # small stores: a span is chunk-padded, so the chunk must fit the store
    chunk = max(1, min(chunk, n_a_tiles, n_b_tiles))
    c_col = stack_np[:, 0].astype(np.int64)
    c_win = min(c_win, n_c_tiles)
    n_groups = -(-n_c_tiles // c_win)

    # group g owns C store slots [gstart[g], gstart[g]+c_win); the LAST
    # group is clamped to end at n_c_tiles, overlapping its predecessor
    gstart = np.minimum(
        np.arange(n_groups, dtype=np.int64) * c_win, n_c_tiles - c_win
    )

    # entry offsets per C slot (c_col is sorted)
    slot_bounds = np.searchsorted(c_col, np.arange(n_c_tiles + 1)).astype(
        np.int64
    )
    e0 = slot_bounds[gstart]
    e1 = slot_bounds[gstart + c_win]
    glens = e1 - e0  # per-group entry counts (overlap duplicates allowed)
    tot = int(glens.sum())
    base = np.concatenate(([0], np.cumsum(glens)))  # [n_groups+1]
    # ragged gather: global stack row index of every per-group entry
    offs = np.arange(tot, dtype=np.int64) - np.repeat(base[:-1], glens)
    idx = np.repeat(e0, glens) + offs
    g_of_entry = np.repeat(np.arange(n_groups, dtype=np.int64), glens)

    a_col = stack_np[idx, 1].astype(np.int64)
    b_col = stack_np[idx, 2].astype(np.int64)
    if b_map is not None:
        b_col = b_map[b_col]

    def spans(col):
        lo = np.zeros(n_groups, dtype=np.int64)
        hi = np.zeros(n_groups, dtype=np.int64)
        nz = glens > 0
        if nz.any():
            starts = base[:-1][nz]
            lo[nz] = np.minimum.reduceat(col, starts)
            hi[nz] = np.maximum.reduceat(col, starts) + 1
        return lo, hi

    a_min, a_hi = spans(a_col)
    b_min, b_hi = spans(b_col)

    def pad_spans(mn, hi, cap, n_store, ch):
        span = hi - mn
        spn = -(-span // ch) * ch  # chunk-padded span length
        spn = np.maximum(spn, ch)
        if spn.max(initial=0) > cap or n_store < int(spn.max(initial=0)):
            return None, None
        # shift starts down so the padded span stays inside the store
        lo = np.maximum(0, np.minimum(mn, n_store - spn))
        return lo.astype(np.int64), (spn // ch).astype(np.int32)

    # ceil-rounding can push a padded span past a small store: halve the
    # chunk until the spans fit; at chunk=1 only genuinely cap-exceeding
    # spans remain inadmissible
    a_lo = b_lo = None
    while chunk >= 1:
        a_lo, a_nch = pad_spans(a_min, a_hi, a_cap, n_a_tiles, chunk)
        if a_lo is not None:
            b_lo, b_nch = pad_spans(b_min, b_hi, b_cap, n_b_tiles, chunk)
        if a_lo is not None and b_lo is not None:
            break
        if chunk == 1:
            return None
        chunk //= 2
    if a_lo is None or b_lo is None:
        return None

    loaded = int((a_nch.astype(np.int64) + b_nch).sum()) * chunk
    if admit_ratio is not None and loaded > admit_ratio * 2.0 * S:
        return None
    return _SlabGroups(
        gstart=gstart, slot_bounds=slot_bounds, e0=e0, glens=glens,
        base=base, idx=idx, g_of_entry=g_of_entry, a_col=a_col,
        b_col=b_col, a_lo=a_lo, a_nch=a_nch, b_lo=b_lo, b_nch=b_nch,
        chunk=chunk, c_win=c_win, n_groups=n_groups, loaded=loaded,
    )


def plan_panel_stack(
    stack_np: np.ndarray,  # int32 [S, 3] (c, a, b) sorted by c
    n_c_tiles: int,
    n_a_tiles: int,
    n_b_tiles: int,
    *,
    c_win: int = 16,
    a_cap: int = 64,
    b_cap: int = 64,
    chunk: int = 8,
    admit_ratio: Optional[float] = None,
) -> Optional[PanelPlan]:
    """Group the stack into ``c_win``-slot panels; None if inadmissible
    (a group's A/B span exceeds the cap, the store is too small for the
    chunk-padded spans, or span traffic does not beat the flat kernel)."""
    S = len(stack_np)
    sg = _plan_slab_groups(
        stack_np, n_c_tiles, n_a_tiles, n_b_tiles, c_win=c_win,
        a_cap=a_cap, b_cap=b_cap, chunk=chunk, admit_ratio=admit_ratio,
    )
    if sg is None:
        return None

    a_local = sg.a_col - sg.a_lo[sg.g_of_entry]
    b_local = sg.b_col - sg.b_lo[sg.g_of_entry]
    if a_local.min(initial=0) < 0 or b_local.min(initial=0) < 0 or (
        a_local.max(initial=0) >= _A_LOCAL_LIMIT
        or b_local.max(initial=0) >= _B_LOCAL_LIMIT
    ):
        raise ValueError(
            "panel entry out of packing range (need 0 <= a_local < 2^15, "
            "0 <= b_local < 2^16)"
        )
    entries = ((a_local << 16) | b_local).astype(np.int32)

    # per (group, local slot) entry offsets into the regrouped entry array
    l_idx = sg.gstart[:, None] + np.arange(sg.c_win, dtype=np.int64)[None, :]
    ob = sg.base[:-1, None] + sg.slot_bounds[l_idx] - sg.e0[:, None]
    obounds = np.append(ob.ravel(), len(sg.idx)).astype(np.int32)

    return PanelPlan(
        gstart=sg.gstart.astype(np.int32),
        a_lo=sg.a_lo.astype(np.int32),
        a_nch=sg.a_nch,
        b_lo=sg.b_lo.astype(np.int32),
        b_nch=sg.b_nch,
        obounds=obounds,
        entries=entries,
        n_groups=sg.n_groups,
        c_win=sg.c_win,
        a_cap=int(sg.a_nch.max(initial=1)) * sg.chunk,
        b_cap=int(sg.b_nch.max(initial=1)) * sg.chunk,
        chunk=sg.chunk,
        n_c_tiles=n_c_tiles,
        loaded_tiles=sg.loaded,
        stack_size=S,
    )


def panel_owned_stack(plan: PanelPlan):
    """The flat stack a plan computes, each C slot once (from the first
    group whose window reaches it), in slot order and, within a slot, in
    the plan's entry order: (c_ptr int64 [n_c+1], a int64 [S], b int64 [S])."""
    cw, ng = plan.c_win, plan.n_groups
    q = np.arange(ng * cw, dtype=np.int64)
    g = q // cw
    slot = plan.gstart.astype(np.int64)[g] + q % cw
    ob = plan.obounds.astype(np.int64)
    cnt = np.where(slot >= g * cw, ob[1:] - ob[:-1], 0)
    qq = np.repeat(q, cnt)
    e = ob[:-1][qq] + (
        np.arange(int(cnt.sum()), dtype=np.int64)
        - np.repeat(np.cumsum(cnt) - cnt, cnt)
    )
    ent = plan.entries[e].astype(np.int64)
    a = plan.a_lo.astype(np.int64)[g[qq]] + (ent >> 16)
    b = plan.b_lo.astype(np.int64)[g[qq]] + (ent & 0xFFFF)
    c_ptr = np.searchsorted(slot[qq], np.arange(plan.n_c_tiles + 1))
    return c_ptr.astype(np.int64), a, b


@dataclass(frozen=True)
class DevicePanelPlan:
    """A ``PanelPlan``'s arrays resident on one device (built once per plan
    by ``device_panel_plan``)."""

    plan: PanelPlan
    gstart: torch.Tensor   # int32 [n_groups]
    a_lo: torch.Tensor     # int32 [n_groups]
    b_lo: torch.Tensor     # int32 [n_groups]
    obounds: torch.Tensor  # int32 [n_groups*c_win+1]
    entries: torch.Tensor  # int32 [S']
    a_end: int  # A must hold at least this many tiles
    b_end: int


def device_panel_plan(plan: PanelPlan, device) -> DevicePanelPlan:
    def up(x):
        return torch.as_tensor(
            np.ascontiguousarray(x, dtype=np.int32), device=device
        )

    span_a = plan.a_lo.astype(np.int64) + plan.a_nch.astype(np.int64) * plan.chunk
    span_b = plan.b_lo.astype(np.int64) + plan.b_nch.astype(np.int64) * plan.chunk
    return DevicePanelPlan(
        plan=plan, gstart=up(plan.gstart), a_lo=up(plan.a_lo),
        b_lo=up(plan.b_lo), obounds=up(plan.obounds), entries=up(plan.entries),
        a_end=int(span_a.max(initial=0)), b_end=int(span_b.max(initial=0)),
    )


def tile_stack_matmul_panel_plain(
    a: torch.Tensor, b: torch.Tensor, plan: PanelPlan, *, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (any device): evaluates the same plan —
    each C slot once, from the group that owns it — with the sorted-segment
    reduction of the flat plain version."""
    _check_stores(a, b, "tile_stack_matmul_panel_plain")
    c_ptr, ai, bi = panel_owned_stack(plan)
    return run_sums_plain(
        a, b, c_ptr, torch.as_tensor(ai, device=a.device),
        torch.as_tensor(bi, device=a.device), out_dtype or a.dtype,
    )


def tile_stack_matmul_panel(
    a: torch.Tensor, b: torch.Tensor, dplan: DevicePanelPlan, *,
    out_dtype=None,
) -> torch.Tensor:
    """K2: ``[n_c_tiles, T, T]`` tile store of the planned product. CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise
    (same rules as ``kernels.tile_stack_matmul``)."""
    out_dtype = out_dtype or a.dtype
    plan = dplan.plan
    if a.device.type == "cpu":
        return tile_stack_matmul_panel_plain(a, b, plan, out_dtype=out_dtype)
    code = check_kernel_operands(
        a, b,
        (dplan.gstart, dplan.a_lo, dplan.b_lo, dplan.obounds, dplan.entries),
        out_dtype, "tile_stack_matmul_panel",
    )
    if dplan.a_end > a.shape[0] or dplan.b_end > b.shape[0]:
        raise IndexError("tile_stack_matmul_panel: plan spans beyond the tile stores")
    from .._build import check_launch, kernels

    tile = a.shape[1]
    out = torch.empty(
        (plan.n_c_tiles, tile, tile), dtype=torch.float32, device=a.device
    )
    lib = kernels()
    rc = lib.dbcsr_torch_panel_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), dplan.gstart.data_ptr(),
        dplan.a_lo.data_ptr(), dplan.b_lo.data_ptr(), dplan.obounds.data_ptr(),
        dplan.entries.data_ptr(), plan.n_groups * plan.c_win, plan.c_win,
        tile, code, a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    check_launch(lib, rc, "tile_stack_matmul_panel")
    tile_stack_matmul_panel.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: launches of the K2 kernel since the last reset (set it to 0 to reset)
tile_stack_matmul_panel.launches = 0
