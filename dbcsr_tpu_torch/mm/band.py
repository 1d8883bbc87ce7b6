"""K5, the band driver: plan, wrapper, plain version and CUDA binding.

Banded tile patterns — the linear-scaling SCF shape — can be stored as TILE
DIAGONALS: with ``off_a`` the smallest tile-diagonal offset (col − row) of
A, diagonal ``d1`` of A holds the tiles ``A[m, m + off_a + d1]``, and the
product is the diagonal convolution

    C[d1 + d2, m] += A[d1, m] @ B[d2, m + off_a + d1]

over ``Wa·Wb`` diagonal pairs. The host planner (``BandPlan``,
``plan_band``) is a copy of ``dbcsr_tpu/mm/band.py``'s: pack maps from band
positions to store slots (−1 = absent), the unpack map of the product tiles,
and the admission rule (at most ``max_products`` diagonal pairs; under
"auto" the padded work ``Wa·Wb·Mt`` within ``flop_factor`` of the stack's
tile-triple count). ``hw_flops`` stays the padded figure, as in the JAX
package's statistics.

``band_matmul`` evaluates a plan — for CUDA tensors with the hand-written
kernel in ``csrc/band_matmul.cu`` (one block per present output tile,
summing over ``d1`` ascending and reading the tile stores through the pack
maps, so absent cells cost nothing and no packed copy is made), for
CPU tensors with the plain version ``band_matmul_plain``: the torch form of
the JAX package's XLA twin (pack to ``[W, Mt, T, T]`` with −1 → zero tile,
one batched wide matmul per ``d1``, sums in ``d1`` order). Both return the C
tiles in ``plan.c_unpack`` order (the product-key order the engine aligns
from). float32 and bfloat16 inputs accumulate in float32, float64 in float64.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..block.tileops import take_tiles
from .kernels import DTYPE_CODE_F64, _check_stores, check_cuda_operands, tf32_matmul

__all__ = [
    "BandPlan",
    "plan_band",
    "DeviceBandPlan",
    "device_band_plan",
    "band_run_cells",
    "band_owned_stack",
    "band_matmul",
    "band_matmul_plain",
]


@dataclass
class BandPlan:
    """Static description of one band multiply C = A·B over tile stores."""

    a_pack: np.ndarray  # int [Wa*Mt] -> a store slot (-1 = absent)
    b_pack: np.ndarray  # int [Wb*Kt]
    c_unpack: np.ndarray  # int [n_c_tiles] -> position in [Wc*Mt]
    wa: int
    wb: int
    off_a: int  # smallest tile-diagonal offset of A (c - r)
    off_b: int
    mt: int
    kt: int
    hw_flops: float


def _diag_extent(coords: np.ndarray) -> Tuple[int, int]:
    d = coords[:, 1].astype(np.int64) - coords[:, 0].astype(np.int64)
    return int(d.min()), int(d.max())


def plan_band(
    a_coords: np.ndarray,
    a_grid: Tuple[int, int],
    b_coords: np.ndarray,
    b_grid: Tuple[int, int],
    c_keys: np.ndarray,  # sorted row-major product tile keys
    *,
    tile: int,
    n_stack: Optional[int] = None,
    max_products: int = 128,
    flop_factor: float = 6.0,
) -> Optional[BandPlan]:
    """Band plan, or None when the pattern is not band-suitable.

    ``n_stack`` (tile-triple count of the stack path) gates admission: the
    padded band work ``wa*wb*mt`` must stay within ``flop_factor`` of it.
    """
    mt, kt = a_grid
    kt2, nt = b_grid
    if len(a_coords) == 0 or len(b_coords) == 0:
        return None
    lo_a, hi_a = _diag_extent(a_coords)
    lo_b, hi_b = _diag_extent(b_coords)
    wa = hi_a - lo_a + 1
    wb = hi_b - lo_b + 1
    if wa * wb > max_products:
        return None
    if n_stack is not None and wa * wb * mt > flop_factor * max(n_stack, 1):
        return None

    def pack(coords, lo, w, nrows, ncols_grid):
        out = np.full(w * nrows, -1, dtype=np.int64)
        r = coords[:, 0].astype(np.int64)
        d = coords[:, 1].astype(np.int64) - r - lo
        out[d * nrows + r] = np.arange(len(coords), dtype=np.int64)
        return out

    a_pack = pack(a_coords, lo_a, wa, mt, kt)
    b_pack = pack(b_coords, lo_b, wb, kt, nt)

    wc = wa + wb - 1
    off_c = lo_a + lo_b
    c_r = (c_keys // nt).astype(np.int64)
    c_c = (c_keys % nt).astype(np.int64)
    dc = c_c - c_r - off_c
    if len(dc) and (dc.min() < 0 or dc.max() >= wc):
        return None  # product keys outside the band (shouldn't happen)
    c_unpack = dc * mt + c_r

    return BandPlan(
        a_pack=a_pack, b_pack=b_pack, c_unpack=c_unpack,
        wa=wa, wb=wb, off_a=lo_a, off_b=lo_b, mt=mt, kt=kt,
        hw_flops=2.0 * wa * wb * mt * tile**3,
    )


@dataclass(frozen=True)
class DeviceBandPlan:
    """A ``BandPlan``'s maps resident on one device as the kernel reads them
    (built once per plan by ``device_band_plan``)."""

    plan: BandPlan
    a_pack: torch.Tensor    # int32 [Wa*Mt]
    b_pack: torch.Tensor    # int32 [Wb*Kt]
    c_unpack: torch.Tensor  # int32 [n_c_tiles]
    a_end: int  # A must hold at least this many tiles
    b_end: int


def device_band_plan(plan: BandPlan, device) -> DeviceBandPlan:
    wc = plan.wa + plan.wb - 1
    if max(len(plan.a_pack), len(plan.b_pack), wc * plan.mt) >= 2**31:
        raise ValueError("band plan too large for int32 band positions")

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32), device=device)

    return DeviceBandPlan(
        plan=plan, a_pack=up(plan.a_pack), b_pack=up(plan.b_pack),
        c_unpack=up(plan.c_unpack),
        a_end=int(plan.a_pack.max(initial=-1)) + 1,
        b_end=int(plan.b_pack.max(initial=-1)) + 1,
    )


def band_run_cells(plan: BandPlan):
    """What the kernel walks: for C tile ``i`` of ``c_unpack`` (band position
    ``dc·Mt + m``) the run is ``d1`` from ``max(0, dc − (Wb−1))`` to
    ``min(dc, Wa−1)``. Returns three ``[n_c, Wa]`` arrays: ``run`` (``d1`` is
    in tile ``i``'s run) and the A and B store slots of cell ``d1``, −1 where
    the cell is outside the run, ``k = m + off_a + d1`` is outside
    ``[0, Kt)``, or the tile is absent."""
    pos = np.asarray(plan.c_unpack, dtype=np.int64)
    dc, m = (pos // plan.mt)[:, None], (pos % plan.mt)[:, None]
    d1 = np.arange(plan.wa, dtype=np.int64)[None, :]
    d2 = dc - d1
    k = m + plan.off_a + d1
    run = (d2 >= 0) & (d2 < plan.wb)
    ok = run & (k >= 0) & (k < plan.kt)
    a = np.where(ok, plan.a_pack[np.where(ok, d1 * plan.mt + m, 0)], -1)
    b = np.where(ok, plan.b_pack[np.where(ok, d2 * plan.kt + k, 0)], -1)
    return run, a, b


def band_owned_stack(plan: BandPlan):
    """The flat stack a band plan computes, in the kernel's order: C tile
    ``i`` of ``c_unpack`` sums, ``d1`` ascending, the cells whose A tile,
    B tile and ``k = m + off_a + d1`` all exist (absent and out-of-range
    cells dropped): (c_ptr int64 [n_c+1], a int64 [S], b int64 [S]) in store
    slots. The counterpart of ``panel.panel_runs_owned_stack``."""
    _, a, b = band_run_cells(plan)
    ok = (a >= 0) & (b >= 0)
    c_ptr = np.concatenate(([0], np.cumsum(ok.sum(axis=1)))).astype(np.int64)
    return c_ptr, a[ok].astype(np.int64), b[ok].astype(np.int64)


def _band_product_plain(a_band, b_band, *, wa, wb, off_a, mt, kt, tile):
    """The diagonal convolution as ``wa`` batched WIDE matmuls: B's
    diagonals of one tile row side by side, ``B_rows[k] = [T, Wb·T]``, so per
    ``d1`` one ``[Mt, T, T] @ [Mt, T, Wb·T]`` product whose ``[T, Wb, T]``
    slices add into the shifted output diagonals, ``d1`` ascending."""
    wc = wa + wb - 1
    b_rows = b_band.permute(1, 2, 0, 3).reshape(kt, tile, wb * tile)
    # pad the row axis so every shifted slice is in range:
    # k = m + off_a + d1 for m in [0, Mt), d1 in [0, Wa)
    pad_lo = max(0, -off_a)
    pad_hi = max(0, (mt - 1) + off_a + (wa - 1) - (kt - 1))
    b_pad = torch.nn.functional.pad(b_rows, (0, 0, 0, 0, pad_lo, pad_hi))
    out = [None] * wc
    for d1 in range(wa):
        start = off_a + d1 + pad_lo  # >= 0 by construction
        prod = torch.bmm(a_band[d1], b_pad[start:start + mt]).reshape(
            mt, tile, wb, tile
        )
        for d2 in range(wb):
            contrib = prod[:, :, d2, :]
            out[d1 + d2] = contrib if out[d1 + d2] is None else out[d1 + d2] + contrib
    return torch.stack(out)


def band_matmul_plain(
    a_tiles: torch.Tensor, b_tiles: torch.Tensor, plan: BandPlan, *,
    out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of K5 (any device): the same sums in the same
    ``d1`` order, over every cell of the band (absent tiles as zero tiles),
    accumulated in float32 (float64 for float64 stores), TF32 off."""
    tile = _check_stores(a_tiles, b_tiles, "band_matmul_plain")
    acc = torch.float64 if a_tiles.dtype == torch.float64 else torch.float32
    a_band = take_tiles(a_tiles, plan.a_pack, tile).to(acc).reshape(
        plan.wa, plan.mt, tile, tile
    )
    b_band = take_tiles(b_tiles, plan.b_pack, tile).to(acc).reshape(
        plan.wb, plan.kt, tile, tile
    )
    with tf32_matmul(False):
        c_band = _band_product_plain(
            a_band, b_band, wa=plan.wa, wb=plan.wb, off_a=plan.off_a,
            mt=plan.mt, kt=plan.kt, tile=tile,
        )
    flat = c_band.reshape(-1, tile, tile)
    pos = torch.as_tensor(plan.c_unpack, dtype=torch.int64, device=flat.device)
    return flat.index_select(0, pos).to(out_dtype or a_tiles.dtype)


def band_matmul(
    a_tiles: torch.Tensor,
    b_tiles: torch.Tensor,
    plan: Union[BandPlan, DeviceBandPlan],
    *,
    tile: Optional[int] = None,
    precision: str = "highest",
    out_dtype=None,
) -> torch.Tensor:
    """K5: the band product's C tiles in ``plan.c_unpack`` order. CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise.
    At ``precision="default"`` with config ``stack_bf16_inputs``, float32
    stores are fed as bfloat16 (float32 accumulation), as the JAX package's
    band kernel is fed. ``plan`` may be the host ``BandPlan`` (uploaded per
    call) or a ``DeviceBandPlan`` (planned-once callers)."""
    from ..core.config import get_config

    t = _check_stores(a_tiles, b_tiles, "band_matmul")
    if tile is not None and tile != t:
        raise ValueError(f"band_matmul: tile={tile} but the stores hold {t}² tiles")
    out_dtype = out_dtype or a_tiles.dtype
    if (precision == "default" and get_config().stack_bf16_inputs
            and a_tiles.dtype == torch.float32):
        a_tiles, b_tiles = a_tiles.to(torch.bfloat16), b_tiles.to(torch.bfloat16)
    host = plan.plan if isinstance(plan, DeviceBandPlan) else plan
    if a_tiles.device.type == "cpu":
        return band_matmul_plain(a_tiles, b_tiles, host, out_dtype=out_dtype)
    dplan = plan if isinstance(plan, DeviceBandPlan) else device_band_plan(
        plan, a_tiles.device
    )
    check_cuda_operands(
        a_tiles, b_tiles, (dplan.a_pack, dplan.b_pack, dplan.c_unpack),
        "band_matmul", DTYPE_CODE_F64,
    )
    if dplan.a_end > a_tiles.shape[0] or dplan.b_end > b_tiles.shape[0]:
        raise IndexError("band_matmul: pack map beyond the tile stores")
    from .._build import check_launch, kernels

    acc = torch.float64 if a_tiles.dtype == torch.float64 else torch.float32
    n_c = len(host.c_unpack)
    out = torch.empty((n_c, t, t), dtype=acc, device=a_tiles.device)
    if n_c:
        lib = kernels()
        rc = lib.dbcsr_torch_band_matmul(
            a_tiles.data_ptr(), b_tiles.data_ptr(), out.data_ptr(),
            dplan.a_pack.data_ptr(), dplan.b_pack.data_ptr(),
            dplan.c_unpack.data_ptr(), n_c, host.wa, host.wb, host.mt,
            host.kt, host.off_a, t, DTYPE_CODE_F64[a_tiles.dtype],
            a_tiles.device.index,
            torch.cuda.current_stream(a_tiles.device).cuda_stream,
        )
        check_launch(lib, rc, "band_matmul")
        band_matmul.launches += 1
    return out if out_dtype == acc else out.to(out_dtype)


#: launches of the K5 kernel since the last reset (set it to 0 to reset)
band_matmul.launches = 0
