"""The local multiply engine: C := alpha * op(A) * op(B) + beta * C.

Port of ``dbcsr_tpu/mm/engine.py``'s single-device path (``multiply``,
``_execute_local``, ``build_multiply_executor``), the reference's
``dbcsr_multiply_generic`` (``src/mm/dbcsr_mm.F:336-1023``) for one
device: host symbolic plan (``plan.py``) → tile-granular product on the
operand TILE STORES → tile-level alignment into the result's store.

Local execution is a small DRIVER REGISTRY. A driver turns the host
description of one product (``_Problem``) into a ``LocalPlan``: the
product tiles it returns and how to compute them from the op(A)/op(B) tile
stores. Ported drivers:

- ``dense``: scatter tiles into full padded panels and run one matmul (the
  ``make_dense`` fast path); plain torch, as the JAX package left it to XLA;
- ``panel``: the panel plan and kernel K2 (``panel.py``), for banded and
  clustered patterns;
- ``stack``: the flat stack kernel K1 (``kernels.py``).

``mm_driver="auto"`` picks as the JAX package's untuned auto does: dense at
or above ``dense_threshold`` tile occupancy, else the panel plan when the
pattern is banded and the plan is admitted, else the flat stack. It has no
band candidate until K5 is ported; the band, grouped and run-fused panel
drivers plug into ``_DRIVERS`` later without touching the rest.

Precision (``matmul_precision``): "highest" is IEEE float32 everywhere;
"high" runs the dense path in TF32; "default" feeds bfloat16 to the dense
path (float32 accumulation) and, with ``stack_bf16_inputs`` /
``panel_bf16_inputs``, to the stack kernels. The stack kernels' own
arithmetic is fixed by their input dtype (see ``kernels.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..block.bcsr import BCSRMatrix, SYM_NONE
from ..block.index import BCSRIndex, build_index, merge_index
from ..block.store import store_layout
from ..block.tileops import (
    apply_tile_gather,
    take_tiles,
    tile_align_map,
    tile_gather,
    transpose_order,
    valid_mask,
)
from ..core.config import config_fingerprint, get_config
from ..core.errors import DbcsrError, dbcsr_assert
from ..core.stats import get_stats
from ..core.timing import timed
from .kernels import DeviceStack, device_stack, tf32_matmul, tile_stack_matmul
from .panel import (
    DevicePanelPlan,
    PanelPlan,
    device_panel_plan,
    plan_panel_stack,
    tile_stack_matmul_panel,
)
from .plan import symbolic_product
from .plancache import get_plan_cache
from .tileplan import TileStackPlan, plan_tile_stacks_stores

__all__ = ["multiply", "build_multiply_executor", "LocalPlan"]

_PRECISIONS = ("default", "high", "highest")


def _effective_trans(trans: str) -> Tuple[bool, bool]:
    trans = trans.upper()
    dbcsr_assert(trans in ("N", "T", "C"), f"bad transpose flag {trans!r}")
    return trans in ("T", "C"), trans == "C"


# ---------------------------------------------------------------------------
# options of the JAX package that the port does not run yet
# ---------------------------------------------------------------------------

_UNPORTED_DRIVERS = {
    "band": "mm_driver='band' needs the band kernel, K5 in ROADMAP Queue 2 "
            "(Queue 1 item 6)",
    "grouped": "mm_driver='grouped' needs the grouped kernel, K4 in ROADMAP "
               "Queue 2 (Queue 1 item 6)",
    "xla": "mm_driver='xla' selects the JAX package's XLA twin; the port "
           "runs its plain versions only for CPU tensors (use 'stack')",
}


def _reject_unported(a, b, c, *, filter_eps=None, limits=None, dist=None,
                     k_dist=None) -> None:
    if filter_eps is not None:
        raise NotImplementedError(
            "filter_eps (on-the-fly filtering) is not ported yet: ROADMAP "
            "Queue 1 item 5"
        )
    if limits is not None:
        raise NotImplementedError(
            "limits (sub-matrix windows) are not ported yet: ROADMAP Queue 1 "
            "item 4"
        )
    if dist is not None or k_dist is not None:
        raise NotImplementedError(
            "distributed multiplies (dist, k_dist) are not ported yet: "
            "ROADMAP Queue 1 item 9"
        )
    for m in (a, b, c):
        if m is not None and m.data.is_complex():
            raise NotImplementedError(
                "complex matrices are not ported yet: ROADMAP Queue 1 item 7"
            )


def _check_config(cfg, driver: str) -> None:
    if driver in _UNPORTED_DRIVERS:
        raise NotImplementedError(_UNPORTED_DRIVERS[driver])
    if driver != "auto" and driver not in _DRIVERS:
        raise DbcsrError(f"unknown mm_driver {driver!r}")
    if cfg.panel_runlen >= 2:
        raise NotImplementedError(
            "panel_runlen >= 2 (k-run fusion) needs the run-fused panel "
            "kernel, K3 in ROADMAP Queue 2 (Queue 1 item 6)"
        )
    if cfg.reorder != "off":
        raise NotImplementedError(
            f"reorder={cfg.reorder!r}: the RCM locality reordering is not "
            "ported yet (ROADMAP Queue 1 item 5); use reorder='off'"
        )
    dbcsr_assert(
        cfg.matmul_precision in _PRECISIONS,
        f"bad matmul_precision {cfg.matmul_precision!r}",
    )


# ---------------------------------------------------------------------------
# op(M) patterns and stores
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _OpPattern:
    """Host view of op(M): row-major tile coords, tile grid, and the store
    slot of each op tile (None for 'N', where the store IS op(M)'s)."""

    coords: np.ndarray
    grid: Tuple[int, int]
    perm: Optional[np.ndarray]


def _op_pattern(m: BCSRMatrix, trans: bool) -> _OpPattern:
    lay = m.layout
    if not trans:
        return _OpPattern(lay.tile_coords, (lay.ntr, lay.ntc), None)
    order, coords_t = transpose_order(m.index, m.tile)
    return _OpPattern(coords_t, (lay.ntc, lay.ntr), order)


def _op_store(data: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
    """op(M)'s tile store: 'N' is free; 'T' (and 'C' on real data) is one
    tile permutation plus a per-tile transpose."""
    if perm is None:
        return data
    return data.index_select(0, perm).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# dense path (plain torch: a large matmul, as the JAX package left it to XLA)
# ---------------------------------------------------------------------------

def _matmul(pa: torch.Tensor, pb: torch.Tensor, prec: str) -> torch.Tensor:
    """2-D product at ``prec``: "highest" IEEE float32, "high" TF32,
    "default" bfloat16 inputs with float32 accumulation. float64 stays
    float64; bfloat16 data multiplies with float32 accumulation."""
    dt = pa.dtype
    if dt == torch.float32 and prec == "default":
        pa, pb = pa.to(torch.bfloat16), pb.to(torch.bfloat16)
    if pa.dtype == torch.bfloat16:
        if pa.is_cuda:
            out = torch.mm(pa, pb, out_dtype=torch.float32)
        else:
            # products of bf16 values are exact in float32
            with tf32_matmul(False):
                out = torch.mm(pa.float(), pb.float())
        return out.to(dt)
    with tf32_matmul(dt == torch.float32 and prec == "high"):
        return torch.mm(pa, pb)


def _stores_to_panel(store, keys: Optional[torch.Tensor], *, ntr, ntc, t):
    """Tile-level scatter of a store into the full padded dense panel
    (``keys`` None: the store is tile-complete and already grid-ordered)."""
    if keys is None:
        grid = store
    else:
        grid = store.new_zeros((ntr * ntc, t, t))
        if store.shape[0]:
            grid[keys] = store
    return grid.reshape(ntr, ntc, t, t).permute(0, 2, 1, 3).reshape(ntr * t, ntc * t)


def _panel_to_tiles(panel, *, ntr, ntc, t):
    """The full tile grid of a dense panel, row-major tile order."""
    return panel.reshape(ntr, t, ntc, t).permute(0, 2, 1, 3).reshape(ntr * ntc, t, t)


def _dense_tiles_einsum(a_store, b_store, *, mt, kt, nt, t, prec):
    """Dense product of tile-COMPLETE stores, the JAX package's einsum
    ``mkat,kntb->mnab`` over 4-D tile views, written as one matmul over the
    panel views so every precision mode maps onto one ``_matmul``."""
    pa = _stores_to_panel(a_store, None, ntr=mt, ntc=kt, t=t)
    pb = _stores_to_panel(b_store, None, ntr=kt, ntc=nt, t=t)
    return _panel_to_tiles(_matmul(pa, pb, prec), ntr=mt, ntc=nt, t=t)


def _maybe_bf16(dtype: torch.dtype, prec: str, cfg) -> torch.dtype:
    """The flat stack kernel's input dtype: bfloat16 with float32
    accumulation for float32 data at precision "default" when
    ``stack_bf16_inputs`` (halves the kernel's operand bytes), else the
    data's own dtype."""
    if cfg.stack_bf16_inputs and prec == "default" and dtype == torch.float32:
        return torch.bfloat16
    return dtype


def _maybe_panel_bf16(dtype: torch.dtype, prec: str, cfg) -> torch.dtype:
    """The panel kernel's input dtype, gated on its own knob
    (``panel_bf16_inputs``)."""
    if cfg.panel_bf16_inputs and prec == "default" and dtype == torch.float32:
        return torch.bfloat16
    return dtype


def _kernel_run(kernel, dev_plan, dtype: torch.dtype, in_dtype: torch.dtype):
    """``product`` of a stack route: convert the op stores to the kernel's
    input dtype (once per call, when it differs) and launch."""
    out_dtype = torch.float32 if in_dtype != dtype else None

    def run(a_st, b_st):
        return kernel(a_st.to(in_dtype), b_st.to(in_dtype), dev_plan,
                      out_dtype=out_dtype)

    return run


# ---------------------------------------------------------------------------
# panel admission (host)
# ---------------------------------------------------------------------------

def _tuned_driver(cfg, a_index, b_index) -> Optional[str]:
    """Tuned per-class driver preference (only when the user left
    mm_driver at its default)."""
    if cfg.provenance("mm_driver") != "D":
        return None
    from ..autotune import tuned_stack_params

    best = tuned_stack_params(a_index, b_index)
    return best.get("mm_driver") if best else None


def _panel_knobs(cfg, a_index, b_index) -> Tuple[int, int, int]:
    """Panel plan parameters: user/env-set config wins; defaults defer to
    the tuned per-class table (none exists for this card yet)."""
    c_win, cache, chunk = cfg.panel_c_win, cfg.panel_cache, cfg.panel_chunk
    provs = tuple(
        cfg.provenance(n) for n in ("panel_c_win", "panel_cache", "panel_chunk")
    )
    if "D" in provs:
        from ..autotune import tuned_stack_params

        best = tuned_stack_params(a_index, b_index)
        if best:
            if provs[0] == "D":
                c_win = int(best.get("panel_c_win", c_win))
            if provs[1] == "D":
                cache = int(best.get("panel_cache", cache))
            if provs[2] == "D":
                chunk = int(best.get("panel_chunk", chunk))
    return c_win, cache, chunk


def _maybe_panel_plan(
    cfg, tplan: TileStackPlan, a_index, b_index, n_a, n_b, driver, tuned,
) -> Optional[PanelPlan]:
    """PanelPlan when the panel kernel should execute this stack, else None.
    Explicit ``mm_driver="panel"`` (or a tuned preference) skips the
    traffic test; untuned "auto" first gates on the cheap bandedness
    feature, then requires the span traffic to undercut the flat kernel's
    2 tiles/entry by ``panel_admit``."""
    if driver == "panel" or (driver == "auto" and tuned == "panel"):
        admit = None
    elif driver == "auto" and tuned is None:
        from ..autotune import BANDED_GATE, workload_features

        if workload_features(a_index, b_index)[3] < BANDED_GATE:
            return None
        admit = cfg.panel_admit
    else:
        return None
    c_win, cache, chunk = _panel_knobs(cfg, a_index, b_index)
    return plan_panel_stack(
        tplan.stack, tplan.n_c_tiles, n_a, n_b,
        c_win=c_win, a_cap=cache, b_cap=cache, chunk=chunk, admit_ratio=admit,
    )


def _cached_panel_plan(
    cfg, tplan, a_index, b_index, ta, tb, tile, n_a, n_b, driver, tuned,
) -> Optional[PanelPlan]:
    """Panel planning is O(S log S) host work; iterative callers repeat it
    on identical patterns. Cache the outcome — including the None
    "inadmissible" verdict — keyed by operand content, orientation, tile,
    store sizes, driver and the config WITH provenance."""
    pcache = get_plan_cache()
    key = pcache.key(
        a_index, ta, b_index, tb,
        extra=("panel_plan", tile, n_a, n_b, driver, tuned,
               config_fingerprint(cfg)),
    )
    cached = pcache.get(key)
    if cached is not None:
        return cached[0]
    plan = _maybe_panel_plan(
        cfg, tplan, a_index, b_index, n_a, n_b, driver, tuned
    )
    pcache.put(key, (plan,))
    return plan


# ---------------------------------------------------------------------------
# the driver registry
# ---------------------------------------------------------------------------

@dataclass
class _Problem:
    """Host description of one local product op(A)·op(B)."""

    a_index: BCSRIndex
    b_index: BCSRIndex
    ta: bool
    tb: bool
    tile: int
    dtype: torch.dtype
    device: torch.device
    a_op: _OpPattern
    b_op: _OpPattern
    mt: int
    kt: int
    nt: int
    cfg: object
    driver: str
    _tplan: Optional[TileStackPlan] = None

    def tile_plan(self) -> TileStackPlan:
        if self._tplan is None:
            self._tplan = plan_tile_stacks_stores(
                self.a_op.coords, (self.mt, self.kt),
                self.b_op.coords, (self.kt, self.nt),
            )
        return self._tplan


@dataclass
class LocalPlan:
    """One planned local product, as a driver returns it: ``run(a_data,
    b_data)`` gives the product tiles whose row-major keys are
    ``prod_keys``. Everything it reads besides the data — the op(A)/op(B)
    store permutations, the stack or panel plan — is resident on the
    operands' device."""

    route: str  # the driver that planned it
    prod_keys: np.ndarray
    hw_flops: float
    product: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # op stores -> tiles
    in_dtype: Optional[torch.dtype] = None  # what a stack kernel consumes
    tile_plan: Optional[TileStackPlan] = None
    stack: Optional[DeviceStack] = None
    panel: Optional[DevicePanelPlan] = None
    a_perm: Optional[torch.Tensor] = None
    b_perm: Optional[torch.Tensor] = None

    def run(self, a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        return self.product(
            _op_store(a_data, self.a_perm), _op_store(b_data, self.b_perm)
        )


_DRIVERS: Dict[str, Callable[[_Problem, bool], Optional[LocalPlan]]] = {}

#: sparse candidates "auto" tries in order (the band driver goes first once
#: K5 is ported, as in the JAX package)
_AUTO_SPARSE_ORDER = ("panel", "stack")


def _driver(name: str):
    def deco(fn):
        _DRIVERS[name] = fn
        return fn

    return deco


def _keys(coords: np.ndarray, ncols: int) -> np.ndarray:
    return coords[:, 0].astype(np.int64) * ncols + coords[:, 1]


@_driver("dense")
def _dense_route(p: _Problem, explicit: bool) -> LocalPlan:
    mt, kt, nt, t = p.mt, p.kt, p.nt, p.tile
    prec = p.cfg.matmul_precision
    complete = len(p.a_op.coords) == mt * kt and len(p.b_op.coords) == kt * nt
    if complete:
        def run(a_st, b_st):
            return _dense_tiles_einsum(
                a_st, b_st, mt=mt, kt=kt, nt=nt, t=t, prec=prec
            )
    else:
        a_keys = torch.as_tensor(_keys(p.a_op.coords, kt), device=p.device)
        b_keys = torch.as_tensor(_keys(p.b_op.coords, nt), device=p.device)

        def run(a_st, b_st):
            pa = _stores_to_panel(a_st, a_keys, ntr=mt, ntc=kt, t=t)
            pb = _stores_to_panel(b_st, b_keys, ntr=kt, ntc=nt, t=t)
            return _panel_to_tiles(_matmul(pa, pb, prec), ntr=mt, ntc=nt, t=t)

    return LocalPlan(
        "dense", np.arange(mt * nt, dtype=np.int64),
        2.0 * float(mt) * kt * nt * t**3, run,
    )


@_driver("panel")
def _panel_route(p: _Problem, explicit: bool) -> Optional[LocalPlan]:
    cfg = p.cfg
    if not explicit and p.dtype not in (torch.float32, torch.bfloat16):
        return None  # the panel kernel's dtypes (float64 stacks: K6)
    tplan = p.tile_plan()
    tuned = None if explicit else _tuned_driver(cfg, p.a_index, p.b_index)
    pplan = _cached_panel_plan(
        cfg, tplan, p.a_index, p.b_index, p.ta, p.tb, p.tile,
        len(p.a_op.coords), len(p.b_op.coords),
        "panel" if explicit else "auto", tuned,
    )
    if pplan is None:
        if explicit:
            raise DbcsrError("pattern not panel-admissible (see mm/panel.py)")
        return None
    dplan = device_panel_plan(pplan, p.device)
    in_dt = _maybe_panel_bf16(p.dtype, cfg.matmul_precision, cfg)
    return LocalPlan(
        "panel", tplan.c_tile_keys, 2.0 * len(tplan.stack) * p.tile**3,
        _kernel_run(tile_stack_matmul_panel, dplan, p.dtype, in_dt),
        in_dtype=in_dt, tile_plan=tplan, panel=dplan,
    )


@_driver("stack")
def _stack_route(p: _Problem, explicit: bool) -> LocalPlan:
    cfg = p.cfg
    tplan = p.tile_plan()
    ds = device_stack(tplan.stack, tplan.n_c_tiles, p.device)
    in_dt = _maybe_bf16(p.dtype, cfg.matmul_precision, cfg)
    return LocalPlan(
        "stack", tplan.c_tile_keys, 2.0 * len(tplan.stack) * p.tile**3,
        _kernel_run(tile_stack_matmul, ds, p.dtype, in_dt),
        in_dtype=in_dt, tile_plan=tplan, stack=ds,
    )


def _empty_route(p: _Problem) -> LocalPlan:
    """No tile triples: the product has no tiles (the caller's alignment
    fills C's tiles with zeros)."""
    t = p.tile

    def run(a_st, b_st):
        return a_st.new_zeros((0, t, t))

    return LocalPlan("empty", np.zeros(0, np.int64), 0.0, run,
                     tile_plan=p.tile_plan())


def _select_route(p: _Problem) -> LocalPlan:
    if p.driver == "dense":
        return _dense_route(p, True)
    tplan = p.tile_plan()
    if p.driver == "auto":
        density = len(tplan.stack) / max(p.mt * p.kt * p.nt, 1)
        if density >= p.cfg.dense_threshold:
            return _dense_route(p, False)
    if len(tplan.stack) == 0:
        return _empty_route(p)
    if p.driver != "auto":
        return _DRIVERS[p.driver](p, True)
    for name in _AUTO_SPARSE_ORDER:
        route = _DRIVERS[name](p, False)
        if route is not None:
            return route
    raise AssertionError("the flat stack driver always accepts")


def _plan_local(a: BCSRMatrix, ta: bool, b: BCSRMatrix, tb: bool, cfg,
                driver: str) -> LocalPlan:
    dbcsr_assert(a.tile == b.tile, "operand tile sizes differ")
    dbcsr_assert(a.dtype == b.dtype, f"operand dtypes differ ({a.dtype}, {b.dtype})")
    dbcsr_assert(a.device == b.device, f"operands on {a.device} and {b.device}")
    a_op, b_op = _op_pattern(a, ta), _op_pattern(b, tb)
    (mt, kt), (kt2, nt) = a_op.grid, b_op.grid
    dbcsr_assert(kt == kt2, "tile grid K mismatch")
    p = _Problem(
        a_index=a.index, b_index=b.index, ta=ta, tb=tb, tile=a.tile,
        dtype=a.dtype, device=a.device, a_op=a_op, b_op=b_op,
        mt=mt, kt=kt, nt=nt, cfg=cfg, driver=driver,
    )
    with timed("multiply/route"):
        plan = _select_route(p)
    for op, name in ((a_op, "a_perm"), (b_op, "b_perm")):
        if op.perm is not None:
            setattr(plan, name, torch.as_tensor(op.perm.astype(np.int64), device=a.device))
    return plan


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _align_old_c(c: Optional[BCSRMatrix], c_index: BCSRIndex, tile: int):
    """Old C's store gathered into the new C tile layout (tile-level)."""
    if c is None or c.nblks == 0:
        return None
    new_lay = store_layout(c_index, tile)
    amap = tile_align_map(new_lay.tile_keys(), c.layout.tile_keys())
    return take_tiles(c.data, amap, tile)


def _execute_local(a, ta, b, tb, c, c_index, alpha, beta, cfg, *,
                   mask_result: bool) -> torch.Tensor:
    tile = a.tile
    pcache = get_plan_cache()
    key = pcache.key(
        a.index, ta, b.index, tb,
        extra=("local_plan", tile, str(a.dtype), str(a.device),
               config_fingerprint(cfg)),
    )
    cached = pcache.get(key)
    if cached is not None:
        lp = cached[0]
    else:
        lp = _plan_local(a, ta, b, tb, cfg, cfg.mm_driver)
        pcache.put(key, (lp,))
    prod = lp.run(a.data, b.data)
    get_stats().hardware_flops += lp.hw_flops
    c_keys = store_layout(c_index, tile).tile_keys()
    prod = take_tiles(prod, tile_align_map(c_keys, lp.prod_keys), tile).to(a.dtype)
    if mask_result and len(c_keys):
        prod = prod * valid_mask(c_index, tile, prod.device).to(prod.dtype)
    old = _align_old_c(c, c_index, tile)
    if old is None:
        return alpha * prod
    return alpha * prod + beta * old


def multiply(
    transa: str,
    transb: str,
    alpha,
    a: BCSRMatrix,
    b: BCSRMatrix,
    beta=0.0,
    c: Optional[BCSRMatrix] = None,
    *,
    filter_eps: Optional[float] = None,
    retain_sparsity: bool = False,
    return_flops: bool = False,
    dist=None,
    k_dist=None,
    limits: Optional[dict] = None,
):
    """Sparse multiply ``C := alpha·op(A)·op(B) + beta·C`` with the
    reference's semantics (``dbcsr_multiply``, ``src/dbcsr_api.F:1411``):
    transposes ('C' equals 'T' on real data), alpha/beta scaling, product
    block discovery and retain-sparsity mode, on the operands' device.
    ``filter_eps``, ``limits``, ``dist``/``k_dist``, symmetric and complex
    operands raise NotImplementedError naming the ROADMAP item that ports
    them."""
    from ..ops.transform import desymmetrize

    _reject_unported(a, b, c, filter_eps=filter_eps, limits=limits,
                     dist=dist, k_dist=k_dist)
    cfg = get_config()
    _check_config(cfg, cfg.mm_driver)
    ta, _ = _effective_trans(transa)
    tb, _ = _effective_trans(transb)

    with timed("multiply"):
        a = desymmetrize(a)
        b = desymmetrize(b)
        if c is not None:
            desymmetrize(c)
        dbcsr_assert(a.tile == b.tile, "operand tile sizes differ")
        m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
        k_sizes_a = a.index.row_block_sizes if ta else a.index.col_block_sizes
        k_sizes_b = b.index.col_block_sizes if tb else b.index.row_block_sizes
        n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
        dbcsr_assert(
            np.array_equal(k_sizes_a, k_sizes_b),
            "inner block dimensions do not match",
        )
        if c is not None:
            dbcsr_assert(
                np.array_equal(c.index.row_block_sizes, m_sizes)
                and np.array_equal(c.index.col_block_sizes, n_sizes),
                "C block structure does not match the product",
            )
            dbcsr_assert(c.tile == a.tile, "C tile size differs from operands")

        with timed("multiply/plan"):
            pcache = get_plan_cache()
            cache_key = pcache.key(a.index, ta, b.index, tb)
            cached = pcache.get(cache_key)
            if cached is not None:
                symb, prod_index = cached
            else:
                symb = symbolic_product(a.index, ta, b.index, tb)
                prod_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
                pcache.put(cache_key, (symb, prod_index))
            if retain_sparsity:
                dbcsr_assert(c is not None, "retain_sparsity requires c")
                c_index = c.index
            elif c is not None and c.nblks:
                c_index, _, _ = merge_index(c.index, prod_index)
            else:
                c_index = prod_index

        with timed("multiply/exec"):
            out_data = _execute_local(
                a, ta, b, tb, c, c_index, alpha, beta, cfg,
                mask_result=retain_sparsity,
            )
        result = BCSRMatrix(
            name=(c.name if c is not None else "product"),
            index=c_index, data=out_data, sym=SYM_NONE,
        )
        stats = get_stats()
        stats.num_multiplications += 1
        stats.total_flops += symb.eff_flops
        if out_data.is_cuda:
            stats.max_memory_bytes = max(
                stats.max_memory_bytes,
                int(torch.cuda.max_memory_allocated(out_data.device)),
            )

    if return_flops:
        return result, symb.eff_flops
    return result


def build_multiply_executor(
    transa: str,
    transb: str,
    a: BCSRMatrix,
    b: BCSRMatrix,
    *,
    driver: Optional[str] = None,
):
    """Plan once, execute many: returns ``(fn, c_index, eff_flops)`` where
    ``fn(a_store, b_store) -> c_store`` computes op(A)·op(B) for NEW DATA
    with the SAME sparsity patterns, on the operands' device (the analog of
    the reference's batched-multiply state machine). All host planning —
    symbolic product, tile stack, driver choice, panel plan — and every
    index upload happen here; a call is the device work alone.
    ``fn.plan`` is the ``LocalPlan`` (its ``route`` names the driver)."""
    _reject_unported(a, b, None)
    cfg = get_config()
    drv = driver or cfg.mm_driver
    _check_config(cfg, drv)
    ta, _ = _effective_trans(transa)
    tb, _ = _effective_trans(transb)
    from ..ops.transform import desymmetrize

    a = desymmetrize(a)
    b = desymmetrize(b)
    m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
    n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
    symb = symbolic_product(a.index, ta, b.index, tb)
    c_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
    c_keys = store_layout(c_index, a.tile).tile_keys()
    lp = _plan_local(a, ta, b, tb, cfg, drv)
    gather = tile_gather(
        tile_align_map(c_keys, lp.prod_keys), len(lp.prod_keys), a.device
    )

    def fn(a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        return apply_tile_gather(lp.run(a_data, b_data), gather)

    fn.plan = lp
    return fn, c_index, symb.eff_flops
