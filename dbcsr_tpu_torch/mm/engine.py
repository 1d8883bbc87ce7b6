"""The local multiply engine: C := alpha * op(A) * op(B) + beta * C.

Port of ``dbcsr_tpu/mm/engine.py``'s single-device path (``multiply``,
``_execute_local``, ``build_multiply_executor``), the reference's
``dbcsr_multiply_generic`` (``src/mm/dbcsr_mm.F:336-1023``) for one
device: host symbolic plan (``plan.py``) → tile-granular product on the
operand TILE STORES → tile-level alignment into the result's store.

Local execution is a small DRIVER REGISTRY. A driver turns the host
description of one product (``_Problem``) into a ``LocalPlan``: the
product tiles it returns and how to compute them from the op(A)/op(B) tile
stores. Drivers:

- ``dense``: scatter tiles into full padded panels and run one matmul (the
  ``make_dense`` fast path); plain torch, as the JAX package left it to XLA;
- ``band``: the tile-diagonal convolution and kernel K5 (``band.py``);
- ``panel``: the panel plan and kernel K2 (``panel.py``), for banded and
  clustered patterns; with ``panel_runlen >= 2`` the run-fused plan and
  kernel K3 (route name ``"panel_runs"``), falling back to the per-entry
  plan when the column-major spans break admission;
- ``grouped``: the group plan and kernel K4 (``kernels.py``);
- ``stack``: the flat stack kernel K1 (``kernels.py``).

``mm_driver="auto"`` picks as the JAX package's auto does: dense at or above
``dense_threshold`` tile occupancy; else band when its padded work stays
within ``band_flop_factor`` of the stack's (times 0.125 unless the precision
is "default") or a tuned table prefers it; else the panel plan when the
pattern is banded and the plan is admitted; else grouped when a tuned table
prefers it; else the flat stack. The tuned table is the one measured on the
card the operands live on (``autotune.py``, ``params/<card name>.json``):
the driver of the workload class nearest to the product, and that row's
panel knobs, for the knobs the user left at their defaults. CPU operands
have no table and keep the untuned choices.

``build_multiply_executor`` also tries the RCM tile reordering
(``reorder.py``, config ``reorder``, default "auto") when the panel plan is
inadmissible under "auto" or "panel": if the renumbered pattern passes the
bandedness gate and its replan is admitted, the plan runs on the renumbered
stack and gathers the operand stores into the new slot order on each call.
The one-shot ``multiply`` does not reorder, as in the JAX package.

With a ``dist``, ``multiply`` and ``build_distributed_executor`` run over a
process grid and plan through one function, ``cannon.plan_distributed``
(Cannon on square grids, SUMMA otherwise, ``mm_dist_algo``).

float64 data: "auto", "stack" and "panel" take the float64 stack kernel, the
port of K6 (``f64_stack.py``), as the JAX package never gives float64 to its
f32 panel or flat kernels; an explicit "band" or "grouped" runs that
driver's kernel in float64; the dense class stays a float64 ``torch.mm``.

Complex data (complex64, complex128): every sparse driver takes the complex
flat stack kernels KC1/KC2 (``c_stack.py``, route ``"c_stack"``), as the JAX
package's native complex always takes its flat stack; the dense class stays
a complex ``torch.mm``. 'C' conjugates the transposed store physically
(``torch.conj_physical``: the kernels read raw memory, so torch's lazy
conjugation bit must never reach them). A real operand times a complex one
is computed in the promoted complex type.

``multiply(filter_eps=...)`` is the reference's on-the-fly filtering:
operand block norms → the filtered symbolic product (``plan.py``) → the
product masked to the surviving blocks → the final norm filter
(``ops/arithmetic.filter_blocks``). Symmetric operands are expanded
(``ops/transform.desymmetrize``); a symmetric C is computed in full storage
and folded back.

Precision (``matmul_precision``): "highest" is IEEE float32 everywhere;
"high" runs the dense path in TF32; "default" feeds bfloat16 to the dense
path (float32 accumulation) and, with ``stack_bf16_inputs`` /
``panel_bf16_inputs``, to the stack kernels. The stack kernels' own
arithmetic is fixed by their input dtype (see ``kernels.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

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
from .band import DeviceBandPlan, band_matmul, device_band_plan, plan_band
from .c_stack import tile_stack_matmul_c
from .f64_stack import (
    CHUNKED_TILES,
    depth_flops,
    entry_depths,
    f64_device_stack,
    operand_chunk_masks,
    tile_stack_matmul_f64,
)
from .kernels import (
    DeviceGroupPlan,
    DeviceStack,
    device_group_plan,
    device_stack,
    tf32_matmul,
    tile_stack_matmul,
    tile_stack_matmul_grouped,
)
from .panel import (
    DevicePanelPlan,
    DevicePanelRunPlan,
    PanelPlan,
    PanelRunPlan,
    device_panel_plan,
    device_panel_run_plan,
    plan_panel_runs,
    plan_panel_stack,
    tile_stack_matmul_panel,
    tile_stack_matmul_panel_runs,
)
from .plan import symbolic_product
from .plancache import array_fingerprint, get_plan_cache, index_fingerprint
from .reorder import ReorderPlan, locality_reorder_plan
from .tileplan import TileStackPlan, plan_tile_stacks_stores

__all__ = ["multiply", "build_multiply_executor", "build_distributed_executor",
           "LocalPlan"]

_PRECISIONS = ("default", "high", "highest")
_F64_METHODS = ("auto", "native", "ozaki")


def _effective_trans(trans: str) -> Tuple[bool, bool]:
    trans = trans.upper()
    dbcsr_assert(trans in ("N", "T", "C"), f"bad transpose flag {trans!r}")
    return trans in ("T", "C"), trans == "C"


# ---------------------------------------------------------------------------
# options of the JAX package that the port does not run yet
# ---------------------------------------------------------------------------

_UNPORTED_DRIVERS = {
    "xla": "mm_driver='xla' selects the JAX package's XLA twin; the port "
           "runs its plain versions only for CPU tensors (use 'stack')",
}


def _dist_algo(algo: str, grid) -> str:
    """The distributed algorithm: "auto" takes Cannon on square grids and
    SUMMA otherwise; Cannon on a non-square grid raises."""
    dbcsr_assert(algo in ("auto", "cannon", "summa"), f"bad mm_dist_algo {algo!r}")
    if algo == "auto":
        algo = "cannon" if grid.nprow == grid.npcol else "summa"
    if algo == "cannon":
        dbcsr_assert(
            grid.nprow == grid.npcol,
            "Cannon requires a square grid; use mm_dist_algo='summa'",
        )
    return algo


def _promote_operands(a: BCSRMatrix, b: BCSRMatrix):
    """A real operand times a complex one: both in the promoted complex
    type (the JAX package's CPU path promotes a real B against a complex A
    the same way). Operands of one type, or of two real types, are
    returned as they are."""
    if a.dtype == b.dtype or not (a.dtype.is_complex or b.dtype.is_complex):
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.with_data(a.data.to(dt)), b.with_data(b.data.to(dt))


def _coefficient(x, dtype: torch.dtype):
    """alpha/beta as the JAX package applies them (``jnp.asarray(x,
    a.dtype)``): a complex coefficient on real data keeps its real part."""
    if isinstance(x, complex) and not dtype.is_complex:
        return x.real
    return x


def _check_config(cfg, driver: str) -> None:
    if driver in _UNPORTED_DRIVERS:
        raise NotImplementedError(_UNPORTED_DRIVERS[driver])
    if driver != "auto" and driver not in _DRIVERS:
        raise DbcsrError(f"unknown mm_driver {driver!r}")
    if cfg.f64_slices != 0:
        raise NotImplementedError(
            f"f64_slices={cfg.f64_slices}: the port multiplies float64 "
            "natively and has no Ozaki slices to count (ops/f64_emu.py is on "
            "ROADMAP Queue 1's \"Do not port\" list); use f64_slices=0"
        )
    dbcsr_assert(
        cfg.matmul_precision in _PRECISIONS,
        f"bad matmul_precision {cfg.matmul_precision!r}",
    )
    dbcsr_assert(
        cfg.f64_method in _F64_METHODS, f"bad f64_method {cfg.f64_method!r}"
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


def _op_sizes(a: BCSRMatrix, ta: bool, b: BCSRMatrix, tb: bool):
    """op(A)·op(B)'s block sizes along m, k and n."""
    m, k = ((a.index.col_block_sizes, a.index.row_block_sizes) if ta
            else (a.index.row_block_sizes, a.index.col_block_sizes))
    return m, k, b.index.row_block_sizes if tb else b.index.col_block_sizes


def _op_pattern(m: BCSRMatrix, trans: bool) -> _OpPattern:
    lay = m.layout
    if not trans:
        return _OpPattern(lay.tile_coords, (lay.ntr, lay.ntc), None)
    order, coords_t = transpose_order(m.index, m.tile)
    return _OpPattern(coords_t, (lay.ntc, lay.ntr), order)


def _op_store(data: torch.Tensor, perm: Optional[torch.Tensor],
              conj: bool = False) -> torch.Tensor:
    """op(M)'s tile store: 'N' is free; 'T' (and 'C' on real data) is one
    tile permutation plus a per-tile transpose; 'C' on complex data also
    conjugates, physically: a kernel reading the raw memory of a lazy
    ``torch.conj`` view would multiply the unconjugated values."""
    conj = conj and data.is_complex()
    if perm is None:
        return torch.conj_physical(data) if conj else data
    out = data.index_select(0, perm).transpose(1, 2).contiguous()
    return out.conj_physical_() if conj else out


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

def _tuned_row(a_index, b_index, device) -> tuple:
    """The tuned table's row for this product on ``device`` as a cache-key
    part: two calls under one config can see different tables."""
    from ..autotune import tuned_stack_params

    best = tuned_stack_params(a_index, b_index, device)
    return tuple(sorted(best.items())) if best else ()


def _tuned_driver(cfg, a_index, b_index, device) -> Optional[str]:
    """Tuned per-class driver preference on ``device`` (only when the user
    left mm_driver at its default)."""
    if cfg.provenance("mm_driver") != "D":
        return None
    from ..autotune import tuned_stack_params

    best = tuned_stack_params(a_index, b_index, device)
    return best.get("mm_driver") if best else None


def _panel_knobs(cfg, a_index, b_index, device) -> Tuple[int, int, int, int]:
    """Panel plan parameters (c_win, cache, chunk, runlen): user/env-set
    config wins; defaults defer to the tuned row of the nearest workload
    class in the table of ``device``."""
    c_win, cache, chunk = cfg.panel_c_win, cfg.panel_cache, cfg.panel_chunk
    runlen = cfg.panel_runlen
    provs = tuple(
        cfg.provenance(n)
        for n in ("panel_c_win", "panel_cache", "panel_chunk", "panel_runlen")
    )
    if "D" in provs:
        from ..autotune import tuned_stack_params

        best = tuned_stack_params(a_index, b_index, device)
        if best:
            if provs[0] == "D":
                c_win = int(best.get("panel_c_win", c_win))
            if provs[1] == "D":
                cache = int(best.get("panel_cache", cache))
            if provs[2] == "D":
                chunk = int(best.get("panel_chunk", chunk))
            if provs[3] == "D":
                runlen = int(best.get("panel_runlen", runlen))
    return c_win, cache, chunk, runlen


def _maybe_panel_plan(
    cfg, tplan: TileStackPlan, a_index, b_index, n_a, n_b, driver, tuned,
    knobs: Tuple[int, int, int, int],
    banded_hint: Optional[float] = None,
    b_coords: Optional[np.ndarray] = None,
) -> Union[PanelPlan, PanelRunPlan, None]:
    """The plan when a panel kernel should execute this stack, else None.
    Explicit ``mm_driver="panel"`` (or a tuned preference) skips the
    traffic test; untuned "auto" first gates on the cheap bandedness
    feature, then requires the span traffic to undercut the flat kernel's
    2 tiles/entry by ``panel_admit``. ``banded_hint`` overrides the
    block-index bandedness: the reorder replan passes the bandedness of the
    REORDERED tile coords, since the user's block numbering no longer
    reflects the pattern the kernel will see. With ``panel_runlen >= 2``
    and ``b_coords`` the run-fused plan is tried first, on the column-major
    B numbering, and the per-entry plan is the fallback. ``knobs`` are the
    resolved (c_win, cache, chunk, runlen) of ``_panel_knobs``."""
    if driver == "panel" or (driver == "auto" and tuned == "panel"):
        admit = None
    elif driver == "auto" and tuned is None:
        from ..autotune import BANDED_GATE, workload_features

        banded = (
            banded_hint if banded_hint is not None
            else workload_features(a_index, b_index)[3]
        )
        if banded < BANDED_GATE:
            return None
        admit = cfg.panel_admit
    else:
        return None
    c_win, cache, chunk, runlen = knobs
    if runlen >= 2 and b_coords is not None:
        kt_b = int(b_coords[:, 0].max()) + 1 if len(b_coords) else 1
        cm = np.argsort(
            b_coords[:, 1].astype(np.int64) * kt_b + b_coords[:, 0]
        ).astype(np.int32)
        rplan = plan_panel_runs(
            tplan.stack, tplan.n_c_tiles, n_a, n_b, b_cm_perm=cm,
            c_win=c_win, a_cap=cache, b_cap=cache, chunk=chunk,
            runlen=runlen, admit_ratio=admit,
        )
        if rplan is not None:
            return rplan
    return plan_panel_stack(
        tplan.stack, tplan.n_c_tiles, n_a, n_b,
        c_win=c_win, a_cap=cache, b_cap=cache, chunk=chunk, admit_ratio=admit,
    )


def _cached_panel_plan(
    cfg, tplan, a_index, b_index, ta, tb, tile, n_a, n_b, driver, tuned,
    b_coords, device,
) -> Union[PanelPlan, PanelRunPlan, None]:
    """Panel planning is O(S log S) host work; iterative callers repeat it
    on identical patterns. Cache the outcome — including the None
    "inadmissible" verdict — keyed by operand content, orientation, tile,
    store sizes, driver, the config WITH provenance and the resolved panel
    knobs, which a tuned table can change under one config (``b_coords``
    follows from B's index, ``tb`` and the tile)."""
    knobs = _panel_knobs(cfg, a_index, b_index, device)
    pcache = get_plan_cache()
    key = pcache.key(
        a_index, ta, b_index, tb,
        extra=("panel_plan", tile, n_a, n_b, driver, tuned, knobs,
               config_fingerprint(cfg)),
    )
    cached = pcache.get(key)
    if cached is not None:
        return cached[0]
    plan = _maybe_panel_plan(
        cfg, tplan, a_index, b_index, n_a, n_b, driver, tuned, knobs,
        b_coords=b_coords,
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
    #: the caller plans once and may fold a tile renumbering into the plan
    #: (``build_multiply_executor``; the one-shot ``multiply`` does not)
    may_reorder: bool = False
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
    operands' device.

    A plan on a renumbered tile grid (``reorder``, the panel route of the
    plan-once executor) also gathers the op stores into the new slot order
    (``a_gather``/``b_gather``; for a transposed operand the gather is
    folded into ``a_perm``/``b_perm``), and its ``prod_keys`` and
    ``tile_plan`` are in the NEW numbering: align through ``align_map``."""

    route: str  # the driver that planned it ("panel_runs": K3 under "panel")
    prod_keys: np.ndarray
    hw_flops: float  # what the kernel issues a call
    product: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # op stores -> tiles
    in_dtype: Optional[torch.dtype] = None  # what a stack kernel consumes
    tile_plan: Optional[TileStackPlan] = None
    stack: Optional[DeviceStack] = None
    panel: Union[DevicePanelPlan, DevicePanelRunPlan, None] = None
    band: Optional[DeviceBandPlan] = None
    grouped: Optional[DeviceGroupPlan] = None
    a_perm: Optional[torch.Tensor] = None
    b_perm: Optional[torch.Tensor] = None
    a_conj: bool = False  # 'C': op(M)'s store is conjugated
    b_conj: bool = False
    reorder: Optional[ReorderPlan] = None
    a_gather: Optional[torch.Tensor] = None
    b_gather: Optional[torch.Tensor] = None
    nt: int = 0  # tile columns of the product grid (for ``align_map``)
    #: the tile figure ``hw_flops`` comes from (None: the same; the float64
    #: stack kernel skips the mma depths its K masks leave empty)
    padded_flops: Optional[float] = None

    def __post_init__(self):
        if self.padded_flops is None:
            self.padded_flops = self.hw_flops

    @property
    def segment_counts(self) -> Tuple[int, int]:
        """``(split_runs, run_segments)`` of a call (``core/stats.py``)."""
        s = self.stack
        return (0, 0) if s is None else (s.split_runs, s.run_segments)

    def op_stores(self, a_data: torch.Tensor, b_data: torch.Tensor):
        """The op(A), op(B) tile stores as the plan's kernel reads them."""
        a_st = _op_store(a_data, self.a_perm, self.a_conj)
        b_st = _op_store(b_data, self.b_perm, self.b_conj)
        if self.a_gather is not None:
            a_st = a_st.index_select(0, self.a_gather)
        if self.b_gather is not None:
            b_st = b_st.index_select(0, self.b_gather)
        return a_st, b_st

    def run(self, a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        return self.product(*self.op_stores(a_data, b_data))

    def align_map(self, c_keys: np.ndarray) -> np.ndarray:
        """For each row-major C tile key (in the caller's numbering), the
        product tile holding it, or -1."""
        if self.reorder is not None:
            c_keys = self.reorder.c_slot_keys(c_keys, self.nt)
        return tile_align_map(c_keys, self.prod_keys)


_DRIVERS: Dict[str, Callable[[_Problem, bool], Optional[LocalPlan]]] = {}

#: sparse candidates "auto" tries in order, as the JAX package does
_AUTO_SPARSE_ORDER = ("band", "panel", "grouped", "stack")


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


@_driver("band")
def _band_route(p: _Problem, explicit: bool) -> Optional[LocalPlan]:
    """Banded tile patterns as the tile-diagonal convolution (``band.py``).
    An explicit request or a tuned preference skips the flop test; else the
    padded band work must stay within ``band_flop_factor`` of the stack's
    tile-triple count — times 0.125 unless the precision is "default", the
    JAX package's rule and constants, kept so that both packages choose the
    same route on the same input."""
    cfg = p.cfg
    tplan = p.tile_plan()
    prec = cfg.matmul_precision
    force = explicit or _tuned_driver(cfg, p.a_index, p.b_index, p.device) == "band"
    bplan = plan_band(
        p.a_op.coords, (p.mt, p.kt), p.b_op.coords, (p.kt, p.nt),
        tplan.c_tile_keys, tile=p.tile,
        n_stack=None if force else len(tplan.stack),
        max_products=cfg.band_max_products,
        flop_factor=cfg.band_flop_factor * (1.0 if prec == "default" else 0.125),
    )
    if bplan is None:
        if explicit:
            raise DbcsrError("pattern not band-suitable (see mm/band.py)")
        return None
    dplan = device_band_plan(bplan, p.device)

    def run(a_st, b_st):
        return band_matmul(a_st, b_st, dplan, tile=p.tile, precision=prec)

    return LocalPlan(
        "band", tplan.c_tile_keys, bplan.hw_flops, run,
        in_dtype=_maybe_bf16(p.dtype, prec, cfg), tile_plan=tplan, band=dplan,
    )


def _reordered_panel_plan(p: _Problem, driver: str, tuned):
    """Clustered-but-scrambled patterns: an RCM tile renumbering
    (``reorder.py``) can make the panel plan admissible. Returns
    ``(reorder plan, replanned stack, panel plan)`` or None. A cheap
    O(n_tiles) bandedness gate on the renumbered coords comes before the
    O(S) replan: uniform-random stays uniform under any renumbering."""
    from ..autotune import BANDED_GATE, coords_bandedness

    rp = locality_reorder_plan(
        p.a_op.coords, (p.mt, p.kt), p.b_op.coords, (p.kt, p.nt)
    )
    if rp is None:
        return None
    banded_r = coords_bandedness(
        rp.a_coords[:, 0], rp.a_coords[:, 1], max(p.mt, p.kt, 1)
    )
    if banded_r < BANDED_GATE:
        return None
    tplan_r = plan_tile_stacks_stores(
        rp.a_coords, (p.mt, p.kt), rp.b_coords, (p.kt, p.nt)
    )
    # gated on the REORDERED pattern's bandedness: the block index is
    # scrambled by construction here, so its feature would always reject
    pplan_r = _maybe_panel_plan(
        p.cfg, tplan_r, p.a_index, p.b_index, len(p.a_op.coords),
        len(p.b_op.coords), driver, tuned,
        _panel_knobs(p.cfg, p.a_index, p.b_index, p.device), banded_hint=banded_r,
        b_coords=rp.b_coords,
    )
    if pplan_r is None:
        return None
    return rp, tplan_r, pplan_r


@_driver("panel")
def _panel_route(p: _Problem, explicit: bool) -> Optional[LocalPlan]:
    cfg = p.cfg
    tplan = p.tile_plan()
    tuned = None if explicit else _tuned_driver(cfg, p.a_index, p.b_index, p.device)
    driver = "panel" if explicit else "auto"
    pplan = _cached_panel_plan(
        cfg, tplan, p.a_index, p.b_index, p.ta, p.tb, p.tile,
        len(p.a_op.coords), len(p.b_op.coords), driver, tuned,
        p.b_op.coords, p.device,
    )
    rp = None
    if (pplan is None and p.may_reorder and cfg.reorder != "off"
            and (explicit or tuned in (None, "panel"))):
        with timed("multiply/reorder"):
            found = _reordered_panel_plan(p, driver, tuned)
        if found is not None:
            rp, tplan, pplan = found
    if pplan is None:
        if explicit:
            raise DbcsrError("pattern not panel-admissible (see mm/panel.py)")
        return None
    in_dt = _maybe_panel_bf16(p.dtype, cfg.matmul_precision, cfg)
    if isinstance(pplan, PanelRunPlan):
        route, kernel = "panel_runs", tile_stack_matmul_panel_runs
        dplan = device_panel_run_plan(pplan, p.device)
    else:
        route, kernel = "panel", tile_stack_matmul_panel
        dplan = device_panel_plan(pplan, p.device)
    lp = LocalPlan(
        route, tplan.c_tile_keys, 2.0 * len(tplan.stack) * p.tile**3,
        _kernel_run(kernel, dplan, p.dtype, in_dt),
        in_dtype=in_dt, tile_plan=tplan, panel=dplan, nt=p.nt,
    )
    if rp is not None:
        lp.reorder = rp
        lp.a_gather = torch.as_tensor(rp.a_gather.astype(np.int64), device=p.device)
        lp.b_gather = torch.as_tensor(rp.b_gather.astype(np.int64), device=p.device)
    return lp


@_driver("grouped")
def _grouped_route(p: _Problem, explicit: bool) -> Optional[LocalPlan]:
    """The grouped kernel K4: on explicit request, or under "auto" when a
    tuned table prefers it (after the panel route declined)."""
    cfg = p.cfg
    if not explicit and _tuned_driver(cfg, p.a_index, p.b_index, p.device) != "grouped":
        return None
    tplan = p.tile_plan()
    dplan = device_group_plan(
        tplan.stack, tplan.n_c_tiles, len(p.b_op.coords), p.device
    )
    in_dt = _maybe_bf16(p.dtype, cfg.matmul_precision, cfg)
    return LocalPlan(
        "grouped", tplan.c_tile_keys, 2.0 * len(tplan.stack) * p.tile**3,
        _kernel_run(tile_stack_matmul_grouped, dplan, p.dtype, in_dt),
        in_dtype=in_dt, tile_plan=tplan, grouped=dplan,
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


def _f64_route(p: _Problem) -> LocalPlan:
    """Every float64 sparse stack product: the float64 stack kernel (the
    port of K6) over the flat c-sorted stack, with the K occupancy masks of
    the op(A) and op(B) tiles where the kernel reads them (T = 64 and 128):
    it then issues only the mma depths that both tiles of an entry fill."""
    tplan = p.tile_plan()
    padded = 2.0 * len(tplan.stack) * p.tile**3
    issued = padded
    if p.tile in CHUNKED_TILES:
        chunks = (operand_chunk_masks(p.a_index, p.tile, p.ta, p.a_op.perm, "a"),
                  operand_chunk_masks(p.b_index, p.tile, p.tb, p.b_op.perm, "b"))
        depths = entry_depths(*chunks, tplan.stack[:, 1], tplan.stack[:, 2])
        issued = depth_flops(depths, p.tile)
        ds = f64_device_stack(tplan.stack, tplan.n_c_tiles, p.device, chunks, p.tile,
                              depths)
    else:
        ds = device_stack(tplan.stack, tplan.n_c_tiles, p.device)

    def run(a_st, b_st):
        return tile_stack_matmul_f64(a_st, b_st, ds)

    return LocalPlan(
        "f64_stack", tplan.c_tile_keys, issued, run,
        in_dtype=torch.float64, tile_plan=tplan, stack=ds, padded_flops=padded,
    )


def _c_route(p: _Problem) -> LocalPlan:
    """Every complex sparse stack product: KC1 (complex64) or KC2
    (complex128) over the flat c-sorted stack."""
    tplan = p.tile_plan()
    ds = device_stack(tplan.stack, tplan.n_c_tiles, p.device)

    def run(a_st, b_st):
        return tile_stack_matmul_c(a_st, b_st, ds)

    return LocalPlan(
        "c_stack", tplan.c_tile_keys, 2.0 * len(tplan.stack) * p.tile**3, run,
        in_dtype=p.dtype, tile_plan=tplan, stack=ds,
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
    if p.dtype.is_complex:
        return _c_route(p)
    if p.dtype == torch.float64 and p.driver in ("auto", "stack", "panel"):
        return _f64_route(p)
    if p.driver != "auto":
        return _DRIVERS[p.driver](p, True)
    for name in _AUTO_SPARSE_ORDER:
        route = _DRIVERS[name](p, False)
        if route is not None:
            return route
    raise AssertionError("the flat stack driver always accepts")


def _plan_local(a: BCSRMatrix, ta: bool, b: BCSRMatrix, tb: bool, cfg,
                driver: str, *, may_reorder: bool = False,
                conj: Tuple[bool, bool] = (False, False)) -> LocalPlan:
    dbcsr_assert(a.tile == b.tile, "operand tile sizes differ")
    dbcsr_assert(a.dtype == b.dtype, f"operand dtypes differ ({a.dtype}, {b.dtype})")
    dbcsr_assert(a.device == b.device, f"operands on {a.device} and {b.device}")
    a_op, b_op = _op_pattern(a, ta), _op_pattern(b, tb)
    (mt, kt), (kt2, nt) = a_op.grid, b_op.grid
    dbcsr_assert(kt == kt2, "tile grid K mismatch")
    p = _Problem(
        a_index=a.index, b_index=b.index, ta=ta, tb=tb, tile=a.tile,
        dtype=a.dtype, device=a.device, a_op=a_op, b_op=b_op,
        mt=mt, kt=kt, nt=nt, cfg=cfg, driver=driver, may_reorder=may_reorder,
    )
    with timed("multiply/route"):
        plan = _select_route(p)
    plan.a_conj, plan.b_conj = conj
    for op, name, gname, gather in (
        (a_op, "a_perm", "a_gather", plan.reorder and plan.reorder.a_gather),
        (b_op, "b_perm", "b_gather", plan.reorder and plan.reorder.b_gather),
    ):
        if op.perm is not None:
            perm = op.perm.astype(np.int64)
            if gather is not None:
                # one gather for both: the transpose order, then the renumbering
                perm = perm[gather]
                setattr(plan, gname, None)
            setattr(plan, name, torch.as_tensor(perm, device=a.device))
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


def _execute_local(a, ta, ca, b, tb, cb, c, c_index, alpha, beta, cfg, *,
                   mask_result: bool) -> torch.Tensor:
    tile = a.tile
    conj = (ca and a.dtype.is_complex, cb and b.dtype.is_complex)
    pcache = get_plan_cache()
    key = pcache.key(
        a.index, ta, b.index, tb,
        extra=("local_plan", tile, str(a.dtype), str(a.device), conj,
               config_fingerprint(cfg), _tuned_row(a.index, b.index, a.device)),
    )
    cached = pcache.get(key)
    if cached is not None:
        lp = cached[0]
    else:
        lp = _plan_local(a, ta, b, tb, cfg, cfg.mm_driver, conj=conj)
        pcache.put(key, (lp,))
    prod = lp.run(a.data, b.data)
    stats = get_stats()
    stats.add_tile_flops(lp.hw_flops, lp.padded_flops)
    stats.add_segments(*lp.segment_counts)
    stats.local_routes[lp.route] = stats.local_routes.get(lp.route, 0) + 1
    c_keys = store_layout(c_index, tile).tile_keys()
    prod = take_tiles(prod, lp.align_map(c_keys), tile).to(a.dtype)
    return _finish(prod, c, c_index, tile, alpha, beta, mask_result)


def _finish(prod: torch.Tensor, c, c_index: BCSRIndex, tile: int, alpha, beta,
            mask_result: bool) -> torch.Tensor:
    """``alpha * prod + beta * C`` in C's new layout, the product first
    masked to the stored blocks (filtered or retained patterns); shared by
    the local and the distributed executions."""
    if mask_result and len(prod):
        prod = prod * valid_mask(c_index, tile, prod.device).to(prod.dtype)
    alpha, beta = _coefficient(alpha, prod.dtype), _coefficient(beta, prod.dtype)
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
    block discovery, epsilon filtering (``filter_eps``: blocks of the result
    with Frobenius norm below eps are dropped), retain-sparsity mode and
    symmetric operands, sub-matrix windows (``limits``), on the operands'
    device. Complex operands take complex ``alpha``/``beta``; a real and a
    complex operand multiply in the promoted type.

    With a ``dist`` (explicit, else carried by ``c``, else by ``a``) the
    product runs over its process grid (``dist.grid``): Cannon
    (``cannon.py``) on square grids, SUMMA (``summa.py``) otherwise, as
    ``mm_dist_algo`` ("auto" | "cannon" | "summa") says; ``k_dist`` bins the
    inner dimension (default: whole tile rows round-robin). Every rank's
    product runs on the port's stack kernel for the dtype.

    Iterative filtered callers (SCF: same patterns, new data every step)
    should hold a ``build_filtered_executor`` instead: it plans once and
    runs on the device with no host sync, where this path computes block
    norms on the host and replans the filtered pattern on every call."""
    from ..ops.transform import desymmetrize, fold_symmetric

    cfg = get_config()
    _check_config(cfg, cfg.mm_driver)
    ta, ca = _effective_trans(transa)
    tb, cb = _effective_trans(transb)
    a, b = _promote_operands(a, b)
    if limits is not None:
        return _multiply_limited(
            transa, transb, alpha, a, b, beta, c, filter_eps=filter_eps,
            return_flops=return_flops, dist=dist, limits=limits,
        )

    if c is not None and c.sym != SYM_NONE:
        # symmetric product matrix: compute in full storage, fold back
        # (reference: canonical symmetric index, src/mm/dbcsr_mm.F:714)
        out = multiply(
            transa, transb, alpha, a, b, beta, desymmetrize(c),
            filter_eps=filter_eps, retain_sparsity=retain_sparsity,
            return_flops=return_flops, dist=dist, k_dist=k_dist,
        )
        if return_flops:
            return fold_symmetric(out[0], c.sym), out[1]
        return fold_symmetric(out, c.sym)

    with timed("multiply"):
        a = desymmetrize(a)
        b = desymmetrize(b)
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
            symb, prod_index = _symbolic_plan(
                a, ta, b, tb, m_sizes, n_sizes, filter_eps, cfg,
                need_index=not retain_sparsity,
            )
            if retain_sparsity:
                dbcsr_assert(c is not None, "retain_sparsity requires c")
                c_index = c.index
            elif c is not None and c.nblks:
                c_index, _, _ = merge_index(c.index, prod_index)
            else:
                c_index = prod_index

        eff_dist = dist
        if eff_dist is None and c is not None:
            eff_dist = c.dist
        if eff_dist is None:
            eff_dist = a.dist
        mask_result = filter_eps is not None or retain_sparsity
        if eff_dist is not None:
            from .cannon import execute_distributed

            algo = _dist_algo(cfg.mm_dist_algo, eff_dist.grid)
            with timed(f"multiply/{algo}"):
                out_data = execute_distributed(
                    a, ta, ca, b, tb, cb, c, c_index, alpha, beta, eff_dist,
                    k_dist, algo, tiled=cfg.use_tiled_cannon, mask_result=mask_result,
                )
        else:
            with timed("multiply/exec"):
                out_data = _execute_local(
                    a, ta, ca, b, tb, cb, c, c_index, alpha, beta, cfg,
                    mask_result=mask_result,
                )
        result = BCSRMatrix(
            name=(c.name if c is not None else "product"),
            index=c_index, data=out_data, sym=SYM_NONE,
            dist=(c.dist if c is not None else eff_dist),
        )
        # final norm filter (the reference's multrec_filtering)
        if filter_eps is not None and not retain_sparsity:
            from ..ops.arithmetic import filter_blocks

            result = filter_blocks(result, filter_eps)
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


def _multiply_limited(transa: str, transb: str, alpha, a: BCSRMatrix,
                      b: BCSRMatrix, beta, c: Optional[BCSRMatrix], *,
                      filter_eps, return_flops: bool, dist, limits: dict):
    """Sub-matrix multiplication window (the reference's
    ``first_row/last_row/first_column/last_column/first_k/last_k``,
    ``src/mm/dbcsr_mm.F:630-709``): the product is computed only over the
    half-open BLOCK-index ranges ``limits={"rows": (r0, r1), "cols": ...,
    "k": ...}``, while ``beta * C`` applies to the whole C.

    Extract both operands' windows (``tas/matrix.extract_block_subset``),
    multiply them, and re-expand the window product into C's block space
    with one device gather: the selections are ascending ranges, so the
    expanded index keeps the window's block order and flat layout. The
    expanded index and its gather are kept in the plan cache under the
    window product's pattern, as the extractions' are."""
    from ..block.gather import apply_prepared_gather, prepare_flat_gather
    from ..ops.arithmetic import add
    from ..ops.transform import desymmetrize
    from ..tas.matrix import extract_block_subset

    ta, _ = _effective_trans(transa)
    tb, _ = _effective_trans(transb)
    a = desymmetrize(a)
    b = desymmetrize(b)
    m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
    k_sizes = a.index.row_block_sizes if ta else a.index.col_block_sizes
    n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes

    def _range(key, n):
        lo, hi = limits.get(key, (0, n))
        dbcsr_assert(0 <= lo <= hi <= n, f"bad {key} limits ({lo},{hi})")
        return np.arange(lo, hi, dtype=np.int64)

    rows_sel = _range("rows", len(m_sizes))
    cols_sel = _range("cols", len(n_sizes))
    k_sel = _range("k", len(k_sizes))
    a_sub = (extract_block_subset(a, row_blocks=k_sel, col_blocks=rows_sel) if ta
             else extract_block_subset(a, row_blocks=rows_sel, col_blocks=k_sel))
    b_sub = (extract_block_subset(b, row_blocks=cols_sel, col_blocks=k_sel) if tb
             else extract_block_subset(b, row_blocks=k_sel, col_blocks=cols_sel))
    window, fl = multiply(
        transa, transb, alpha, a_sub, b_sub,
        filter_eps=filter_eps, dist=dist, return_flops=True,
    )
    with timed("multiply/limits_expand"):
        w_idx = window.index
        pcache = get_plan_cache()
        key = ("limits_expand", index_fingerprint(w_idx), window.tile, str(window.device),
               array_fingerprint(rows_sel, cols_sel, m_sizes, n_sizes))
        hit = pcache.get(key)
        if hit is None:
            full_index, order = build_index(
                rows_sel[w_idx.blk_rows], cols_sel[w_idx.col_idx], m_sizes, n_sizes,
            )
            dbcsr_assert(
                np.array_equal(order, np.arange(len(order))),
                "window expansion must preserve block order",
            )
            gather = prepare_flat_gather(full_index, window.tile, window,
                                         np.arange(w_idx.nelems, dtype=np.int64))
            hit = (full_index, gather)
            pcache.put(key, hit, nbytes=gather.nbytes)
        full_index, gather = hit
        expanded = BCSRMatrix(
            name="product", index=full_index, sym=SYM_NONE,
            data=apply_prepared_gather(window.data, gather), dist=dist,
        )
    if c is not None:
        result = add(1.0, expanded, beta, c)
        result = BCSRMatrix(name=c.name, index=result.index, data=result.data,
                            sym=result.sym, dist=result.dist)
    else:
        result = expanded
    if return_flops:
        return result, fl
    return result


def _symbolic_plan(a, ta, b, tb, m_sizes, n_sizes, filter_eps, cfg, *,
                   need_index: bool):
    """(symbolic product, product index) of op(A)·op(B), through the plan
    cache. Unfiltered plans are keyed by the operand patterns. A filtered
    plan depends on the data (block norms), so it is recomputed each call;
    its product index is interned by the surviving pattern's content, so
    repeated calls over a converged pattern share one index object and
    every cache derived from it (store layout, block info, masks)."""
    pcache = get_plan_cache()
    if filter_eps is None:
        key = pcache.key(a.index, ta, b.index, tb)
        cached = pcache.get(key)
        if cached is not None:
            return cached
        symb = symbolic_product(a.index, ta, b.index, tb)
        prod_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
        pcache.put(key, (symb, prod_index))
        return symb, prod_index
    from ..ops.norms import block_norms_sq

    symb = symbolic_product(
        a.index, ta, b.index, tb,
        a_norms_sq=block_norms_sq(a), b_norms_sq=block_norms_sq(b),
        filter_eps=filter_eps, per_row_eps=cfg.per_row_eps,
    )
    if not need_index:
        return symb, None
    fkey = pcache.key(
        a.index, ta, b.index, tb,
        extra=("filtered_prod", array_fingerprint(symb.rows, symb.cols)),
    )
    cached = pcache.get(fkey)
    if cached is not None:
        return symb, cached[0]
    prod_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
    pcache.put(fkey, (prod_index,))
    return symb, prod_index


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
    symbolic product, tile stack, driver choice, band/panel/group plan, the
    RCM tile renumbering when it makes the panel plan admissible (config
    ``reorder``) — and every index upload happen here; a call is the device
    work alone, and adds one multiplication, its effective flops and the
    plan's tile flops to ``get_stats()``. ``fn.plan`` is the ``LocalPlan`` (its ``route`` names the
    driver). A real and a complex operand run in the promoted complex type;
    ``fn`` converts its inputs to it."""
    from ..ops.transform import desymmetrize

    with timed("executor/build"):
        cfg = get_config()
        drv = driver or cfg.mm_driver
        _check_config(cfg, drv)
        ta, ca = _effective_trans(transa)
        tb, cb = _effective_trans(transb)
        a, b = _promote_operands(a, b)
        a = desymmetrize(a)
        b = desymmetrize(b)
        m_sizes = a.index.col_block_sizes if ta else a.index.row_block_sizes
        n_sizes = b.index.row_block_sizes if tb else b.index.col_block_sizes
        with timed("executor/symbolic"):
            symb = symbolic_product(a.index, ta, b.index, tb)
            c_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
            c_keys = store_layout(c_index, a.tile).tile_keys()
        lp = _plan_local(a, ta, b, tb, cfg, drv, may_reorder=True,
                         conj=(ca and a.dtype.is_complex, cb and b.dtype.is_complex))
        gather = tile_gather(lp.align_map(c_keys), len(lp.prod_keys), a.device)
    dtype = a.dtype
    eff_flops = symb.eff_flops

    def fn(a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        if a_data.dtype != dtype or b_data.dtype != dtype:
            a_data, b_data = a_data.to(dtype), b_data.to(dtype)
        prod = lp.run(a_data, b_data)
        with timed("executor/align"):
            out = apply_tile_gather(prod, gather)
        stats = get_stats()
        stats.num_multiplications += 1
        stats.total_flops += eff_flops
        stats.add_tile_flops(lp.hw_flops, lp.padded_flops)
        stats.add_segments(*lp.segment_counts)
        return out

    fn.plan = lp
    return fn, c_index, eff_flops


def build_distributed_executor(
    transa: str,
    transb: str,
    a: BCSRMatrix,
    b: BCSRMatrix,
    dist,
    *,
    k_dist: Optional[np.ndarray] = None,
    algo: Optional[str] = None,
    sharded: bool = False,
):
    """Plan-once distributed executor: ``(fn, c_index, eff_flops)`` with
    ``fn(a_store, b_store) -> c_store`` running the tiled Cannon (square
    grids) or SUMMA schedule over ``dist.grid``'s ranks, every host plan
    and index upload done here (the JAX package's
    ``build_distributed_executor``). Each rank's tick launches the port's
    stack kernel for the dtype; ``fn.plan`` is the ``cannon.RankPlan``
    (``launches`` per call) and ``fn.exec`` the packing around it;
    ``fn.dist_plan`` is the ``cannon.DistPlan`` the one-shot
    ``multiply(dist=)`` plans through too, ``fn.host_plan`` its host plan.

    With ``sharded=True`` the executor takes and gives the SHARDED at-rest
    form (``dist/sharded.py``): A and B as lists of per-rank ``[n_max, T,
    T]`` shards in the executor's shard layouts (``fn.shard_a``,
    ``fn.shard_b``), C as the list of its rank shards (``fn.shard_c``: a
    rank's C panel IS its shard). The ranks' pieces are gathered from
    the shards they need (the reference's ``make_images`` alltoall);
    ``fn.pieces_a`` / ``fn.pieces_b`` do that gather alone, so that a
    caller whose B stays can gather B's pieces once and call
    ``fn.plan.run`` with them.

    On a grid that spans processes (``init_lib(distributed=True)``) every
    process builds the same plan and runs its own ranks: ``fn`` returns the
    whole C store on every process, or the shards of this process's ranks
    (None for the others')."""
    from ..ops.transform import desymmetrize
    from .cannon import RankPlan, ShardGather, plan_distributed

    cfg = get_config()
    ta, ca = _effective_trans(transa)
    tb, cb = _effective_trans(transb)
    a, b = _promote_operands(a, b)
    a = desymmetrize(a)
    b = desymmetrize(b)
    tile = a.tile
    grid = dist.grid
    algo = _dist_algo(algo or cfg.mm_dist_algo, grid)
    m_sizes, _, n_sizes = _op_sizes(a, ta, b, tb)
    symb = symbolic_product(a.index, ta, b.index, tb)
    c_index, _ = build_index(symb.rows, symb.cols, m_sizes, n_sizes)
    # tile-granular whatever use_tiled_cannon says, as the JAX package's executor
    dp = plan_distributed(a, ta, b, tb, c_index, dist, k_dist, algo, tiled=True)
    plan = dp.plan
    dtype = a.dtype
    conj = (ca and dtype.is_complex, cb and dtype.is_complex)

    if sharded:
        from ..dist.sharded import shard_layout_from_bins

        p, q = grid.nprow, grid.npcol
        rowb, colb, kb = dp.rowb, dp.colb, dp.kb
        # each operand shards along its OWN stored dims: the per-tile bin
        # of a logical dim (m -> rowb, n -> colb, k -> kb) folded onto the grid
        a_rbins = (kb % p) if ta else rowb
        a_cbins = (rowb % q) if ta else (kb % q)
        b_rbins = (colb % p) if tb else (kb % p)
        b_cbins = (kb % q) if tb else (colb % q)
        sl_a = shard_layout_from_bins(a.index, tile, a_rbins, a_cbins, p, q)
        sl_b = shard_layout_from_bins(b.index, tile, b_rbins, b_cbins, p, q)
        sl_c = shard_layout_from_bins(c_index, tile, rowb, colb, p, q)
        dbcsr_assert(plan.n_c == sl_c.n_max, "C shard layout mismatch")

        def remap(pack, sl, op):
            # pack indexes the OP store: compose with the transpose order to
            # reach the at-rest slots, then their shard positions
            idx = pack.astype(np.int64)
            if op.perm is not None:
                idx = np.where(idx >= 0, op.perm[np.maximum(idx, 0)], -1)
            return np.where(idx >= 0, sl.pos_of_slot[np.maximum(idx, 0)], -1)

        rplan = RankPlan.build(algo, grid, tile, plan.n_a, plan.n_b, plan.n_c, dp.stacks,
                               dp.chunks)
        gather_a = ShardGather(remap(plan.a_pack, sl_a, dp.a_op), plan.n_a, sl_a.n_max,
                               grid, tile)
        gather_b = ShardGather(remap(plan.b_pack, sl_b, dp.b_op), plan.n_b, sl_b.n_max,
                               grid, tile)

        def op_tiles(pieces, trans, cj):
            if not trans and not cj:
                return pieces
            out = []
            for x in pieces:
                if x is not None:
                    x = x.transpose(1, 2).contiguous() if trans else x
                    x = torch.conj_physical(x) if cj else x
                out.append(x)
            return out

        def pieces_a(a_sh):
            return op_tiles(gather_a(a_sh, dtype), ta, conj[0])

        def pieces_b(b_sh):
            return op_tiles(gather_b(b_sh, dtype), tb, conj[1])

        def fn(a_sh, b_sh):
            panels = rplan.run(pieces_a(a_sh), pieces_b(b_sh), dtype)
            return [None if x is None else x.to(dtype) for x in panels]

        fn.shard_a, fn.shard_b, fn.shard_c = sl_a, sl_b, sl_c
        fn.pieces_a, fn.pieces_b = pieces_a, pieces_b
        fn.plan = rplan
    else:
        ex = dp.resident(a, b)

        def fn(a_data, b_data):
            if a_data.dtype != dtype or b_data.dtype != dtype:
                a_data, b_data = a_data.to(dtype), b_data.to(dtype)
            return ex(a_data, b_data, conj).to(dtype)

        fn.plan, fn.exec = ex.plan, ex
    fn.algo, fn.host_plan, fn.dist_plan = algo, plan, dp
    return fn, c_index, symb.eff_flops
