"""The port's kernels on the card: K1, K2, K3 (run-fused panel), K4
(grouped), K5 (band) and the float64 stack kernel against their plain
versions, the executors' routes (the filtered executor and the reordered
panel plan included), and the wrappers' refusals.

Every test needs a CUDA GPU and skips without one. This file imports no
jax (the GPU machine has none), so run it there without the suite's
conftest, which imports jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance relative to the largest reference entry: 1e-5 for K1/K2 (kernel
and plain version both accumulate in float32 — bf16 inputs are widened, so
products are exact — in different orders, over at most 40·T terms); 1e-12
for the float64 kernel (float64 sums of the same products in another
order); K3, K4 and K5 take the same bounds (K4 and K5 also run in
float64). Since its redesign the float64 kernel sums inside one ``mma`` in
the hardware's order, so it is bitwise equal only to itself (two launches).
All five float32 kernels share one blocked routine at T = 64 and 128 (one
FFMA chain per C element): K1, K2, K4 and K5 are bitwise equal on a banded
stack, K5 and K3 bitwise equal to K1 on their owned stacks (the flat stack
that lists each kernel's products in its own order). K5's band has absent
cells, which the pipelined routines' cursor steps over: first, last,
several in a row and every cell of a run (a zero tile).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch import autotune
from dbcsr_tpu_torch.block.index import build_index
from dbcsr_tpu_torch.block.store import store_layout
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.mm.f64_stack import (
    tile_stack_matmul_f64,
    tile_stack_matmul_f64_plain,
)
from dbcsr_tpu_torch.mm.band import (
    band_matmul,
    band_matmul_plain,
    band_owned_stack,
    band_run_cells,
    device_band_plan,
    plan_band,
)
from dbcsr_tpu_torch.mm.kernels import (
    device_group_plan,
    device_stack,
    stack_of_runs,
    tile_stack_matmul,
    tile_stack_matmul_grouped,
    tile_stack_matmul_grouped_plain,
    tile_stack_matmul_plain,
)
from dbcsr_tpu_torch.mm.panel import (
    device_panel_plan,
    device_panel_run_plan,
    panel_runs_owned_stack,
    plan_panel_runs,
    plan_panel_stack,
    tile_stack_matmul_panel,
    tile_stack_matmul_panel_plain,
    tile_stack_matmul_panel_runs,
    tile_stack_matmul_panel_runs_plain,
)
from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores
from torch_example_runner import load

RTOL = 1e-5
RTOL_F64 = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    # decided at run time, never at import (every xdist worker collects the
    # same tests)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dtt.init_lib()
    # the routes these tests pin are the untuned ones: the card's tuned
    # table is held off here and tested with it by the -k autotune tests
    monkeypatch.setitem(autotune._TABLE_CACHE, torch.cuda.get_device_name(0), None)
    return torch.device("cuda", 0)


def rel_err(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def random_stack(rng, n_c=9, s=60, n_tiles=12):
    c = np.sort(np.concatenate([np.arange(n_c), rng.integers(0, n_c, s - n_c)]))
    return np.stack(
        [c, rng.integers(0, n_tiles, s), rng.integers(0, n_tiles, s)], axis=1
    ).astype(np.int32), n_c


def banded_stack(mt=24, w=2):
    coords = [(r, c) for r in range(mt) for c in range(mt) if abs(r - c) <= w]
    slot = {rc: i for i, rc in enumerate(coords)}
    trip = sorted(
        (slot[(r, c)], sa, slot[(k, c)])
        for (r, k), sa in slot.items()
        for c in range(max(0, k - w, r - w), min(mt, k + w + 1, r + w + 1))
    )
    return np.asarray(trip, dtype=np.int32), len(coords)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k1_matches_plain(dev, tile, dtype):
    stack, n_c = random_stack(np.random.default_rng(tile))
    ds = device_stack(stack, n_c, dev)
    a = torch.randn(12, tile, tile, device=dev).to(dtype)
    b = torch.randn(12, tile, tile, device=dev).to(dtype)
    got = tile_stack_matmul(a, b, ds, out_dtype=torch.float32)
    ref = tile_stack_matmul_plain(a, b, ds, out_dtype=torch.float32)
    assert rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k2_matches_plain_and_k1_bitwise(dev, tile, dtype):
    stack, n = banded_stack()
    plan = plan_panel_stack(stack, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    assert plan.gstart[-1] % 16  # clamped last group
    a = torch.randn(n, tile, tile, device=dev).to(dtype)
    b = torch.randn(n, tile, tile, device=dev).to(dtype)
    got = tile_stack_matmul_panel(a, b, device_panel_plan(plan, dev),
                                  out_dtype=torch.float32)
    ref = tile_stack_matmul_panel_plain(a, b, plan, out_dtype=torch.float32)
    assert rel_err(got, ref) <= RTOL
    flat = tile_stack_matmul(a, b, device_stack(stack, n, dev), out_dtype=torch.float32)
    assert torch.equal(got, flat)


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_f64_kernel_matches_plain(dev, tile):
    """Runs of random length, runs of 1 and runs of 40 (K6 admits <= 8)."""
    rng = np.random.default_rng(tile)
    a = torch.randn(12, tile, tile, device=dev, dtype=torch.float64)
    b = torch.randn(12, tile, tile, device=dev, dtype=torch.float64)
    c_long = np.repeat(np.arange(3), 40)
    cases = [random_stack(rng), random_stack(rng, n_c=30, s=30),
             (np.stack([c_long, rng.integers(0, 12, 120), rng.integers(0, 12, 120)],
                       axis=1).astype(np.int32), 3)]
    for stack, n_c in cases:
        ds = device_stack(stack, n_c, dev)
        before = tile_stack_matmul_f64.launches
        got = tile_stack_matmul_f64(a, b, ds)
        assert tile_stack_matmul_f64.launches == before + 1
        assert got.dtype == torch.float64
        assert rel_err(got, tile_stack_matmul_f64_plain(a, b, ds)) <= RTOL_F64
        assert torch.equal(got, tile_stack_matmul_f64(a, b, ds))  # deterministic


def run_stack(rng, n_c, run, n_tiles=12):
    """Every C tile gets one run of ``run`` random (a, b) entries."""
    c = np.repeat(np.arange(n_c), run)
    return np.stack([c, rng.integers(0, n_tiles, len(c)),
                     rng.integers(0, n_tiles, len(c))], axis=1).astype(np.int32)


@pytest.mark.parametrize("run", [1, 3, 48])
@pytest.mark.parametrize("tile", [64, 128])
def test_f64_mma_kernel_runs(dev, tile, run):
    """The tensor-core routine (T = 64, 128) on runs shorter than, as long
    as and far longer than its ring of K chunks: against the plain version
    at 1e-12 (the order inside one mma is the hardware's, so not bitwise a
    DFMA chain), and two launches bitwise equal."""
    rng = np.random.default_rng(tile + run)
    a = torch.randn(12, tile, tile, device=dev, dtype=torch.float64)
    b = torch.randn(12, tile, tile, device=dev, dtype=torch.float64)
    ds = device_stack(run_stack(rng, 21, run), 21, dev)
    got = tile_stack_matmul_f64(a, b, ds)
    assert rel_err(got, tile_stack_matmul_f64_plain(a, b, ds)) <= RTOL_F64
    assert torch.equal(got, tile_stack_matmul_f64(a, b, ds))


def unmasked(ds):
    """The same stack without its K occupancy masks: every depth issued."""
    return dataclasses.replace(ds, a_chunks=None, b_chunks=None)


def f64_matrix(sizes, rows, cols, tile, seed, dev):
    """The port's float64 matrix over a block pattern, N(0, 1) data."""
    index, _ = build_index(rows.astype(np.int32), cols.astype(np.int32), sizes, sizes)
    lay = store_layout(index, tile)
    flat = np.random.default_rng(seed).standard_normal(index.nelems)
    return dtt.BCSRMatrix(name="A", index=index,
                          data=torch.from_numpy(lay.store_from_flat(flat)).to(dev))


def masked_product_check(a, b):
    """The float64 executor's stack on A·B: the masked launch is bitwise the
    unmasked one and within 1e-12 of the plain version; returns the plan."""
    fn, _, _ = dtt.build_multiply_executor("N", "N", a, b, driver="stack")
    lp = fn.plan
    assert lp.route == "f64_stack" and lp.stack.a_chunks is not None
    a_st, b_st = lp.op_stores(a.data, b.data)
    before = tile_stack_matmul_f64.launches
    got = tile_stack_matmul_f64(a_st, b_st, lp.stack)
    full = tile_stack_matmul_f64(a_st, b_st, unmasked(lp.stack))
    assert tile_stack_matmul_f64.launches == before + 2
    assert torch.equal(got, full)
    plain = tile_stack_matmul_f64_plain(a_st, b_st, lp.stack)
    assert rel_err(got, plain) <= RTOL_F64
    assert torch.equal(got, tile_stack_matmul_f64(a_st, b_st, lp.stack))  # deterministic
    return lp


@pytest.mark.parametrize("tile", [64, 128])
def test_f64_masked_kernel_on_water(dev, tile):
    """The benchmark's water pattern at 2 × 2 × 2 cells (the fewest its 8 Å
    cutoff admits), read through ``benchmark.operands.pattern_of`` alone:
    most entries leave some depth empty."""
    from benchmark.operands import pattern_of

    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        cfg = json.load(f)
    cfg["replicas"] = [2, 2, 2]
    blocks = pattern_of(cfg).blocks
    sizes = blocks.row_sizes.astype(np.int32)
    a = f64_matrix(sizes, blocks.rows, blocks.cols, tile, 1, dev)
    b = f64_matrix(sizes, blocks.rows, blocks.cols, tile, 2, dev)
    lp = masked_product_check(a, b)
    assert lp.hw_flops < lp.padded_flops


@pytest.mark.parametrize("tile", [64, 128])
def test_f64_masked_kernel_full_tiles(dev, tile):
    """A banded pattern of whole-tile blocks: every mask is full, and the
    plan issues the tile figure, as before the masks."""
    sizes = np.full(24, tile, np.int32)
    i, j = np.nonzero(np.abs(np.subtract.outer(np.arange(24), np.arange(24))) <= 2)
    a = f64_matrix(sizes, i, j, tile, 3, dev)
    lp = masked_product_check(a, a)
    full = (1 << (tile // 8)) - 1
    assert bool((lp.stack.a_chunks == full).all()) and bool((lp.stack.b_chunks == full).all())
    assert lp.hw_flops == lp.padded_flops == 2.0 * len(lp.tile_plan.stack) * tile**3


@pytest.mark.parametrize("tile", [64, 128])
def test_f64_masked_kernel_cursor(dev, tile):
    """Random masks over a random stack, the stores zeroed where the masks
    are clear (the store invariant): entries with no common depth or one,
    a run of such entries only (a zero tile), runs longer than the staged
    window of 64 pairs. The masked launch equals the unmasked one bitwise."""
    rng = np.random.default_rng(tile + 7)
    n_tiles, depths = 16, tile // 8
    a_m = rng.integers(0, 1 << depths, n_tiles).astype(np.int32)
    b_m = rng.integers(0, 1 << depths, n_tiles).astype(np.int32)
    a_m[:3] = [0, 1, 1 << (depths - 1)]
    b_m[:3] = [(1 << depths) - 1, 1, 1 << (depths - 2)]
    c = np.repeat(np.arange(6), [1, 3, 150, 70, 2, 40])
    ia, ib = rng.integers(0, n_tiles, len(c)), rng.integers(0, n_tiles, len(c))
    ia[c == 4], ib[c == 4] = 2, 2  # no common depth in the whole run
    ia[0], ib[0] = 0, 0            # a run of one entry with no common depth
    stack = np.stack([c, ia, ib], axis=1).astype(np.int32)

    def keep(m):
        return torch.from_numpy(((m[:, None] >> np.arange(depths)) & 1).repeat(8, axis=1) > 0)

    a = torch.randn(n_tiles, tile, tile, dtype=torch.float64)
    b = torch.randn(n_tiles, tile, tile, dtype=torch.float64)
    a = a.masked_fill(~keep(a_m)[:, None, :], 0).to(dev)
    b = b.masked_fill(~keep(b_m)[:, :, None], 0).to(dev)
    ds = device_stack(stack, 6, dev, (a_m, b_m))
    got = tile_stack_matmul_f64(a, b, ds)
    assert torch.equal(got, tile_stack_matmul_f64(a, b, unmasked(ds)))
    assert rel_err(got, tile_stack_matmul_f64_plain(a, b, ds)) <= RTOL_F64
    assert not bool(got[0].any()) and not bool(got[4].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("run", [1, 3, 48])
@pytest.mark.parametrize("tile", [64, 128])
def test_k2_blocked_matches_plain_and_k1_bitwise(dev, tile, run, dtype):
    """The blocked routine (T = 64, 128) under a plan whose last group is
    clamped: against its plain version, bitwise against K1 on the same stack
    (one FFMA chain per C element, whatever the blocking) and bitwise
    against a second launch."""
    rng = np.random.default_rng(tile + run)
    n_c = 21  # windows of 16: the last group is clamped to slot 5
    stack = run_stack(rng, n_c, run)
    plan = plan_panel_stack(stack, n_c, 12, 12, c_win=16, a_cap=12, b_cap=12, chunk=1)
    assert plan.gstart[-1] % 16
    a = torch.randn(12, tile, tile, device=dev).to(dtype)
    b = torch.randn(12, tile, tile, device=dev).to(dtype)
    dp = device_panel_plan(plan, dev)
    got = tile_stack_matmul_panel(a, b, dp, out_dtype=torch.float32)
    ref = tile_stack_matmul_panel_plain(a, b, plan, out_dtype=torch.float32)
    assert rel_err(got, ref) <= 1e-4  # 48·128 float32 terms in another order
    assert torch.equal(got, tile_stack_matmul(a, b, device_stack(stack, n_c, dev),
                                              out_dtype=torch.float32))
    assert torch.equal(got, tile_stack_matmul_panel(a, b, dp, out_dtype=torch.float32))


DTYPES3 = [torch.float32, torch.bfloat16, torch.float64]


def stores(n_a, n_b, tile, dtype, dev):
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    return (torch.randn(n_a, tile, tile, device=dev, dtype=wide).to(dtype),
            torch.randn(n_b, tile, tile, device=dev, dtype=wide).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("run", [1, 3, 48])
@pytest.mark.parametrize("tile", [64, 128])
def test_k1_blocked_matches_plain_and_itself(dev, tile, run, dtype):
    """K1 through the blocked routine (T = 64, 128), one block per C tile:
    against its plain version, with three C tiles left empty (they must come
    out zero), and two launches bitwise equal."""
    rng = np.random.default_rng(tile + run)
    stack = run_stack(rng, 21, run)
    stack = stack[~np.isin(stack[:, 0], (0, 7, 20))]
    ds = device_stack(stack, 21, dev)
    a = torch.randn(12, tile, tile, device=dev).to(dtype)
    b = torch.randn(12, tile, tile, device=dev).to(dtype)
    before = tile_stack_matmul.launches
    got = tile_stack_matmul(a, b, ds, out_dtype=torch.float32)
    assert tile_stack_matmul.launches == before + 1
    assert rel_err(got, tile_stack_matmul_plain(a, b, ds, out_dtype=torch.float32)) <= 1e-4
    assert not got[[0, 7, 20]].any()
    assert torch.equal(got, tile_stack_matmul(a, b, ds, out_dtype=torch.float32))


def square_band_plans(tile, mt=24, w=2):
    """A full square band of tiles times itself: the tile plan (its c-sorted
    stack) and the band plan over the same C tiles."""
    r, c = np.meshgrid(np.arange(mt), np.arange(mt), indexing="ij")
    coords = np.stack([r[abs(r - c) <= w], c[abs(r - c) <= w]], 1).astype(np.int64)
    tp = plan_tile_stacks_stores(coords, (mt, mt), coords, (mt, mt))
    bp = plan_band(coords, (mt, mt), coords, (mt, mt), tp.c_tile_keys, tile=tile)
    return coords, tp, bp


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("tile", [64, 128])
def test_k1_and_k4_equal_k5_bitwise_on_a_banded_stack(dev, tile, dtype):
    """One routine per type under all three (blocked FFMA, one chain per C
    element; in float64 the FP64 mma routine, with the float64 stack kernel
    in K1's place) and, on a full band, one run order (the diagonal walk is
    the stack's order): they agree bit for bit on a stack all three take."""
    coords, tp, bp = square_band_plans(tile)
    a, b = stores(len(coords), len(coords), tile, dtype, dev)
    out_dt = torch.float64 if dtype == torch.float64 else torch.float32
    k5 = band_matmul(a, b, device_band_plan(bp, dev), out_dtype=out_dt)
    ds = device_stack(tp.stack, tp.n_c_tiles, dev)
    k1 = tile_stack_matmul_f64(a, b, ds) if dtype == torch.float64 else tile_stack_matmul(
        a, b, ds, out_dtype=out_dt)
    gp = device_group_plan(tp.stack, tp.n_c_tiles, len(coords), dev)
    assert gp.join is None  # the kernel writes the C store
    k4 = tile_stack_matmul_grouped(a, b, gp, out_dtype=out_dt)
    assert torch.equal(k1, k5) and torch.equal(k4, k5)


def band_with_absent_cells(tile, mt=24):
    """A square band (A diagonals -2..2, B -1..2) with every third tile of
    the extreme diagonals dropped and 40% of the inner ones, planned over
    EVERY band position of C: runs lose their first cell, their last, several
    in a row, and some positions keep no cell at all."""
    rng = np.random.default_rng(5)

    def coords(lo, hi):
        r, c = np.meshgrid(np.arange(mt), np.arange(mt), indexing="ij")
        d = c - r
        edge = (d == lo) | (d == hi)
        keep = (d >= lo) & (d <= hi) & np.where(edge, r % 3 != 1, rng.random(d.shape) < 0.6)
        return np.stack([r[keep], c[keep]], 1).astype(np.int64)

    ac, bc = coords(-2, 2), coords(-1, 2)
    r, c = np.meshgrid(np.arange(mt), np.arange(mt), indexing="ij")
    keys = np.sort((r * mt + c)[(c - r >= -3) & (c - r <= 4)]).astype(np.int64)
    return ac, bc, plan_band(ac, (mt, mt), bc, (mt, mt), keys, tile=tile)


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k5_skips_absent_cells_and_equals_the_flat_kernel_bitwise(dev, tile, dtype):
    """The cursor's skip of a pair with a negative slot, in tile_run (T = 16,
    32), the blocked routine and the FP64 mma routine (T = 64, 128): absent
    first, last, several in a row, and a run with no present cell (a zero
    tile, written once). K5 against its plain version, and bitwise against
    the flat kernel of its type on ``band_owned_stack`` (K1; in float64 the
    float64 stack kernel: one routine, one run order, the same bits)."""
    ac, bc, plan = band_with_absent_cells(tile)
    run, a_cell, b_cell = band_run_cells(plan)
    absent = run & ((a_cell < 0) | (b_cell < 0))
    present = run & ~absent
    some = present.any(axis=1)
    first = np.array([absent[i, run[i]][0] for i in range(len(run))])
    last = np.array([absent[i, run[i]][-1] for i in range(len(run))])
    in_a_row = (absent[:, 1:] & absent[:, :-1]).any(axis=1)
    assert (some & first).any() and (some & last).any() and (some & in_a_row).any()
    empty = np.flatnonzero(~some)
    assert len(empty) >= 3
    a, b = stores(len(ac), len(bc), tile, dtype, dev)
    f64 = dtype == torch.float64
    out_dt = torch.float64 if f64 else torch.float32
    dp = device_band_plan(plan, dev)
    poison = torch.full((len(run), tile, tile), float("nan"), device=dev, dtype=out_dt)
    del poison  # torch.empty may hand the kernel this memory
    got = band_matmul(a, b, dp, out_dtype=out_dt)
    assert bool(torch.isfinite(got).all()) and not got[empty].any()
    ref = band_matmul_plain(a, b, plan, out_dtype=out_dt)
    assert rel_err(got, ref) <= (RTOL_F64 if f64 else RTOL)
    ds = device_stack(stack_of_runs(*band_owned_stack(plan)), len(run), dev)
    flat = tile_stack_matmul_f64(a, b, ds) if f64 else tile_stack_matmul(
        a, b, ds, out_dtype=torch.float32)
    assert torch.equal(got, flat)
    assert torch.equal(got, band_matmul(a, b, dp, out_dtype=out_dt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("runlen", [2, 3, 4])
@pytest.mark.parametrize("tile", [16, 64, 128])
def test_k3_equals_k1_on_its_owned_stack_bitwise(dev, tile, runlen, dtype):
    """K3's order is its own (entries re-sorted by A slot, three tiers), and
    ``panel_runs_owned_stack`` lists it: K1 on that flat stack takes the same
    FFMA chain. With and without the column-major permutation, the clamped
    last group."""
    stack, n = banded_stack()
    coords = np.asarray([(r, c) for r in range(24) for c in range(24) if abs(r - c) <= 2])
    cm = np.argsort(coords[:, 1] * 24 + coords[:, 0]).astype(np.int32)
    a, b = stores(n, n, tile, dtype, dev)
    for perm in (cm, None):
        plan = plan_panel_runs(stack, n, n, n, b_cm_perm=perm, c_win=16, a_cap=64,
                               b_cap=64, chunk=4, runlen=runlen)
        assert plan.gstart[-1] % 16  # clamped last group
        if perm is not None:
            assert plan.n_quads > 0 and plan.n_singles > 0
            assert (plan.n_pairs > 0) == (runlen > 2)
        dp = device_panel_run_plan(plan, dev)
        got = tile_stack_matmul_panel_runs(a, b, dp, out_dtype=torch.float32)
        ref = tile_stack_matmul_panel_runs_plain(a, b, plan, out_dtype=torch.float32)
        assert rel_err(got, ref) <= RTOL
        ds = device_stack(stack_of_runs(*panel_runs_owned_stack(plan)), n, dev)
        assert torch.equal(got, tile_stack_matmul(a, b, ds, out_dtype=torch.float32))
        assert torch.equal(got, tile_stack_matmul_panel_runs(a, b, dp, out_dtype=torch.float32))


@pytest.mark.parametrize("run", [64, 65, 150])
@pytest.mark.parametrize("tile", [32, 128])
def test_k3_cells_longer_than_the_staged_window(dev, tile, run):
    """A cell of 64 products fills the kernel's window of expanded pairs
    exactly; 65 and 150 refill it once and twice while the ring runs."""
    rng = np.random.default_rng(run)
    n_c = 21  # windows of 16: the last group is clamped
    stack = run_stack(rng, n_c, run)
    plan = plan_panel_runs(stack, n_c, 12, 12, c_win=16, a_cap=12, b_cap=12,
                           chunk=1, runlen=4)
    assert plan is not None and plan.gstart[-1] % 16
    a, b = stores(12, 12, tile, torch.float32, dev)
    dp = device_panel_run_plan(plan, dev)
    got = tile_stack_matmul_panel_runs(a, b, dp, out_dtype=torch.float32)
    ref = tile_stack_matmul_panel_runs_plain(a, b, plan, out_dtype=torch.float32)
    assert rel_err(got, ref) <= 1e-4  # 150·128 float32 terms in another order
    ds = device_stack(stack_of_runs(*panel_runs_owned_stack(plan)), n_c, dev)
    assert torch.equal(got, tile_stack_matmul(a, b, ds, out_dtype=torch.float32))


def grouped_on_nan_memory(a, b, plan, out_dt):
    """K4 on a store that ``torch.empty`` takes from memory just filled with
    NaN and freed (the caching allocator hands the block back); returns the
    result and whether it landed there."""
    n_out = plan.n_c if plan.join is None else plan.n_groups * plan.group
    poison = torch.full((n_out,) + tuple(a.shape[1:]), float("nan"),
                        device=a.device, dtype=out_dt)
    ptr = poison.data_ptr()
    del poison
    got = tile_stack_matmul_grouped(a, b, plan, out_dtype=out_dt)
    return got, got.data_ptr() == ptr


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k4_direct_write_leaves_no_nan(dev, tile, dtype):
    """No C run is split, so the kernel writes the C store: padding rows
    write nothing and the C slots that no row produces (3 and 8) come out
    zero, in a store on NaN-filled memory; two launches bitwise equal."""
    stack, n_c = random_stack(np.random.default_rng(tile), n_c=11, s=120, n_tiles=20)
    stack = stack[~np.isin(stack[:, 0], (3, 8))]
    a, b = stores(20, 20, tile, dtype, dev)
    out_dt = torch.float64 if dtype == torch.float64 else torch.float32
    plan = device_group_plan(stack, n_c, 20, dev, group=4, cache=128)
    assert plan.join is None and plan.zero_slots.tolist() == [3, 8]
    assert (plan.out_slot < 0).any()  # padding rows
    landed = False
    for _ in range(3):
        got, on_nan = grouped_on_nan_memory(a, b, plan, out_dt)
        landed |= on_nan
        assert bool(torch.isfinite(got).all()) and not got[[3, 8]].any()
        ref = tile_stack_matmul_grouped_plain(a, b, plan, out_dtype=out_dt)
        assert rel_err(got, ref) <= (RTOL_F64 if dtype == torch.float64 else RTOL)
        assert torch.equal(got, tile_stack_matmul_grouped(a, b, plan, out_dtype=out_dt))
    assert landed, "the store never landed on the NaN-filled block"


@pytest.mark.parametrize("knobs", [(8, 128), (2, 4)])
@pytest.mark.parametrize("tile", [64, 128])
def test_k4_f64_matches_the_f64_stack_kernel(dev, tile, knobs):
    """K4's double instantiation runs on the FP64 tensor cores, as the
    float64 stack kernel: 1e-12 on the same stack, whether the kernel writes
    the C store (no run split) or the ordered segment sum joins split runs."""
    stack, n_c = random_stack(np.random.default_rng(tile), n_c=11, s=120, n_tiles=20)
    a, b = stores(20, 20, tile, torch.float64, dev)
    plan = device_group_plan(stack, n_c, 20, dev, group=knobs[0], cache=knobs[1])
    assert (plan.split_runs > 0) == (knobs == (2, 4))
    got = tile_stack_matmul_grouped(a, b, plan)
    ref = tile_stack_matmul_f64(a, b, device_stack(stack, n_c, dev))
    assert got.dtype == torch.float64 and rel_err(got, ref) <= RTOL_F64
    if not plan.split_runs:  # one routine, one run order: the same bits
        assert torch.equal(got, ref)
    assert torch.equal(got, tile_stack_matmul_grouped(a, b, plan))


def test_wrappers_reject_misaligned_stores(dev):
    """A contiguous view that starts 8 bytes into its tensor: the kernels
    copy 16 bytes at a time, so every wrapper refuses it."""
    stack, n_c = random_stack(np.random.default_rng(0))
    ds = device_stack(stack, n_c, dev)
    flat = torch.randn(12 * 32 * 32 + 4, device=dev, dtype=torch.float64)
    bad = flat[1: 1 + 12 * 32 * 32].view(12, 32, 32)
    good = flat[: 12 * 32 * 32].view(12, 32, 32)
    with pytest.raises(ValueError, match="16-byte"):
        tile_stack_matmul_f64(bad, good, ds)
    bad32 = flat.float()[2: 2 + 12 * 32 * 32].view(12, 32, 32)
    with pytest.raises(ValueError, match="16-byte"):
        tile_stack_matmul(bad32, bad32, ds)
    stack2, n = banded_stack()
    plan = plan_panel_stack(stack2, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    flat32 = torch.randn(n * 32 * 32 + 4, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        tile_stack_matmul_panel(flat32[1: 1 + n * 32 * 32].view(n, 32, 32),
                                flat32[: n * 32 * 32].view(n, 32, 32),
                                device_panel_plan(plan, dev))


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k5_matches_plain(dev, tile, dtype):
    """A rectangular grid with negative off_a (k runs off both ends) and a
    band with holes."""
    rng = np.random.default_rng(tile)
    mt, kt, nt = 12, 20, 15
    r, c = np.meshgrid(np.arange(mt), np.arange(kt), indexing="ij")
    keep = (c - r >= -3) & (c - r <= 5) & ((c - r == -3) | (c - r == 5) | (rng.random(r.shape) < 0.7))
    ac = np.stack([r[keep], c[keep]], 1).astype(np.int64)
    r, c = np.meshgrid(np.arange(kt), np.arange(nt), indexing="ij")
    keep = (c - r >= -6) & (c - r <= 2) & ((c - r == -6) | (c - r == 2) | (rng.random(r.shape) < 0.7))
    bc = np.stack([r[keep], c[keep]], 1).astype(np.int64)
    tp = plan_tile_stacks_stores(ac, (mt, kt), bc, (kt, nt))
    plan = plan_band(ac, (mt, kt), bc, (kt, nt), tp.c_tile_keys, tile=tile)
    assert plan.off_a < 0
    a, b = stores(len(ac), len(bc), tile, dtype, dev)
    out_dt = torch.float64 if dtype == torch.float64 else torch.float32
    before = band_matmul.launches
    got = band_matmul(a, b, device_band_plan(plan, dev), out_dtype=out_dt)
    assert band_matmul.launches == before + 1 and got.dtype == out_dt
    ref = band_matmul_plain(a, b, plan, out_dtype=out_dt)
    assert rel_err(got, ref) <= (RTOL_F64 if dtype == torch.float64 else RTOL)
    assert torch.equal(got, band_matmul(a, b, plan, out_dtype=out_dt))  # host plan, deterministic


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k4_matches_plain(dev, tile, dtype):
    """Small caches split C runs (the ordered join); padding rows are zero."""
    stack, n_c = random_stack(np.random.default_rng(tile), n_c=11, s=120, n_tiles=20)
    a, b = stores(20, 20, tile, dtype, dev)
    out_dt = torch.float64 if dtype == torch.float64 else torch.float32
    for group, cache in ((4, 16), (8, 8), (2, 4), (8, 128)):
        plan = device_group_plan(stack, n_c, 20, dev, group=group, cache=cache)
        before = tile_stack_matmul_grouped.launches
        got = tile_stack_matmul_grouped(a, b, plan, out_dtype=out_dt)
        assert tile_stack_matmul_grouped.launches == before + 1
        assert got.shape == (n_c, tile, tile) and got.dtype == out_dt
        ref = tile_stack_matmul_grouped_plain(a, b, plan, out_dtype=out_dt)
        assert rel_err(got, ref) <= (RTOL_F64 if dtype == torch.float64 else RTOL)
        assert torch.equal(got, tile_stack_matmul_grouped(a, b, plan, out_dtype=out_dt))
    assert plan.split_runs == 0 and device_group_plan(
        stack, n_c, 20, dev, group=2, cache=4).split_runs > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k3_matches_plain(dev, tile, dtype):
    """runlen 2 (no pair tier) and 4 (all three tiers), the clamped last
    group, B read through the column-major permutation and without one."""
    stack, n = banded_stack()
    coords = np.asarray([(r, c) for r in range(24) for c in range(24) if abs(r - c) <= 2])
    cm = np.argsort(coords[:, 1] * 24 + coords[:, 0]).astype(np.int32)
    a, b = stores(n, n, tile, dtype, dev)
    flat = tile_stack_matmul(a, b, device_stack(stack, n, dev), out_dtype=torch.float32)
    for runlen, perm in ((2, cm), (4, cm), (4, None)):
        plan = plan_panel_runs(stack, n, n, n, b_cm_perm=perm, c_win=16, a_cap=64,
                               b_cap=64, chunk=4, runlen=runlen)
        assert plan.gstart[-1] % 16  # clamped last group
        if perm is not None:
            assert plan.n_quads > 0 and (plan.n_pairs > 0) == (runlen == 4)
        dp = device_panel_run_plan(plan, dev)
        before = tile_stack_matmul_panel_runs.launches
        got = tile_stack_matmul_panel_runs(a, b, dp, out_dtype=torch.float32)
        assert tile_stack_matmul_panel_runs.launches == before + 1
        ref = tile_stack_matmul_panel_runs_plain(a, b, plan, out_dtype=torch.float32)
        assert rel_err(got, ref) <= RTOL and rel_err(got, flat) <= RTOL
        assert torch.equal(got, tile_stack_matmul_panel_runs(a, b, dp, out_dtype=torch.float32))


def test_new_drivers_and_reordering_on_the_card(dev):
    """band, grouped and panel_runlen executors launch their own kernels and
    match the flat route; a scrambled band takes the reordered panel route
    under reorder="auto" and the flat kernel under "off"."""
    rng = np.random.default_rng(2)
    rbs = dtt.random_block_sizes(300, [3, 5, 7], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n), 7)
    j = i + np.tile(np.arange(-3, 4), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.6)
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
              for r, c in zip(i[keep], j[keep])]
    with config_override(tile_size=16, matmul_precision="highest"):
        a = dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs, device=dev)
        f0, _, _ = dtt.build_multiply_executor("N", "T", a, a, driver="stack")
        ref = f0(a.data, a.data)
        for driver, cfg, route, counter in (
                ("band", {}, "band", band_matmul),
                ("grouped", {}, "grouped", tile_stack_matmul_grouped),
                ("panel", {"panel_runlen": 4}, "panel_runs", tile_stack_matmul_panel_runs)):
            with config_override(**cfg):
                fn, _, _ = dtt.build_multiply_executor("N", "T", a, a, driver=driver)
            assert fn.plan.route == route
            before = counter.launches
            out = fn(a.data, a.data)
            assert counter.launches == before + 1
            assert rel_err(out, ref) <= RTOL
        for driver in ("band", "grouped"):  # float64: the driver's own kernel
            a64 = a.astype(torch.float64)
            fn, _, _ = dtt.build_multiply_executor("N", "N", a64, a64, driver=driver)
            f64, _, _ = dtt.build_multiply_executor("N", "N", a64, a64, driver="stack")
            assert fn.plan.route == driver and f64.plan.route == "f64_stack"
            assert rel_err(fn(a64.data, a64.data), f64(a64.data, a64.data)) <= RTOL_F64
    nb, w, t = 96, 3, 16
    i = np.repeat(np.arange(nb, dtype=np.int64), 2 * w + 1)
    j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), nb)
    keep = (j >= 0) & (j < nb)
    i, j = i[keep], j[keep]
    sm, sk, sn = (rng.permutation(nb).astype(np.int64) for _ in range(3))
    sizes = np.full(nb, t, np.int32)
    with config_override(tile_size=t, panel_cache=64):
        mats = [dtt.BCSRMatrix.from_blocks(
            sr[i], sc[j], [rng.standard_normal((t, t)).astype(np.float32) for _ in i],
            sizes, sizes, device=dev) for sr, sc in ((sm, sk), (sk, sn))]
        outs = {}
        for mode, route, counter in (("off", "stack", tile_stack_matmul),
                                     ("auto", "panel", tile_stack_matmul_panel)):
            with config_override(reorder=mode):
                fn, _, _ = dtt.build_multiply_executor("N", "N", *mats)
            assert fn.plan.route == route and (fn.plan.reorder is not None) == (mode == "auto")
            before = counter.launches
            outs[mode] = fn(mats[0].data, mats[1].data)
            assert counter.launches == before + 1
        assert rel_err(outs["auto"], outs["off"]) <= RTOL


def test_wrappers_reject_bad_input(dev):
    stack, n_c = random_stack(np.random.default_rng(0))
    ds = device_stack(stack, n_c, dev)
    a = torch.randn(12, 32, 32, device=dev)
    with pytest.raises(TypeError, match="float64"):
        tile_stack_matmul(a.double(), a.double(), ds)
    with pytest.raises(TypeError):
        tile_stack_matmul_f64(a, a, ds)
    a8 = torch.randn(12, 8, 8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        tile_stack_matmul_f64(a8, a8, ds)
    with pytest.raises(IndexError):
        tile_stack_matmul_f64(a.double()[:2], a.double()[:2], ds)
    with pytest.raises(TypeError):
        tile_stack_matmul(a.half(), a.half(), ds)
    a8 = torch.randn(12, 8, 8, device=dev)
    with pytest.raises(ValueError):
        tile_stack_matmul(a8, a8, ds)
    with pytest.raises(ValueError):
        tile_stack_matmul(a.transpose(1, 2), a, ds)  # not contiguous
    with pytest.raises(IndexError):
        tile_stack_matmul(a[:2], a[:2], ds)  # stack slots beyond the stores
    stack2, n = banded_stack()
    plan = plan_panel_stack(stack2, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    with pytest.raises(TypeError, match="float64"):
        tile_stack_matmul_panel(a.double(), a.double(), device_panel_plan(plan, dev))
    rplan = plan_panel_runs(stack2, n, n, n, c_win=16, a_cap=64, b_cap=64, chunk=4, runlen=2)
    with pytest.raises(TypeError, match="float64"):  # K3 takes f32/bf16, as K2
        tile_stack_matmul_panel_runs(a.double(), a.double(), device_panel_run_plan(rplan, dev))
    with pytest.raises(IndexError):
        tile_stack_matmul_panel_runs(a[:2], a[:2], device_panel_run_plan(rplan, dev))
    gplan = device_group_plan(stack, n_c, 12, dev)
    with pytest.raises(TypeError):
        tile_stack_matmul_grouped(a.half(), a.half(), gplan)
    with pytest.raises(IndexError):
        tile_stack_matmul_grouped(a[:2], a[:2], gplan)
    with pytest.raises(ValueError):
        tile_stack_matmul_grouped(a8, a8, gplan)


def test_executors_on_the_card(dev):
    """auto takes K2 on a banded pattern, stack takes K1; both match the
    same multiply on CPU tensors; float64 takes the float64 kernel under
    every sparse driver, and the filtered executor matches its CPU run."""
    rng = np.random.default_rng(1)
    rbs = dtt.random_block_sizes(300, [3, 5, 7], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n), 7)
    j = i + np.tile(np.arange(-3, 4), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.6)
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
              for r, c in zip(i[keep], j[keep])]
    with config_override(tile_size=16, matmul_precision="highest"):
        a = dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs, device="cpu")
        ag = a.with_data(a.data.to(dev))
        ref = dtt.multiply("N", "N", 1.0, a, a).to_dense()
        for driver, counter in (("auto", tile_stack_matmul_panel),
                                ("stack", tile_stack_matmul)):
            with config_override(mm_driver=driver):
                fn, _, _ = dtt.build_multiply_executor("N", "N", ag, ag)
                assert fn.plan.route == {"auto": "panel", "stack": "stack"}[driver]
                before = counter.launches
                out = dtt.multiply("N", "N", 1.0, ag, ag)
                assert counter.launches == before + 1
            assert rel_err(out.to_dense(), ref) <= RTOL
        a64, g64 = a.astype(torch.float64), ag.astype(torch.float64)
        ref64 = dtt.multiply("N", "N", 1.0, a64, a64, filter_eps=1e-3)
        for driver in ("auto", "stack", "panel"):
            with config_override(mm_driver=driver):
                before = tile_stack_matmul_f64.launches
                out = dtt.multiply("N", "N", 1.0, g64, g64, filter_eps=1e-3)
                assert tile_stack_matmul_f64.launches == before + 1
            np.testing.assert_array_equal(out.index.col_idx, ref64.index.col_idx)
            assert rel_err(out.to_dense(), ref64.to_dense()) <= RTOL_F64
        ex_cpu = dtt.build_filtered_executor("N", "N", a64, a64, 1e-3)
        ex_gpu = dtt.build_filtered_executor("N", "N", g64, g64, 1e-3)
        c_cpu, k_cpu, _ = ex_cpu.step(a64.data, a64.data)
        c_gpu, k_gpu, _ = ex_gpu.step(g64.data, g64.data)
        assert torch.equal(k_gpu.cpu(), k_cpu)
        assert rel_err(c_gpu, c_cpu) <= RTOL_F64


# ---- the tensor contraction (TAS, tensors) on the card ------------------------

def _ri_on(dev, n_atoms, dtype):
    """chip_smoke.py's shape R, made on the CPU and copied to ``dev``: the
    same data on both sides."""
    import os
    import sys
    from dataclasses import replace

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cpu = chip_smoke.ri_tensors(n_atoms, torch.device("cpu"), dtype)
    gpu = [replace(t, matrix=t.matrix.with_data(t.matrix.data.to(dev))) for t in cpu]
    return cpu, gpu


RI_LEGS = {
    # C(μ,ν,Q) = Σ_P A(μ,ν,P) B(P,Q): the folded rows are long
    "m": lambda a, b: dict(a=a, b=b, contract_1=(2,), notcontract_1=(0, 1),
                           contract_2=(0,), notcontract_2=(1,)),
    # C(Q,μ,ν) = Σ_P B(P,Q) A(μ,ν,P): the folded columns are long
    "n": lambda a, b: dict(a=b, b=a, contract_1=(0,), notcontract_1=(1,),
                           contract_2=(2,), notcontract_2=(0, 1)),
    # C(P,Q) = Σ_{μν} A(μ,ν,P) A(μ,ν,Q): the contracted dimension is long
    "k": lambda a, b: dict(a=a, b=a, contract_1=(0, 1), notcontract_1=(2,),
                           contract_2=(0, 1), notcontract_2=(2,)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("long_dim", ["m", "n", "k"])
def test_contract_on_the_card_matches_cpu(dev, long_dim, dtype):
    """Each TAS branch (m-, n- and k-long, three groups) on the card
    against the same call on CPU tensors (plain versions)."""
    from dbcsr_tpu_torch.tas import split_factor_estimate
    from dbcsr_tpu_torch.tensors import contract

    (ac, bc), (ag, bg) = _ri_on(dev, 24, dtype)
    kc, kg = RI_LEGS[long_dim](ac, bc), RI_LEGS[long_dim](ag, bg)
    ma = kg["a"].with_layout(dtt.NDMapping(kg["a"].ndim, kg["notcontract_1"],
                                           kg["contract_1"])).matrix
    mb = kg["b"].with_layout(dtt.NDMapping(kg["b"].ndim, kg["contract_2"],
                                           kg["notcontract_2"])).matrix
    dims = (ma.shape[0], ma.shape[1], mb.shape[1])
    assert split_factor_estimate(*dims)[0] == long_dim
    with config_override(matmul_precision="highest"):
        out_c, fl_c = contract(1.0, kc.pop("a"), kc.pop("b"), nsplit=3,
                               return_flops=True, **kc)
        out_g, fl_g = contract(1.0, kg.pop("a"), kg.pop("b"), nsplit=3,
                               return_flops=True, **kg)
    assert fl_g == fl_c and out_g.matrix.data.is_cuda
    np.testing.assert_array_equal(out_g.matrix.index.col_idx, out_c.matrix.index.col_idx)
    np.testing.assert_array_equal(out_g.matrix.index.row_ptr, out_c.matrix.index.row_ptr)
    assert rel_err(out_g.matrix.data, out_c.matrix.data) <= (
        RTOL_F64 if dtype == torch.float64 else RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refold_and_merge_on_the_card_are_bitwise_cpu(dev, dtype):
    from dbcsr_tpu_torch.tas import TASSplit, extract_block_subset, merge_row_groups

    (ac, _), (ag, _) = _ri_on(dev, 24, dtype)
    target = dtt.NDMapping(3, (2,), (0, 1))
    rc, rg = ac.with_layout(target), ag.with_layout(target)
    assert rg.matrix.data.is_cuda
    assert torch.equal(rg.matrix.data.cpu(), rc.matrix.data)
    assert torch.equal(ag.with_layout(target).matrix.data, rg.matrix.data)  # the cached map
    split = TASSplit.cyclic("R", ac.matrix.nblkrows, 4)
    merged = []
    for m in (ac.matrix, ag.matrix):
        parts = [(extract_block_subset(m, row_blocks=split.blocks_of_group(g)),
                  split.blocks_of_group(g)) for g in range(4)]
        merged.append(merge_row_groups(parts, m.row_block_sizes, m.col_block_sizes))
    assert torch.equal(merged[1].data.cpu(), merged[0].data)
    assert torch.equal(merged[0].data, ac.matrix.data)  # the groups tile A


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ri_24_atoms_runs_its_kernel(dev, dtype):
    """Shape R at 24 atoms, T = 128: A 506 tiles, S = 1,304 tile products
    into 936 planned C tiles, the panel route (K2) in float32 and the
    float64 stack kernel in float64; ``BatchedContract`` bitwise equal to
    ``contract(nsplit=1)``, each launching the kernel once."""
    from dbcsr_tpu_torch.tensors import BatchedContract, contract

    _, (ag, bg) = _ri_on(dev, 24, dtype)
    counter, route = ((tile_stack_matmul_panel, "panel") if dtype == torch.float32
                      else (tile_stack_matmul_f64, "f64_stack"))
    kw = dict(contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,), notcontract_2=(1,))
    with config_override(matmul_precision="highest"):
        with BatchedContract() as batch:
            before = counter.launches
            out = batch.contract(ag, bg, **kw)
            assert counter.launches == before + 1
            (fn, _, _), = batch._tas._cache.values()
            assert fn.plan.route == route
            tp = fn.plan.tile_plan
            assert (ag.matrix.data.shape[0], len(tp.stack), tp.n_c_tiles) == (506, 1304, 936)
        before = counter.launches
        once = contract(1.0, ag, bg, nsplit=1, **kw)
        assert counter.launches == before + 1
    np.testing.assert_array_equal(out.matrix.index.col_idx, once.matrix.index.col_idx)
    assert torch.equal(out.matrix.data, once.matrix.data)


# ---- the host API around the multiply on the card ------------------------------

def _banded_pair(rows=1200, tile=16, seed=1):
    """A banded SCF-like matrix of blocks 3/5/7 (±3 blocks at 60% fill) on
    the CPU, with its copy on the card."""
    rng = np.random.default_rng(seed)
    rbs = dtt.random_block_sizes(rows, [3, 5, 7], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n), 7)
    j = i + np.tile(np.arange(-3, 4), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.6)
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
              for r, c in zip(i[keep], j[keep])]
    with config_override(tile_size=tile):
        a = dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs, device="cpu")
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_limits_window_on_the_card_runs_its_kernel(dev, dtype):
    """A window over rows, cols and k (the middle half of each) with beta·C:
    K2 in float32, the float64 stack kernel in float64, against the same
    call on CPU tensors (the plain versions)."""
    a = _banded_pair().astype(dtype)
    ag = a.with_data(a.data.to(dev))
    n = a.nblkrows
    lim = {"rows": (n // 4, 3 * n // 4), "cols": (n // 4, 3 * n // 4),
           "k": (n // 4, 3 * n // 4)}
    counter = tile_stack_matmul_panel if dtype == torch.float32 else tile_stack_matmul_f64
    with config_override(tile_size=16, matmul_precision="highest"):
        ref = dtt.multiply("N", "T", 1.0, a, a, 0.5, a, limits=lim)
        before = counter.launches
        got = dtt.multiply("N", "T", 1.0, ag, ag, 0.5, ag, limits=lim)
        assert counter.launches == before + 1
    assert got.data.is_cuda
    np.testing.assert_array_equal(got.index.col_idx, ref.index.col_idx)
    assert rel_err(got.data, ref.data) <= (RTOL_F64 if dtype == torch.float64 else RTOL)


@pytest.mark.parametrize("driver,dtype", [("auto", torch.float32), ("stack", torch.float32),
                                          ("auto", torch.float64)])
def test_retiled_executors_match_tile_128(dev, driver, dtype):
    """The product at T = 64 (retiled operands) against the product at T =
    128: the same block index, so the flat data compares."""
    a = _banded_pair(rows=6000, tile=128, seed=3).astype(dtype)
    ag = a.with_data(a.data.to(dev))
    with config_override(matmul_precision="highest", mm_driver=driver):
        f128, c_index, _ = dtt.build_multiply_executor("N", "N", ag, ag)
        r64 = dtt.retile(ag, 64)
        assert torch.equal(dtt.retile(r64, 128).data, ag.data)
        f64, c64, _ = dtt.build_multiply_executor("N", "N", r64, r64)
        out128, out64 = f128(ag.data, ag.data), f64(r64.data, r64.data)
    np.testing.assert_array_equal(c64.col_idx, c_index.col_idx)
    flat = [dtt.BCSRMatrix(name="C", index=ci, data=o).flat_host()
            for ci, o in ((c_index, out128), (c64, out64))]
    tol = RTOL_F64 if dtype == torch.float64 else 1e-4
    assert np.abs(flat[1] - flat[0]).max() <= tol * np.abs(flat[0]).max()


def test_checkpoint_of_a_card_matrix(dev, tmp_path):
    a = _banded_pair(seed=4).astype(torch.float64)
    ag = a.with_data(a.data.to(dev))
    dtt.binary_write(ag, str(tmp_path / "a.bin"))
    with config_override(tile_size=16):
        back = dtt.binary_read(str(tmp_path / "a.bin"), device=dev)
        csr_back = dtt.from_csr(dtt.to_csr(ag), a.row_block_sizes, a.col_block_sizes,
                                device=dev, name=a.name)
    assert back.data.is_cuda and torch.equal(back.data, ag.data)
    assert dtt.checksum(back, pos=True) == dtt.checksum(a, pos=True)
    assert csr_back.data.is_cuda and torch.equal(csr_back.data, ag.data)


def test_validate_kernels_and_self_tests_on_the_card(dev):
    from dbcsr_tpu_torch import testing

    assert testing.validate_kernels(dev, verbose=True) is True
    assert testing.validate_kernels(dev, tile=64) is True
    assert testing.run_tests(dev) is True


def test_device_memory_stats_follow_torch(dev):
    from dbcsr_tpu_torch.core.machine import device_memory_stats

    x = torch.empty(1 << 20, device=dev)
    stats = device_memory_stats(dev)
    assert stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated(dev)
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated(dev)
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(dev).total_memory
    assert device_memory_stats() is not None
    del x


# ---------------------------------------------------------------------------
# KC1 (complex64) and KC2 (complex128), the complex flat stack kernels
# ---------------------------------------------------------------------------

RTOL_C = {torch.complex64: 1e-4, torch.complex128: RTOL_F64}


def complex_rel_err(got, ref) -> float:
    return rel_err(torch.view_as_real(got), torch.view_as_real(ref))


def gappy_stack(rng, n_c=24, run=5, n_tiles=12):
    """Runs of ``run`` entries, except for C tiles with none: the first, the
    last and four in a row in the middle (their products are zero tiles)."""
    runs = np.full(n_c, run)
    runs[[0, n_c - 1]] = 0
    runs[10:14] = 0
    c = np.repeat(np.arange(n_c), runs)
    return np.stack([c, rng.integers(0, n_tiles, len(c)),
                     rng.integers(0, n_tiles, len(c))], axis=1).astype(np.int32), n_c


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_complex_kernels_match_plain(dev, tile, dtype):
    """KC1 / KC2 against their plain version on runs of random length, runs
    of 1, runs of 48 and runs with empty C tiles first, last and in a row;
    each launch counted; two launches bitwise equal."""
    from dbcsr_tpu_torch.mm.c_stack import (
        tile_stack_matmul_c, tile_stack_matmul_c64, tile_stack_matmul_c128,
        tile_stack_matmul_c_plain,
    )

    wrapper = tile_stack_matmul_c64 if dtype == torch.complex64 else tile_stack_matmul_c128
    rng = np.random.default_rng(tile)
    a = torch.randn(12, tile, tile, device=dev, dtype=dtype)
    b = torch.randn(12, tile, tile, device=dev, dtype=dtype)
    cases = [random_stack(rng), random_stack(rng, n_c=30, s=30),
             (run_stack(rng, 7, 48), 7), gappy_stack(rng)]
    for stack, n_c in cases:
        ds = device_stack(stack, n_c, dev)
        before = wrapper.launches
        got = tile_stack_matmul_c(a, b, ds)
        assert wrapper.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == (n_c, tile, tile)
        assert complex_rel_err(got, tile_stack_matmul_c_plain(a, b, ds)) <= RTOL_C[dtype]
        assert torch.equal(got, wrapper(a, b, ds))  # deterministic
        empty = np.setdiff1d(np.arange(n_c), stack[:, 0])
        assert not got[torch.as_tensor(empty, device=dev)].any()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_kernels_read_memory_not_the_conj_bit(dev, dtype):
    """A lazy ``torch.conj`` view carries the unconjugated values in memory:
    the wrapper resolves it before the kernel reads raw pointers, so the
    product is that of the conjugated stores."""
    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c, tile_stack_matmul_c_plain

    stack, n_c = random_stack(np.random.default_rng(2))
    ds = device_stack(stack, n_c, dev)
    a = torch.randn(12, 64, 64, device=dev, dtype=dtype)
    b = torch.randn(12, 64, 64, device=dev, dtype=dtype)
    got = tile_stack_matmul_c(a.conj(), b, ds)
    ref = tile_stack_matmul_c_plain(a.conj_physical(), b, ds)
    assert complex_rel_err(got, ref) <= RTOL_C[dtype]
    assert complex_rel_err(got, tile_stack_matmul_c(a, b, ds)) > 0.1


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("trans", ["NN", "CN", "NC", "TC"])
def test_complex_executor_routes_through_the_kernel(dev, dtype, trans):
    """``multiply`` and the executor on the card under every sparse driver:
    route ``c_stack``, the kernel launched, the result equal to the same
    multiply on CPU tensors (the plain version) within the kernel's bound."""
    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c64, tile_stack_matmul_c128

    wrapper = tile_stack_matmul_c64 if dtype == np.complex64 else tile_stack_matmul_c128
    rng = np.random.default_rng(5)
    rbs = dtt.random_block_sizes(400, [5, 13, 23], rng)
    with config_override(tile_size=32):
        a = dtt.random_matrix(rbs, rbs, 0.05, rng, dtype=dtype, device="cpu")
        b = dtt.random_matrix(rbs, rbs, 0.05, rng, dtype=dtype, device="cpu")
        ref = dtt.multiply(trans[0], trans[1], 0.5 - 1j, a, b)
        ag, bg = (m.with_data(m.data.to(dev)) for m in (a, b))
        for driver in ("auto", "stack", "panel", "band", "grouped"):
            with config_override(mm_driver=driver):
                before = wrapper.launches
                got = dtt.multiply(trans[0], trans[1], 0.5 - 1j, ag, bg)
                fn, _, _ = dtt.build_multiply_executor(trans[0], trans[1], ag, bg)
                fn(ag.data, bg.data)
            assert fn.plan.route == "c_stack" and wrapper.launches == before + 2
            np.testing.assert_array_equal(got.index.col_idx, ref.index.col_idx)
            assert complex_rel_err(got.data.cpu(), ref.data) <= RTOL_C[got.dtype]


def test_complex_wrappers_refuse(dev):
    """Misaligned complex stores, a real store, a CPU/GPU mix."""
    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c64, tile_stack_matmul_c128

    stack, n_c = random_stack(np.random.default_rng(0))
    ds = device_stack(stack, n_c, dev)
    flat = torch.randn(12 * 32 * 32 + 1, device=dev, dtype=torch.complex64)
    bad = flat[1: 1 + 12 * 32 * 32].view(12, 32, 32)  # 8 bytes in
    good = flat[: 12 * 32 * 32].view(12, 32, 32)
    with pytest.raises(ValueError, match="16-byte"):
        tile_stack_matmul_c64(bad, good, ds)
    with pytest.raises(TypeError):
        tile_stack_matmul_c128(good, good, ds)
    with pytest.raises(TypeError):
        tile_stack_matmul_c64(good.real.contiguous(), good.real.contiguous(), ds)


# ---------------------------------------------------------------------------
# the distributed multiply: every rank's tick on its kernel, cuda:0 ranks
# ---------------------------------------------------------------------------

def _dist_operands(dev, dtype, rng, tile=32):
    from dbcsr_tpu_torch.dist import ProcessGrid, tile_aligned_dist

    with config_override(tile_size=tile):
        rbs = dtt.random_block_sizes(300, [5, 13, 23], rng)
        a = dtt.random_matrix(rbs, rbs, 0.15, rng, dtype=dtype, device=dev)
        b = dtt.random_matrix(rbs, rbs, 0.15, rng, dtype=dtype, device=dev)
    return a, b, rbs, ProcessGrid, tile_aligned_dist


@pytest.mark.parametrize("dtype,kernel", [
    (np.float32, "K1"), (np.float64, "f64"), (np.complex64, "KC1"),
    (np.complex128, "KC2")])
@pytest.mark.parametrize("shape,algo", [((2, 2, 1), "cannon"), ((2, 2, 2), "cannon"),
                                        ((2, 4, 1), "summa")])
def test_distributed_ticks_run_their_kernel(dev, shape, algo, dtype, kernel):
    """Each non-empty (rank, tick) stack is one launch of the dtype's stack
    kernel, on four or eight cuda:0 ranks, and the product agrees with the
    same executor's ranks on the CPU (the plain versions), bitwise twice."""
    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c64, tile_stack_matmul_c128

    wrapper = {"K1": tile_stack_matmul, "f64": tile_stack_matmul_f64,
               "KC1": tile_stack_matmul_c64, "KC2": tile_stack_matmul_c128}[kernel]
    rng = np.random.default_rng(4)
    a, b, rbs, ProcessGrid, tile_aligned_dist = _dist_operands(dev, dtype, rng)
    grid = ProcessGrid.make(*shape, devices=[dev] * 8)
    fn, _, _ = dtt.build_distributed_executor(
        "N", "N", a, b, tile_aligned_dist(grid, rbs, rbs, 32), algo=algo)
    cpu = torch.device("cpu")
    grid_c = ProcessGrid.make(*shape, devices=[cpu] * 8)
    a_c, b_c = a.with_data(a.data.cpu()), b.with_data(b.data.cpu())
    fn_c, _, _ = dtt.build_distributed_executor(
        "N", "N", a_c, b_c, tile_aligned_dist(grid_c, rbs, rbs, 32), algo=algo)
    before = wrapper.launches
    out = fn(a.data, b.data)
    assert wrapper.launches - before == fn.plan.launches > 0
    assert torch.equal(fn(a.data, b.data), out)
    ref = fn_c(a_c.data, b_c.data)
    tol = RTOL_F64 if dtype in (np.float64, np.complex128) else RTOL
    assert (out.cpu() - ref).abs().max() <= tol * ref.abs().max()


def test_distributed_grid_needs_a_device(dev, monkeypatch):
    """With CUDA present the default grid cycles over the visible devices;
    with CUDA absent (simulated) and no devices= it raises."""
    from dbcsr_tpu_torch.core.errors import DbcsrError
    from dbcsr_tpu_torch.dist import ProcessGrid

    g = ProcessGrid.make(2, 2, 2)
    assert all(d.type == "cuda" for d in g.devices.flat)
    assert len(g.unique_devices()) == min(8, torch.cuda.device_count())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DbcsrError, match="no CUDA device"):
        ProcessGrid.make(2, 2)


def test_distributed_multiply_and_sharded_ops_on_the_card(dev):
    """multiply(dist=...) through the element-granular plan (block-cyclic)
    and the sharded at-rest form on cuda:0 ranks, against the local
    multiply; the self-test's distributed legs."""
    from dbcsr_tpu_torch.testing import test_dist

    assert test_dist(dev)


# ---------------------------------------------------------------------------
# the C API shim on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def capi(dev, monkeypatch):
    """The port's C API shim loaded into this process with ``ctypes.CDLL``
    (the GIL is released around each call; the shim takes it back), its
    device the card."""
    import ctypes

    from dbcsr_tpu_torch.capi import build_capi

    so = build_capi()
    if so is None:
        pytest.skip("no C shim (gcc or a shared libpython missing)")
    monkeypatch.setenv("DBCSR_CAPI_DEVICE", "cuda:0")
    lib = ctypes.CDLL(so)
    i64, i32, dbl, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    lib.c_dbcsr_last_error.restype = ctypes.c_char_p
    lib.c_dbcsr_create_new.argtypes = [ctypes.POINTER(i64), ctypes.c_char_p, i64,
                                       ctypes.c_char, vp, i32, vp, i32, i32]
    lib.c_dbcsr_create_template.argtypes = [ctypes.POINTER(i64), ctypes.c_char_p, i64, i64,
                                            ctypes.c_char, i32]
    for suf in ("d", "z"):
        getattr(lib, f"c_dbcsr_put_block2d_{suf}").argtypes = [i64, i32, i32, vp, i32, i32, i32]
        getattr(lib, f"c_dbcsr_multiply_{suf}").argtypes = [
            ctypes.c_char, ctypes.c_char, dbl, dbl, i64, i64, dbl, dbl, i64, i32, dbl,
            ctypes.POINTER(dbl)]
        getattr(lib, f"c_dbcsr_get_data_{suf}").argtypes = [i64, vp, i32, ctypes.POINTER(i64)]
    lib.c_dbcsr_finalize.argtypes = [i64]
    lib.c_dbcsr_release.argtypes = [i64]
    assert lib.c_dbcsr_init_lib() == 0, lib.c_dbcsr_last_error()
    return lib


@pytest.mark.parametrize("typ", ["d", "z"])
def test_capi_typed_product_runs_its_kernel_on_the_card(capi, dev, typ):
    """A banded product of 5/13/23-blocks through ``c_dbcsr_multiply_d`` /
    ``_z`` under ``mm_driver="stack"``: the float64 kernel (d) or KC2 (z)
    moves by one and nothing else launches; the result read back through
    ``c_dbcsr_get_data`` is bitwise the Python ``multiply``'s."""
    import ctypes

    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c64, tile_stack_matmul_c128

    lib = capi
    dtype, const = {"d": (np.float64, 3), "z": (np.complex128, 7)}[typ]
    rbs = np.array([5, 13, 23, 13, 5, 23, 13, 5] * 4, dtype=np.int32)
    n = len(rbs)
    rng = np.random.default_rng(11)
    h = ctypes.c_int64()
    assert lib.c_dbcsr_create_new(ctypes.byref(h), b"A", 0, b"N", rbs.ctypes.data, n,
                                  rbs.ctypes.data, n, const) == 0
    a_handle = h.value
    ref_b = dtt.BCSRBuilder(rbs, rbs, dtype=dtype, device=dev)
    for i in range(n):
        for j in range(max(0, i - 3), min(n, i + 4)):
            blk = rng.standard_normal((rbs[i], rbs[j]))
            if typ == "z":
                blk = blk + 1j * rng.standard_normal((rbs[i], rbs[j]))
            blk = np.ascontiguousarray(blk.astype(dtype))
            put = getattr(lib, f"c_dbcsr_put_block2d_{typ}")
            assert put(a_handle, i, j, blk.ctypes.data, int(rbs[i]), int(rbs[j]), 0) == 0
            ref_b.put_block(i, j, blk)
    assert lib.c_dbcsr_finalize(a_handle) == 0
    assert lib.c_dbcsr_create_template(ctypes.byref(h), b"C", a_handle, 0, b"N", const) == 0
    c_handle = h.value
    assert lib.c_dbcsr_finalize(c_handle) == 0
    a = ref_b.finalize()
    c0 = dtt.BCSRMatrix.empty(rbs, rbs, device=dev, dtype=dtype, tile=a.tile)
    counters = (tile_stack_matmul_f64, tile_stack_matmul, tile_stack_matmul_panel,
                tile_stack_matmul_c64, tile_stack_matmul_c128)
    want = tile_stack_matmul_f64 if typ == "d" else tile_stack_matmul_c128
    flop = ctypes.c_double()
    with config_override(mm_driver="stack"):
        ref = dtt.multiply("N", "T", 1.0, a, a, 0.0, c0)
        for k in counters:
            k.launches = 0
        mult = getattr(lib, f"c_dbcsr_multiply_{typ}")
        assert mult(b"N", b"T", 1.0, 0.0, a_handle, a_handle, 0.0, 0.0, c_handle, 0, -1.0,
                    ctypes.byref(flop)) == 0, lib.c_dbcsr_last_error()
    assert [k.launches for k in counters] == [int(k is want) for k in counters]
    host = ref.flat_host()
    got = np.empty(host.size, dtype=dtype)
    size = ctypes.c_int64()
    get = getattr(lib, f"c_dbcsr_get_data_{typ}")
    assert get(c_handle, got.ctypes.data, host.size, ctypes.byref(size)) == 0
    assert size.value == host.size and flop.value > 0
    np.testing.assert_array_equal(got, host)
    for handle in (a_handle, c_handle):
        assert lib.c_dbcsr_release(handle) == 0


# ---------------------------------------------------------------------------
# the autotune sweep and the tuned table on the card
# ---------------------------------------------------------------------------

#: the kernel launch counter behind each route
ROUTE_WRAPPER = {"stack": tile_stack_matmul, "band": band_matmul,
                 "panel": tile_stack_matmul_panel}


def test_autotune_two_row_sweep_on_the_card(dev):
    """Two rows of the sweep at the banded_fine class, timed with CUDA
    events: each takes its driver's route and launches its kernel once a
    call (2 warm + 10 timed)."""
    counts = {r: w.launches for r, w in ROUTE_WRAPPER.items()}
    table = autotune.sweep(grid={"mm_driver": ["stack", "band"]},
                           workloads=["banded_fine"], device=dev, verbose=False)
    assert table["device_kind"] == torch.cuda.get_device_name(0)
    rows = table["results"]["banded_fine"]["all"]
    assert sorted(r["route"] for r in rows) == ["band", "stack"]
    assert all(r["gflops"] > 0 for r in rows)
    for route in ("stack", "band"):
        assert ROUTE_WRAPPER[route].launches - counts[route] == 12, route


#: the panel knobs a tuned row carries (the engine applies them with its
#: driver; its precision and bf16 knobs are not applied)
PANEL_KNOBS = ("panel_c_win", "panel_cache", "panel_chunk", "panel_runlen")


def test_autotune_committed_table_takes_its_driver(dev, monkeypatch):
    """Under the committed table, ``auto`` at default provenance takes the
    nearest class's driver, and its product is bitwise the explicit
    driver's with the same panel knobs."""
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    monkeypatch.delitem(autotune._TABLE_CACHE, torch.cuda.get_device_name(0))
    get_plan_cache().clear()
    table = autotune._cached_table(dev)
    assert table is not None, "no committed table for this card"
    a, b = autotune.WORKLOADS["banded_fine"](0, dev)
    cls, _ = autotune.nearest_class(autotune.workload_features(a.index, b.index), table)
    best = table["results"][cls]["best"]
    fn, _, _ = dtt.build_multiply_executor("N", "N", a, b)
    assert fn.plan.route.replace("panel_runs", "panel") == best["mm_driver"]
    knobs = {k: best[k] for k in PANEL_KNOBS if k in best}
    with config_override(mm_driver=best["mm_driver"], **knobs):
        fx, _, _ = dtt.build_multiply_executor("N", "N", a, b)
    assert fx.plan.route == fn.plan.route
    assert torch.equal(fn(a.data, b.data), fx(a.data, b.data))
    get_plan_cache().clear()



def _mp_operands(dev, dtype):
    """Small banded-ish operands, the same on every process (one seed)."""
    rng = np.random.default_rng(11)
    rbs = dtt.random_block_sizes(1500, [5, 13, 23], rng)
    a = dtt.random_matrix(rbs, rbs, 0.3, rng, dtype=dtype, name="A", device=dev)
    b = dtt.random_matrix(rbs, rbs, 0.3, rng, dtype=dtype, name="B", device=dev)
    return a, b


def _mp_cannon(a, b, dev=None):
    """Cannon 2×2 over ``ProcessGrid.make``: the single-process virtual
    ranks of ``dev``, or, in a distributed run, the ranks of the world."""
    from dbcsr_tpu_torch.dist import ProcessGrid, tile_aligned_dist

    grid = ProcessGrid.make(2, 2, devices=None if dev is None else [dev] * 4)
    dist = tile_aligned_dist(grid, a.row_block_sizes, a.row_block_sizes, a.tile)
    fn, _, _ = dtt.build_distributed_executor("N", "N", a, b, dist, algo="cannon")
    return fn


def _mp_worker(pid, url, out, refs):
    """One of two processes on cuda:0 over gloo (spawned by the test below)."""
    import json

    dtt.init_lib(distributed=True, coordinator_address=url, num_processes=2,
                 process_id=pid, backend="gloo", device="cuda:0")
    dev = torch.device("cuda", 0)
    res = {}
    for name, dtype, kern in (("float32", np.float32, tile_stack_matmul),
                              ("float64", np.float64, tile_stack_matmul_f64)):
        a, b = _mp_operands(dev, dtype)
        fn = _mp_cannon(a, b)
        before = kern.launches
        c = fn(a.data, b.data)
        torch.cuda.synchronize()
        res[name] = {"bitwise": bool(torch.equal(c.cpu(), refs[name])),
                     "launches": kern.launches - before, "planned": fn.plan.launches}
    with open(f"{out}/mp_{pid}.json", "w") as f:
        json.dump(res, f)
    dtt.finalize_lib()


def test_mp_two_processes_on_one_card_over_gloo(dev, tmp_path):
    """Two processes on cuda:0 over gloo (the CUDA pieces staged through
    pinned host memory), Cannon 2×2 in float32 (K1) and float64 (the
    float64 kernel): each process's C is bitwise the single-process
    executor's, and its launches are its own ranks' ticks."""
    import json
    import time

    import torch.multiprocessing as tmp

    from dbcsr_tpu_torch import _build

    _build.build_kernels()  # the workers load this build
    refs = {}
    for name, dtype in (("float32", np.float32), ("float64", np.float64)):
        a, b = _mp_operands(dev, dtype)
        refs[name] = _mp_cannon(a, b, dev)(a.data, b.data).cpu()
    ctx = tmp.start_processes(_mp_worker, args=(f"file://{tmp_path}/rdzv", str(tmp_path),
                                                refs),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + 120
    try:
        while not ctx.join(timeout=5):
            assert time.time() < deadline, "the workers did not finish within 120 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for pid in range(2):
        res = json.loads((tmp_path / f"mp_{pid}.json").read_text())
        for name, r in res.items():
            assert r["bitwise"], (pid, name)
            assert r["launches"] == r["planned"] > 0, (pid, name, r)


# ---- the examples and the large-scale tool on the card ------------------------

PORT_EXAMPLES = ["example_1_create_multiply", "example_2_tensor_contraction",
                 "example_3_sparse_1000", "example_5_purification", "example_8_reordering",
                 "example_9_reference_example_3", "example_10_reference_tensor_example_2"]


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_example_runs_on_the_card(dev, name):
    """Each example's main on the card passes its own assertions; its
    stores lie on the card (example 3's executor is timed by CUDA events)."""
    out = load(f"examples/torch/{name}.py", f"cuda_{name}").main(
        ["--device", "cuda"])
    assert isinstance(out, dict)
    if name == "example_3_sparse_1000":
        assert out["clock"] == "CUDA events" and out["ms"] > 0
    if name == "example_1_create_multiply":
        assert out["device"].startswith("cuda")
    if name == "example_9_reference_example_3":
        assert out["blocks"] == 16 and out["launches"].get("K6", 0) >= 1  # Cannon's ticks


def test_large_scale_check_at_100k_rows_against_its_plain_version(dev):
    """tools/torch/large_scale_check.py at 100,000 rows: each leg's executor
    (auto, stack) launches its route's kernel and agrees with the kernel's
    plain version over the whole C store."""
    import os
    import sys

    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    lsc = load("tools/torch/large_scale_check.py", "cuda_large_scale_check")
    a, b, out = lsc.build(100_000, 8, dev)
    assert out["blocks"] > 7000 and out["n_tiles"] > 0
    for driver in ("auto", "stack"):
        leg, fn, c_index, prod = lsc.measure(a, b, driver)
        assert leg["clock"] == "CUDA events" and leg["executor_median_ms"] > 0
        assert sum(leg["launches"].values()) >= 1, leg
        ref = take_tiles(chip_smoke.plain_of(fn.plan, a.data, b.data),
                         fn.plan.align_map(store_layout(c_index, 128).tile_keys()), 128)
        assert rel_err(prod, ref) <= 1e-4, driver
