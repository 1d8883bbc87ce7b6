"""Port parity, the slice as a whole: ``multiply`` and
``build_multiply_executor`` of dbcsr_tpu_torch against dbcsr_tpu on the
same matrices (one numpy block description fed to both), through every
driver (dense, stack, panel, band, grouped, the run-fused panel plan, the
RCM-reordered panel plan); plus the driver choice of ``auto``, the options
that are not ported yet, and the jax-free import.

On the CPU the port's stack kernels run their plain versions and the JAX
package its XLA twins (its Pallas drivers run on a TPU only, so for the
panel, grouped and run-fused routes the PLANS are compared with the JAX
planners' and the values with its XLA stack product). Tolerances, relative to the largest reference entry:
- float64: 1e-12 — the same float64 products summed in another order (the
  JAX side is held to native float64 with ``f64_method="native"``: its
  default routes float64 stacks through a bf16-slice emulation that exists
  for the TPU and is accurate to ~1e-15, not to the last bit);
- float32 at "highest": 2e-5 — IEEE float32 on both sides, another
  summation order over at most a few hundred terms.
"""
import subprocess
import sys
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.core.config import get_config as jax_config
from dbcsr_tpu.mm.band import plan_band
from dbcsr_tpu.mm.engine import _maybe_panel_plan_impl
from dbcsr_tpu.mm.reorder import locality_reorder_plan as jax_reorder_plan
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores as jax_tile_plan

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.stats import get_stats, reset_stats
from dbcsr_tpu_torch.autotune import coords_bandedness
from dbcsr_tpu_torch.mm.panel import PanelPlan, PanelRunPlan

torch.set_num_threads(1)

RTOL = {np.float64: 1e-12, np.float32: 2e-5}
TRANS = [("N", "N"), ("T", "N"), ("N", "T"), ("C", "T")]


def both(tile=None, **kw):
    """The same config override in both packages."""
    es = ExitStack()
    extra = {} if tile is None else {"tile_size": tile}
    es.enter_context(jax_override(f64_method="native", **extra, **kw))
    es.enter_context(torch_override(**extra, **kw))
    return es


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def pattern(kind, seed):
    """(rows, cols, block sizes) of a square block pattern: "random"
    (uniform, sparse), "full" (every block) or "banded" (the linear-scaling
    SCF shape of bench.py, narrowed)."""
    rng = np.random.default_rng(seed)
    sizes_rng = np.random.default_rng(0)  # one block structure per kind
    if kind == "banded":
        rbs = djax.random_block_sizes(300, [3, 5, 7], sizes_rng)
        n = len(rbs)
        i = np.repeat(np.arange(n), 7)
        j = i + np.tile(np.arange(-3, 4), n)
        keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.6)
        return i[keep], j[keep], rbs
    rbs = djax.random_block_sizes(120 if kind == "random" else 40, [2, 3, 5], sizes_rng)
    occ = 0.06 if kind == "random" else 1.0
    r, c = np.nonzero(rng.random((len(rbs), len(rbs))) < occ)
    return r, c, rbs


def pair(kind, seed, dtype, tile):
    """The same matrix in both packages, from one numpy description."""
    rows, cols, rbs = pattern(kind, seed)
    rng = np.random.default_rng(seed + 100)
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(dtype)
              for r, c in zip(rows, cols)]
    with both(tile):
        mj = djax.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=dtype)
        mt = dtt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=dtype,
                                        device="cpu")
    return mj, mt


def dense(m):
    return m.to_dense().numpy() if isinstance(m.data, torch.Tensor) else np.asarray(m.to_dense())


CASES = [(8, np.float64), (16, np.float32)]


@pytest.mark.parametrize("tile,dtype", CASES)
@pytest.mark.parametrize("driver,kind", [
    ("dense", "random"), ("stack", "random"), ("panel", "banded"),
    ("auto", "random"), ("auto", "full"), ("auto", "banded"),
    ("band", "banded"), ("grouped", "random"), ("grouped", "banded"),
])
def test_multiply_matches_jax(driver, kind, tile, dtype):
    aj, at = pair(kind, 1, dtype, tile)
    bj, bt = pair(kind, 2, dtype, tile)
    cj, ct = pair(kind, 3, dtype, tile)
    with both(tile, mm_driver=driver, matmul_precision="highest"):
        # every transpose pair; alpha/beta with an existing C on half of them
        for (ta, tb), use_c in zip(TRANS, (False, True, False, True)):
            alpha, beta = (0.5, -2.0) if use_c else (1.0, 0.0)
            rj, fj = djax.multiply(ta, tb, alpha, aj, bj, beta,
                                   cj if use_c else None, return_flops=True)
            rt, ft = dtt.multiply(ta, tb, alpha, at, bt, beta,
                                  ct if use_c else None, return_flops=True)
            np.testing.assert_array_equal(rj.index.row_ptr, rt.index.row_ptr)
            np.testing.assert_array_equal(rj.index.col_idx, rt.index.col_idx)
            assert fj == ft and rt.dtype == at.dtype
            assert rel_err(dense(rt), dense(rj)) <= RTOL[dtype], (ta, tb, use_c)


@pytest.mark.parametrize("tile,dtype", CASES)
@pytest.mark.parametrize("driver,kind", [
    ("dense", "random"), ("stack", "random"), ("panel", "banded"), ("auto", "banded"),
    ("band", "banded"), ("grouped", "random"), ("grouped", "banded"),
])
def test_executor_matches_jax(driver, kind, tile, dtype):
    aj, at = pair(kind, 4, dtype, tile)
    bj, bt = pair(kind, 5, dtype, tile)
    with both(tile, matmul_precision="highest"):
        for ta, tb in (("N", "N"), ("T", "N"), ("N", "T")):
            fj, cij, ej = djax.mm.engine.build_multiply_executor(ta, tb, aj, bj, driver=driver)
            ft, cit, et = dtt.build_multiply_executor(ta, tb, at, bt, driver=driver)
            if driver in ("band", "grouped"):
                assert ft.plan.route == driver
            np.testing.assert_array_equal(cij.col_idx, cit.col_idx)
            np.testing.assert_array_equal(cij.row_ptr, cit.row_ptr)
            assert ej == et
            gj, gt = np.asarray(fj(aj.data, bj.data)), ft(at.data, bt.data).numpy()
            assert gj.shape == gt.shape
            assert rel_err(gt, gj) <= RTOL[dtype]
            # new data, same patterns: the plan is reused
            gt2 = ft(2.0 * at.data, bt.data).numpy()
            assert rel_err(gt2, 2.0 * gj) <= RTOL[dtype]


@pytest.mark.parametrize("tile", [8, 16])
def test_auto_picks_panel_on_banded_in_both_packages(tile):
    """On the banded pattern the JAX package's auto (on the TPU) rejects
    the band driver and admits the panel plan; the port's auto takes the
    panel route with the identical plan."""
    aj, at = pair("banded", 6, np.float32, tile)
    with both(tile, matmul_precision="highest"):
        lay = aj.layout
        grid = (lay.ntr, lay.ntc)
        tp = jax_tile_plan(lay.tile_coords, grid, lay.tile_coords, grid)
        cfg = jax_config()
        assert plan_band(lay.tile_coords, grid, lay.tile_coords, grid,
                         tp.c_tile_keys, tile=tile, n_stack=len(tp.stack),
                         max_products=cfg.band_max_products,
                         flop_factor=cfg.band_flop_factor * 0.125) is None
        jplan = _maybe_panel_plan_impl(cfg, tp, aj.index, aj.index, lay.n_tiles,
                                       lay.n_tiles, "auto", None)
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
    assert jplan is not None and fn.plan.route == "panel"
    tplan = fn.plan.panel.plan
    for f in PanelPlan.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(jplan, f), getattr(tplan, f), err_msg=f)


def same_fields(cls, pj, pt):
    assert type(pj).__name__ == cls.__name__ and isinstance(pt, cls)
    for f in cls.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f), err_msg=f)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("runlen", [2, 4])
def test_panel_runlen_takes_the_run_plan_in_both_packages(tile, runlen):
    """``panel_runlen >= 2`` under ``mm_driver="panel"``: both packages plan
    the run-fused form on the column-major B numbering (the identical
    ``PanelRunPlan``); the port's route says so and its values match the JAX
    package's product. ``panel_runlen`` is part of the plan cache key: the
    same matrices at runlen 0 take the per-entry plan."""
    aj, at = pair("banded", 16, np.float32, tile)
    bj, bt = pair("banded", 17, np.float32, tile)
    with both(tile, matmul_precision="highest", mm_driver="panel",
              panel_runlen=runlen, panel_cache=64):
        tp = jax_tile_plan(aj.layout.tile_coords, (aj.layout.ntr, aj.layout.ntc),
                           bj.layout.tile_coords, (bj.layout.ntr, bj.layout.ntc))
        jplan = _maybe_panel_plan_impl(
            jax_config(), tp, aj.index, bj.index, aj.layout.n_tiles,
            bj.layout.n_tiles, "panel", None, b_coords=bj.layout.tile_coords)
        fn, cit, _ = dtt.build_multiply_executor("N", "N", at, bt)
        fj, cij, _ = djax.mm.engine.build_multiply_executor("N", "N", aj, bj)
        rt, rj = dtt.multiply("N", "N", 1.0, at, bt), djax.multiply("N", "N", 1.0, aj, bj)
    assert fn.plan.route == "panel_runs"
    same_fields(PanelRunPlan, jplan, fn.plan.panel.plan)
    assert fn.plan.panel.plan.n_quads > 0
    np.testing.assert_array_equal(cij.col_idx, cit.col_idx)
    assert rel_err(fn(at.data, bt.data).numpy(), np.asarray(fj(aj.data, bj.data))) <= 2e-5
    assert rel_err(dense(rt), dense(rj)) <= 2e-5
    with torch_override(tile_size=tile, mm_driver="panel", panel_cache=64):
        f0, _, _ = dtt.build_multiply_executor("N", "N", at, bt)
    assert f0.plan.route == "panel" and isinstance(f0.plan.panel.plan, PanelPlan)


def test_panel_runlen_falls_back_when_column_major_spans_break_admission():
    """A cache that holds the row-major spans but not the column-major ones:
    the run plan is inadmissible and the per-entry panel plan is taken, in
    both packages."""
    aj, at = pair("banded", 18, np.float32, 8)
    lay = aj.layout
    grid = (lay.ntr, lay.ntc)
    found = None
    for cache in range(8, 64, 4):
        with both(8, mm_driver="panel", panel_runlen=4, panel_cache=cache, panel_chunk=4):
            tp = jax_tile_plan(lay.tile_coords, grid, lay.tile_coords, grid)
            jplan = _maybe_panel_plan_impl(
                jax_config(), tp, aj.index, aj.index, lay.n_tiles, lay.n_tiles,
                "panel", None, b_coords=lay.tile_coords)
            if type(jplan).__name__ == "PanelPlan":
                fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
                found = (jplan, fn)
                break
    assert found is not None, "no cache size separates the two plans"
    jplan, fn = found
    assert fn.plan.route == "panel"
    same_fields(PanelPlan, jplan, fn.plan.panel.plan)


def scrambled_pair(dtype, tile, seed=3, n=96, w=3):
    """As tests/test_reorder.py's executor test: banded tile patterns whose
    labels are scrambled by hidden permutations, blocks of one tile each, so
    the tile pattern IS the scrambled block pattern."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * w + 1)
    j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), n)
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    sig_m, sig_k, sig_n = (rng.permutation(n).astype(np.int64) for _ in range(3))
    rbs = np.full(n, tile, np.int32)
    out = []
    for sr, sc in ((sig_m, sig_k), (sig_k, sig_n)):
        blocks = [rng.standard_normal((tile, tile)).astype(dtype) for _ in i]
        with both(tile):
            out.append((
                djax.BCSRMatrix.from_blocks(sr[i], sc[j], blocks, rbs, rbs, dtype=dtype),
                dtt.BCSRMatrix.from_blocks(sr[i], sc[j], blocks, rbs, rbs, dtype=dtype,
                                           device="cpu"),
            ))
    return out


@pytest.mark.parametrize("driver", ["panel", "auto"])
@pytest.mark.parametrize("trans", [("N", "N"), ("T", "N"), ("N", "T")])
def test_reorder_auto_admits_the_panel_route_on_a_scrambled_band(driver, trans):
    """Clustered-but-scrambled: with ``reorder="off"`` the panel plan is
    inadmissible (explicit "panel" raises, "auto" takes the flat stack);
    with ``reorder="auto"`` the executor's RCM tile plan — identical to the
    JAX package's, as is the replanned panel plan — admits the panel route,
    and the product matches the unreordered one and the JAX package's."""
    ta, tb = trans
    (aj, at), (bj, bt) = scrambled_pair(np.float32, 8)
    if ta == "T":
        aj, at = djax.transpose(aj), dtt.transpose(at)
    if tb == "T":
        bj, bt = djax.transpose(bj), dtt.transpose(bt)
    with both(8, matmul_precision="highest", panel_cache=64, reorder="off"):
        if driver == "panel":
            with pytest.raises(dtt.DbcsrError, match="panel-admissible"):
                dtt.build_multiply_executor(ta, tb, at, bt, driver=driver)
            f_off, ci_off, _ = dtt.build_multiply_executor(ta, tb, at, bt, driver="stack")
        else:
            f_off, ci_off, _ = dtt.build_multiply_executor(ta, tb, at, bt, driver=driver)
        assert f_off.plan.route == "stack" and f_off.plan.reorder is None
        fj, cij, _ = djax.mm.engine.build_multiply_executor(ta, tb, aj, bj, driver=driver)
    with both(8, matmul_precision="highest", panel_cache=64, reorder="auto"):
        f_on, ci_on, _ = dtt.build_multiply_executor(ta, tb, at, bt, driver=driver)
        # the one-shot multiply does not reorder, in either package
        rt = dtt.multiply(ta, tb, 1.0, at, bt)
        # the JAX package's pieces of the same decision
        ac = djax.transpose(aj).layout.tile_coords if ta == "T" else aj.layout.tile_coords
        bc = djax.transpose(bj).layout.tile_coords if tb == "T" else bj.layout.tile_coords
        n = aj.layout.ntr
        rpj = jax_reorder_plan(ac, (n, n), bc, (n, n))
        tpj = jax_tile_plan(rpj.a_coords, (n, n), rpj.b_coords, (n, n))
        jplan = _maybe_panel_plan_impl(
            jax_config(), tpj, aj.index, bj.index, len(ac), len(bc), driver, None,
            banded_hint=coords_bandedness(rpj.a_coords[:, 0], rpj.a_coords[:, 1], n),
            b_coords=rpj.b_coords)
    lp = f_on.plan
    assert lp.route == "panel" and lp.reorder is not None
    for f in ("pm", "pk", "pn", "a_coords", "b_coords", "a_gather", "b_gather"):
        np.testing.assert_array_equal(getattr(rpj, f), getattr(lp.reorder, f), err_msg=f)
    same_fields(PanelPlan, jplan, lp.panel.plan)
    np.testing.assert_array_equal(ci_on.col_idx, ci_off.col_idx)
    np.testing.assert_array_equal(ci_on.col_idx, cij.col_idx)
    g_on, g_off = f_on(at.data, bt.data), f_off(at.data, bt.data)
    assert rel_err(g_on.numpy(), g_off.numpy()) <= 2e-5
    assert rel_err(g_on.numpy(), np.asarray(fj(aj.data, bj.data))) <= 2e-5
    assert rel_err(rt.data.numpy(), g_off.numpy()) <= 2e-5
    # new data over the same plan
    assert rel_err(f_on(2.0 * at.data, bt.data).numpy(), 2.0 * g_off.numpy()) <= 2e-5


def test_reorder_with_runlen_gives_a_reordered_run_plan():
    (aj, at), (bj, bt) = scrambled_pair(np.float32, 8)
    with torch_override(tile_size=8, panel_cache=128, panel_runlen=2, mm_driver="panel"):
        fn, ci, _ = dtt.build_multiply_executor("N", "N", at, bt)
        # the one-shot multiply does not reorder: explicit "panel" is refused
        with pytest.raises(dtt.DbcsrError, match="panel-admissible"):
            dtt.multiply("N", "N", 1.0, at, bt)
    with torch_override(tile_size=8, mm_driver="stack"):
        ref = dtt.multiply("N", "N", 1.0, at, bt)
    assert fn.plan.route == "panel_runs" and fn.plan.reorder is not None
    np.testing.assert_array_equal(ci.col_idx, ref.index.col_idx)
    assert rel_err(fn(at.data, bt.data).numpy(), ref.data.numpy()) <= 2e-5


def test_reorder_declines_on_a_uniform_random_pattern():
    """RCM cannot band a uniform-random pattern: under the default
    ``reorder="auto"`` the executor still takes the flat stack."""
    _, at = pair("random", 7, np.float32, 8)
    with torch_override(tile_size=8):
        assert dtt.get_config().reorder == "auto"
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
    assert fn.plan.route == "stack" and fn.plan.reorder is None


@pytest.mark.parametrize("prec,expect", [("highest", "panel"), ("default", "band")])
def test_auto_band_admission_follows_the_jax_rule(prec, expect):
    """The padded band work Wa·Wb·Mt is never below the stack's S, so the
    default ``band_flop_factor`` of 0.75 admits no pattern under "auto" (a
    tuned table or the user must ask). With the factor set to 1.5 a FULL
    band is admitted at "default" and not at "highest" (1.5 · 0.125), by
    the same ``plan_band`` verdict as the JAX package's."""
    n, t = 40, 8
    i = np.repeat(np.arange(n), 3)
    j = i + np.tile(np.arange(-1, 2), n)
    keep = (j >= 0) & (j < n)
    rbs = np.full(n, t, np.int32)
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((t, t)).astype(np.float32) for _ in i[keep]]
    with both(t, matmul_precision=prec):
        fd, _, _ = dtt.build_multiply_executor(
            "N", "N", dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs,
                                                 device="cpu"),
            dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs, device="cpu"))
    assert fd.plan.route == "panel"  # the default factor admits nothing
    with both(t, matmul_precision=prec, band_flop_factor=1.5):
        aj = djax.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs)
        at = dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs, device="cpu")
        lay = aj.layout
        tp = jax_tile_plan(lay.tile_coords, (n, n), lay.tile_coords, (n, n))
        cfg = jax_config()
        jband = plan_band(lay.tile_coords, (n, n), lay.tile_coords, (n, n),
                          tp.c_tile_keys, tile=t, n_stack=len(tp.stack),
                          max_products=cfg.band_max_products,
                          flop_factor=cfg.band_flop_factor
                          * (1.0 if prec == "default" else 0.125))
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
        rt, rj = dtt.multiply("N", "N", 1.0, at, at), djax.multiply("N", "N", 1.0, aj, aj)
    assert (jband is not None) == (expect == "band")
    assert fn.plan.route == expect
    assert rel_err(dense(rt), dense(rj)) <= (2e-2 if prec == "default" else 2e-5)
    if expect == "band":
        assert get_stats().hardware_flops >= jband.hw_flops == fn.plan.hw_flops


def test_explicit_band_rejects_an_unsuitable_pattern():
    _, rt = pair("random", 15, np.float32, 8)
    with torch_override(tile_size=8, mm_driver="band"):
        with pytest.raises(dtt.DbcsrError, match="band-suitable"):
            dtt.build_multiply_executor("N", "N", rt, rt)
        with pytest.raises(dtt.DbcsrError, match="band-suitable"):
            dtt.multiply("N", "N", 1.0, rt, rt)


@pytest.mark.parametrize("driver,kind", [("band", "banded"), ("grouped", "random")])
def test_float64_explicit_band_and_grouped_run_their_own_driver(driver, kind):
    """float64 under "auto"/"stack"/"panel" takes the float64 stack kernel;
    an explicit band or grouped request is honoured in float64."""
    _, at = pair(kind, 19, np.float64, 8)
    with torch_override(tile_size=8):
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at, driver=driver)
        f0, _, _ = dtt.build_multiply_executor("N", "N", at, at, driver="stack")
    assert fn.plan.route == driver and f0.plan.route == "f64_stack"
    out = fn(at.data, at.data)
    assert out.dtype == torch.float64
    assert rel_err(out.numpy(), f0(at.data, at.data).numpy()) <= 1e-12


@pytest.mark.parametrize("kind,route", [("random", "stack"), ("full", "dense")])
def test_auto_routes(kind, route):
    _, at = pair(kind, 7, np.float32, 8)
    with torch_override(tile_size=8):
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
    assert fn.plan.route == route


@pytest.mark.parametrize("driver,kind", [("dense", "random"), ("stack", "random"),
                                         ("panel", "banded"), ("band", "banded"),
                                         ("grouped", "banded")])
def test_bitwise_deterministic(driver, kind):
    _, at = pair(kind, 8, np.float32, 8)
    with torch_override(tile_size=8, mm_driver=driver):
        c1 = dtt.multiply("N", "N", 1.0, at, at)
        c2 = dtt.multiply("N", "N", 1.0, at, at)
    assert torch.equal(c1.data, c2.data)


def test_retain_sparsity_and_stats_match_jax():
    aj, at = pair("random", 9, np.float64, 8)
    cj, ct = pair("random", 10, np.float64, 8)
    reset_stats()
    with both(8, mm_driver="stack"):
        rj = djax.multiply("N", "N", 1.0, aj, aj, 1.0, cj, retain_sparsity=True)
        rt = dtt.multiply("N", "N", 1.0, at, at, 1.0, ct, retain_sparsity=True)
    np.testing.assert_array_equal(rj.index.col_idx, ct.index.col_idx)
    np.testing.assert_array_equal(rt.index.col_idx, ct.index.col_idx)
    assert rel_err(dense(rt), dense(rj)) <= RTOL[np.float64]
    st = get_stats()
    assert st.num_multiplications == 1 and st.hardware_flops >= st.total_flops > 0


def test_empty_product():
    rbs = np.array([3, 3, 3], np.int32)
    with both(8):
        aj = djax.BCSRMatrix.from_blocks([0], [0], [np.ones((3, 3))], rbs, rbs)
        bj = djax.BCSRMatrix.from_blocks([2], [2], [np.ones((3, 3))], rbs, rbs)
        at = dtt.BCSRMatrix.from_blocks([0], [0], [np.ones((3, 3))], rbs, rbs, device="cpu")
        bt = dtt.BCSRMatrix.from_blocks([2], [2], [np.ones((3, 3))], rbs, rbs, device="cpu")
        for driver in ("auto", "stack", "panel", "band", "grouped"):
            with torch_override(mm_driver=driver):
                rt = dtt.multiply("N", "N", 1.0, at, bt)
            assert rt.nblks == 0 and not rt.to_dense().any()
        rj = djax.multiply("N", "N", 1.0, aj, bj)
    assert rj.nblks == 0


def test_default_precision_uses_bf16_inputs():
    """"default" feeds bf16 to the flat stack kernel (float32 accumulation)
    and to the dense path: results stay within bf16 input rounding (2^-8
    relative per operand) of the float64 product."""
    _, at = pair("random", 11, np.float32, 16)
    ref = at.to_dense().double() @ at.to_dense().double()
    for driver in ("stack", "dense"):
        with torch_override(tile_size=16, mm_driver=driver, matmul_precision="default"):
            fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
            out = dtt.multiply("N", "N", 1.0, at, at)
        if driver == "stack":
            assert fn.plan.in_dtype == torch.bfloat16
        assert out.dtype == torch.float32
        err = rel_err(out.to_dense().numpy(), ref.numpy())
        assert 0 < err <= 2e-2


def test_bf16_matrices():
    _, at = pair("random", 12, np.float32, 8)
    ab = at.astype(torch.bfloat16)
    ref = ab.to_dense().double() @ ab.to_dense().double()
    with torch_override(tile_size=8, mm_driver="stack"):
        out = dtt.multiply("N", "N", 1.0, ab, ab)
    assert out.dtype == torch.bfloat16
    assert rel_err(out.to_dense().float().numpy(), ref.numpy()) <= 1e-2


def test_import_does_not_load_jax():
    code = ("import sys, dbcsr_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'dbcsr_tpu' not in sys.modules, 'dbcsr_tpu imported'")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("what", [
    "xla", "f64_slices", "dist", "k_dist", "complex",
])
def test_unported_options_raise(what):
    _, at = pair("random", 13, np.float64, 8)
    kw, cfg = {}, {}
    if what == "xla":
        cfg["mm_driver"] = what
    elif what == "f64_slices":
        cfg["f64_slices"] = 4
    elif what in ("dist", "k_dist"):
        # ported since: over a 2x2 grid of cpu ranks the product equals the
        # local one (k_dist: an explicit binning of the inner dimension)
        from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist

        grid = ProcessGrid.make(2, 2, devices=[torch.device("cpu")] * 4)
        d = block_cyclic_dist(grid, at.nblkrows, at.nblkcols)
        extra = {"k_dist": np.arange(at.nblkcols) % 2} if what == "k_dist" else {}
        with torch_override(tile_size=8):
            got = dtt.multiply("N", "N", 1.0, at, at, dist=d, **extra)
            ref = dtt.multiply("N", "N", 1.0, at, at)
        assert got.dist is d and np.array_equal(got.index.col_idx, ref.index.col_idx)
        assert torch.allclose(got.data, ref.data, rtol=1e-12, atol=1e-12)
        return
    elif what == "complex":
        # ported since: complex stores run through both entry points (the
        # complex stack kernels' route), and equal the real product there
        ac = at.with_data(at.data.to(torch.complex128))
        with torch_override(tile_size=8):
            got = dtt.multiply("N", "N", 1.0, ac, ac)
            fn, _, _ = dtt.build_multiply_executor("N", "N", ac, ac)
            ref = dtt.multiply("N", "N", 1.0, at, at)
        assert got.dtype == torch.complex128 and fn.plan.route in ("c_stack", "dense")
        assert torch.equal(got.data.imag, torch.zeros_like(ref.data))
        assert torch.allclose(got.data.real, ref.data, rtol=1e-12, atol=1e-12)
        assert torch.equal(fn(ac.data, ac.data), got.data)
        return
    # every message names where the option comes from: the ROADMAP item
    # that ports it, or (for the JAX-only XLA twin) the port's alternative
    match = "XLA twin" if what == "xla" else "ROADMAP"
    with torch_override(tile_size=8, **cfg):
        with pytest.raises(NotImplementedError, match=match):
            dtt.multiply("N", "N", 1.0, at, at, **kw)
        if not kw:
            with pytest.raises(NotImplementedError, match=match):
                dtt.build_multiply_executor("N", "N", at, at)


def test_bad_arguments():
    _, at = pair("random", 14, np.float64, 8)
    _, bt = pair("random", 14, np.float64, 16)
    with pytest.raises(dtt.DbcsrError, match="transpose"):
        dtt.multiply("X", "N", 1.0, at, at)
    with pytest.raises(dtt.DbcsrError, match="tile"):
        dtt.multiply("N", "N", 1.0, at, bt)
    with pytest.raises(dtt.DbcsrError):
        with torch_override(tile_size=8, mm_driver="nonsense"):
            dtt.multiply("N", "N", 1.0, at, at)
    with pytest.raises(KeyError):
        dtt.set_config(nonsense=1)
    # float32: float64 stacks take the float64 kernel under every driver
    _, rt = pair("random", 15, np.float32, 8)
    with torch_override(tile_size=8, mm_driver="panel"):
        with pytest.raises(dtt.DbcsrError, match="panel-admissible"):
            dtt.build_multiply_executor("N", "N", rt, rt)
