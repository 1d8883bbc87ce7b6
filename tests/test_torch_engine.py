"""Port parity, the slice as a whole: ``multiply`` and
``build_multiply_executor`` of dbcsr_tpu_torch against dbcsr_tpu on the
same matrices (one numpy block description fed to both), through every
ported driver; plus the driver choice of ``auto``, the options that are not
ported yet, and the jax-free import.

On the CPU the port's stack kernels run their plain versions and the JAX
package its XLA twin. Tolerances, relative to the largest reference entry:
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
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores as jax_tile_plan

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.stats import get_stats, reset_stats
from dbcsr_tpu_torch.mm.panel import PanelPlan

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
])
def test_executor_matches_jax(driver, kind, tile, dtype):
    aj, at = pair(kind, 4, dtype, tile)
    bj, bt = pair(kind, 5, dtype, tile)
    with both(tile, matmul_precision="highest"):
        for ta, tb in (("N", "N"), ("T", "N"), ("N", "T")):
            fj, cij, ej = djax.mm.engine.build_multiply_executor(ta, tb, aj, bj, driver=driver)
            ft, cit, et = dtt.build_multiply_executor(ta, tb, at, bt, driver=driver)
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


@pytest.mark.parametrize("kind,route", [("random", "stack"), ("full", "dense")])
def test_auto_routes(kind, route):
    _, at = pair(kind, 7, np.float32, 8)
    with torch_override(tile_size=8):
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
    assert fn.plan.route == route


@pytest.mark.parametrize("driver,kind", [("dense", "random"), ("stack", "random"),
                                         ("panel", "banded")])
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
        for driver in ("auto", "stack", "panel"):
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
    "band", "grouped", "xla", "runlen", "reorder", "filter_eps", "limits",
    "dist", "k_dist", "symmetric", "complex",
])
def test_unported_options_raise(what):
    _, at = pair("random", 13, np.float64, 8)
    kw, cfg = {}, {}
    if what in ("band", "grouped", "xla"):
        cfg["mm_driver"] = what
    elif what == "runlen":
        cfg["panel_runlen"] = 2
    elif what == "reorder":
        cfg["reorder"] = "auto"
    elif what == "filter_eps":
        kw["filter_eps"] = 1e-6
    elif what == "limits":
        kw["limits"] = {"rows": (0, 1)}
    elif what in ("dist", "k_dist"):
        kw[what] = object()
    elif what == "symmetric":
        rbs = np.full(4, 3, np.int32)
        at = dtt.random_matrix(rbs, rbs, 0.5, np.random.default_rng(0),
                               dtype=np.float64, sym="S", device="cpu", tile=8)
    elif what == "complex":
        at = at.with_data(at.data.to(torch.complex128))
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
    _, rt = pair("random", 15, np.float64, 8)
    with torch_override(tile_size=8, mm_driver="panel"):
        with pytest.raises(dtt.DbcsrError, match="panel-admissible"):
            dtt.build_multiply_executor("N", "N", rt, rt)
