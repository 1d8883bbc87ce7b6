"""Port parity of the sub-matrix window (``multiply(limits=...)``), ``retile``
and ``may_be_dense`` against dbcsr_tpu on the same matrices (one numpy
block description fed to both).

The window is taken over block rows, block columns, the inner dimension
and all three, under every transpose pair, with and without an existing C
(``beta`` scales the whole of C), and with ``filter_eps``. Tolerances,
relative to the largest reference entry, as in ``test_torch_engine.py``:
float64 1e-12 (the same float64 products summed in another order; the JAX
side runs native float64), float32 2e-5 (IEEE float32 on both sides).
``retile`` is a gather, so its stores are compared bitwise.
"""
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.errors import DbcsrError

torch.set_num_threads(1)

RTOL = {np.float64: 1e-12, np.float32: 2e-5}
CASES = [(8, np.float64), (16, np.float32)]
TRANS = [("N", "N"), ("N", "T"), ("T", "N"), ("T", "T")]
#: block rows of op(A) (M), of the inner dimension (K) and of op(B)'s columns (N)
NM, NK, NN = 23, 19, 21


def both(tile, **kw):
    es = ExitStack()
    es.enter_context(jax_override(f64_method="native", tile_size=tile, **kw))
    es.enter_context(torch_override(tile_size=tile, **kw))
    return es


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def sizes(n, seed):
    return np.random.default_rng(seed).choice([2, 3, 5], n).astype(np.int32)


def pair(rbs, cbs, occ, seed, dtype, tile, sym="N"):
    """The same random matrix in both packages (symmetric: upper triangle)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((len(rbs), len(cbs))) < occ
    if sym != "N":
        mask = np.triu(mask)
    rows, cols = np.nonzero(mask)
    blocks = []
    for r, c in zip(rows, cols):
        blk = rng.standard_normal((rbs[r], cbs[c]))
        if sym != "N" and r == c:
            blk = 0.5 * (blk + blk.T)
        blocks.append(blk.astype(dtype))
    with both(tile):
        mj = djax.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, cbs, dtype=dtype, sym=sym)
        mt = dtt.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, cbs, dtype=dtype,
                                        sym=sym, device="cpu")
    return mj, mt


def operands(ta, tb, dtype, tile, seed):
    m_bs, k_bs, n_bs = sizes(NM, 1), sizes(NK, 2), sizes(NN, 3)
    a = pair(k_bs if ta == "T" else m_bs, m_bs if ta == "T" else k_bs, 0.3, seed,
             dtype, tile)
    b = pair(n_bs if tb == "T" else k_bs, k_bs if tb == "T" else n_bs, 0.3, seed + 1,
             dtype, tile)
    c = pair(m_bs, n_bs, 0.25, seed + 2, dtype, tile)
    return a, b, c


def dense(m):
    return m.to_dense().numpy() if isinstance(m.data, torch.Tensor) else np.asarray(m.to_dense())


def same(rj, rt, dtype, what):
    np.testing.assert_array_equal(rj.index.row_ptr, rt.index.row_ptr, err_msg=what)
    np.testing.assert_array_equal(rj.index.col_idx, rt.index.col_idx, err_msg=what)
    assert rt.name == rj.name, what
    assert rel_err(dense(rt), dense(rj)) <= RTOL[dtype], what


LIMITS = {
    "rows": {"rows": (4, 15)},
    "cols": {"cols": (0, 9)},
    "k": {"k": (6, 19)},
    "all": {"rows": (5, 23), "cols": (3, 17), "k": (2, 11)},
}


@pytest.mark.parametrize("tile,dtype", CASES)
@pytest.mark.parametrize("ta,tb", TRANS)
@pytest.mark.parametrize("which", list(LIMITS))
def test_limits_match_jax(which, ta, tb, tile, dtype):
    (aj, at), (bj, bt), (cj, ct) = operands(ta, tb, dtype, tile, seed=10)
    lim = LIMITS[which]
    with both(tile, matmul_precision="highest"):
        for alpha, beta, use_c, eps in ((2.0, 0.0, False, 0.3), (0.5, -2.0, True, None)):
            kw = dict(limits=lim, filter_eps=eps, return_flops=True)
            rj, fj = djax.multiply(ta, tb, alpha, aj, bj, beta, cj if use_c else None, **kw)
            rt, ft = dtt.multiply(ta, tb, alpha, at, bt, beta, ct if use_c else None, **kw)
            what = f"{which} {ta}{tb} alpha={alpha} beta={beta} c={use_c} eps={eps}"
            assert fj == ft, what
            assert rt.dtype == at.dtype and rt.tile == tile
            same(rj, rt, dtype, what)


@pytest.mark.parametrize("tile,dtype", CASES)
def test_limits_window_is_the_full_product_there(tile, dtype):
    """Inside the window the blocks are the full product's; outside it C is
    ``beta·C``."""
    (aj, at), (bj, bt), (cj, ct) = operands("N", "N", dtype, tile, seed=20)
    r0, r1, c0, c1 = 3, 17, 2, 12
    with both(tile, matmul_precision="highest"):
        full = dense(dtt.multiply("N", "N", 1.0, at, bt, 0.5, ct))
        win = dense(dtt.multiply("N", "N", 1.0, at, bt, 0.5, ct,
                                 limits={"rows": (r0, r1), "cols": (c0, c1)}))
    ro, co = at.index.row_offsets, bt.index.col_offsets
    inside = np.zeros(full.shape, bool)
    inside[ro[r0]:ro[r1], co[c0]:co[c1]] = True
    assert rel_err(win[inside], full[inside]) <= RTOL[dtype]
    np.testing.assert_array_equal(win[~inside], (0.5 * dense(ct))[~inside])


def test_limits_symmetric_operand_matches_jax():
    m_bs = sizes(NM, 1)
    aj, at = pair(m_bs, m_bs, 0.3, 30, np.float64, 8, sym="S")
    bj, bt = pair(m_bs, m_bs, 0.3, 31, np.float64, 8)
    lim = {"rows": (2, 20), "k": (5, 23)}
    with both(8):
        same(djax.multiply("N", "N", 1.0, aj, bj, limits=lim),
             dtt.multiply("N", "N", 1.0, at, bt, limits=lim), np.float64, "sym A")


@pytest.mark.parametrize("bad", [{"rows": (5, 2)}, {"cols": (0, NN + 1)}, {"k": (-1, 3)}])
def test_limits_bad_range_asserts(bad):
    (_, at), (_, bt), _ = operands("N", "N", np.float64, 8, seed=40)
    with torch_override(tile_size=8), pytest.raises(DbcsrError, match="limits"):
        dtt.multiply("N", "N", 1.0, at, bt, limits=bad)


def test_limits_still_refuse_dist_and_complex():
    (_, at), (_, bt), _ = operands("N", "N", np.float64, 8, seed=41)
    from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist

    d = block_cyclic_dist(ProcessGrid.make(2, 2, devices=["cpu"] * 4), at.nblkrows,
                          bt.nblkcols)
    with torch_override(tile_size=8):
        # dist is ported since: a full window runs over the grid; a window
        # that compacts the operands leaves the distribution's maps too long
        # for them and still raises, in both packages (ROADMAP Queue 3)
        full = {"rows": (0, at.nblkrows)}
        got = dtt.multiply("N", "N", 1.0, at, bt, limits=full, dist=d)
        ref = dtt.multiply("N", "N", 1.0, at, bt, limits=full)
        assert torch.allclose(got.data, ref.data, rtol=1e-12, atol=1e-12)
        with pytest.raises(ValueError):
            dtt.multiply("N", "N", 1.0, at, bt, limits={"rows": (0, 2)}, dist=d)
        # complex is ported since: the window of a complex product is the
        # window of the real one (the data here is real)
        ac = at.with_data(at.data.to(torch.complex128))
        bc = bt.with_data(bt.data.to(torch.complex128))
        got = dtt.multiply("N", "N", 1.0, ac, bc, limits={"rows": (0, 2)})
        ref = dtt.multiply("N", "N", 1.0, at, bt, limits={"rows": (0, 2)})
        assert got.dtype == torch.complex128
        assert np.array_equal(got.index.col_idx, ref.index.col_idx)
        assert torch.allclose(got.data.real, ref.data, rtol=1e-12, atol=1e-12)
        assert not got.data.imag.any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sym", ["N", "S"])
def test_retile_matches_jax_bitwise(sym, dtype):
    rbs = sizes(NM, 5)
    mj, mt = pair(rbs, rbs, 0.35, 50, dtype, 8, sym=sym)
    for t in (16, 32, 8, 32, 16, 8):
        with both(8):
            mj, mt = djax.retile(mj, t), dtt.retile(mt, t)
        assert mt.tile == t and mt.sym == sym
        np.testing.assert_array_equal(mt.data.numpy(), np.asarray(mj.data))
        dtt.verify_matrix(mt)
    _, orig = pair(rbs, rbs, 0.35, 50, dtype, 8, sym=sym)
    assert torch.equal(mt.data, orig.data)
    assert dtt.retile(mt, 8) is mt


def test_retile_bf16_round_trip():
    rbs = sizes(NM, 6)
    _, mt = pair(rbs, rbs, 0.35, 51, np.float32, 16)
    m16 = mt.astype(torch.bfloat16)
    back = dtt.retile(dtt.retile(m16, 32), 16)
    assert back.dtype == torch.bfloat16 and torch.equal(back.data, m16.data)


@pytest.mark.parametrize("occ", [0.1, 0.45, 0.9, 1.0])
@pytest.mark.parametrize("sym", ["N", "S"])
def test_may_be_dense_matches_jax(occ, sym):
    rbs = sizes(NM, 7)
    mj, mt = pair(rbs, rbs, occ, 60, np.float64, 8, sym=sym)
    for threshold in (0.2, 0.5, 0.8):
        assert dtt.may_be_dense(mt, threshold) == djax.ops.transform.may_be_dense(
            mj, threshold)
    assert dtt.may_be_dense(mt) == djax.ops.transform.may_be_dense(mj)


def test_native_layout_past_2_24_cells_matches_numpy():
    """The port's native store layout takes a grid past 2^24 cells while its
    scratch stays within four cells per stored element (retile to a small T
    at a realistic size needs it), and lays the store out as numpy does;
    past that it declines."""
    from dbcsr_tpu_torch.block.index import build_index
    from dbcsr_tpu_torch.mm.pack import tile_panel_maps
    from dbcsr_tpu_torch.native import native_available, native_grid_cap, store_layout_native

    if not native_available():
        pytest.skip("the native planner did not build (g++)")
    nb = 820
    rbs = np.full(nb, 20, np.int32)  # 16,400 rows: a 4,100² grid at T = 4
    i = np.repeat(np.arange(nb), 13)
    j = i + np.tile(np.arange(-6, 7), nb)
    keep = (j >= 0) & (j < nb)
    idx, _ = build_index(i[keep], j[keep], rbs, rbs)
    assert 4100 * 4100 > (1 << 24) and native_grid_cap(idx) >= 4100 * 4100
    coords, dest, ntr, ntc = store_layout_native(idx, 4)
    ref_dest, ref_coords, grid = tile_panel_maps(idx, 4, False)
    assert (ntr, ntc) == grid
    np.testing.assert_array_equal(coords, ref_coords)
    np.testing.assert_array_equal(dest, ref_dest)
    sparse, _ = build_index(np.arange(0, nb, 41), np.arange(0, nb, 41), rbs, rbs)
    assert store_layout_native(sparse, 4) is None  # 8,000 elements on 16.8 M cells


@pytest.mark.parametrize("tile,dtype", CASES)
def test_limits_expansion_is_cached_per_window_pattern(tile, dtype):
    """A second window over the same patterns reuses the expanded index and
    its device gather from the plan cache; new data gives the new product
    (2·A gives twice the window product, bit for bit)."""
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    (_, at), (_, bt), _ = operands("N", "N", dtype, tile, seed=70)
    lim = {"rows": (2, 19), "k": (3, 15)}
    cache = get_plan_cache()

    def expansions():
        return sum(1 for k in cache._store if k[0] == "limits_expand")

    with torch_override(tile_size=tile):
        r1 = dtt.multiply("N", "N", 1.0, at, bt, limits=lim)
        n = expansions()
        r2 = dtt.multiply("N", "N", 1.0, at.with_data(2 * at.data), bt, limits=lim)
    assert n >= 1 and expansions() == n
    assert r2.index is r1.index and torch.equal(r2.data, 2 * r1.data)
