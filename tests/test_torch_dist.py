"""Port parity, the distributed multiply: process grids, distributions, the
Cannon plans (tile-granular and element-granular), SUMMA and 2.5D,
``multiply(dist=...)`` and ``build_distributed_executor``, against
dbcsr_tpu on the 8-device virtual CPU mesh of ``tests/conftest.py``.

One numpy description reaches both packages: matrices are built in the JAX
package from a seed and carried over by ``matrix_from_arrays``, a
distribution by its ``row_dist``/``col_dist`` vectors and the grid's shape
(``distribution_from_arrays``, over ``cpu`` ranks). Plan arrays (the
stacks with their trash rows dropped, pack and unpack maps) and the
``record_comm`` message counts must be identical. Products agree within
1e-12 of the largest reference entry in float64/complex128 (the JAX side
at ``f64_method="native"``) and 1e-5 in float32: the same tile products,
summed per tick in another order.
"""
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
import dbcsr_tpu.core.stats as jstats
import dbcsr_tpu.dist as jdist
import dbcsr_tpu.mm.cannon as jcannon
import dbcsr_tpu.mm.summa as jsumma
from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.mm.engine import build_distributed_executor as jax_build_dist

import dbcsr_tpu_torch as dtt
import dbcsr_tpu_torch.core.stats as tstats
import dbcsr_tpu_torch.dist as tdist
import dbcsr_tpu_torch.mm.cannon as tcannon
import dbcsr_tpu_torch.mm.summa as tsumma
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.errors import DbcsrError
from dbcsr_tpu_torch.mm.cannon import RankPlan
from dbcsr_tpu_torch.testing import distribution_from_arrays, matrix_from_arrays

torch.set_num_threads(1)

T = 8
CPU8 = [torch.device("cpu")] * 8
RTOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-5}
GRIDS = [(1, 1, 1), (2, 2, 1), (2, 2, 2), (2, 3, 1), (2, 4, 1)]
DTYPES = [np.float32, np.float64, np.complex128]


def both(**kw):
    es = ExitStack()
    es.enter_context(jax_override(tile_size=T, f64_method="native", **kw))
    es.enter_context(torch_override(tile_size=T, **kw))
    return es


def gid(shape):
    return "x".join(map(str, shape))


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def carry(mj):
    return matrix_from_arrays(
        mj.row_block_sizes, mj.col_block_sizes, mj.index.blk_rows,
        mj.index.col_idx, np.asarray(mj.data), device="cpu", name=mj.name,
    )


def jax_grid(shape):
    p, q, l = shape
    return jdist.ProcessGrid.make(p, q, l) if l > 1 else jdist.ProcessGrid.make(p, q)


def carry_dist(dj, shape):
    return distribution_from_arrays(dj.row_dist, dj.col_dist, shape, devices=CPU8)


def sizes(rng):
    rbs = djax.random_block_sizes(44, [3, 5], rng)
    kbs = djax.random_block_sizes(40, [2, 4], rng)
    cbs = djax.random_block_sizes(36, [2, 6], rng)
    return rbs, kbs, cbs


def mats(rng, dtype, shapes, occ=0.35):
    out = []
    with jax_override(tile_size=T):
        for i, (r, c) in enumerate(shapes):
            mj = djax.random_matrix(r, c, occ, rng, dtype=dtype, name=f"M{i}")
            out.append((mj, carry(mj)))
    return out


def assert_product(cj, ct, dtype):
    np.testing.assert_array_equal(cj.index.row_ptr, ct.index.row_ptr)
    np.testing.assert_array_equal(cj.index.col_idx, ct.index.col_idx)
    assert rel_err(ct.to_dense().numpy(), np.asarray(cj.to_dense())) <= RTOL[dtype]


def reset_stats():
    jstats.reset_stats()
    tstats.reset_stats()


def comm(stats_mod):
    return {k: (c, round(b)) for k, (c, b) in stats_mod.get_stats().comm_msgs.items()}


# ---------------------------------------------------------------------------
# grids and distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", GRIDS, ids=gid)
def test_grid_shape(shape):
    gj, gt = jax_grid(shape), tdist.ProcessGrid.make(*shape, devices=CPU8)
    assert (gt.nprow, gt.npcol, gt.nlayer, gt.size) == (gj.nprow, gj.npcol, gj.nlayer,
                                                         gj.size)
    assert tdist.AXIS_ROW == jdist.AXIS_ROW and tdist.AXIS_LAYER == jdist.AXIS_LAYER
    tj, tt = gj.transposed(), gt.transposed()
    assert (tt.nprow, tt.npcol, tt.nlayer) == (tj.nprow, tj.npcol, tj.nlayer)
    assert gt.ranks()[0] == (0, 0, 0) and len(gt.ranks()) == gt.size
    assert all(d == torch.device("cpu") for d in gt.devices.flat)
    assert gt.plane().shape == (shape[0], shape[1])


def test_grid_needs_a_device(monkeypatch):
    """No devices= and no CUDA device: the grid raises, it never drops to
    the CPU; with devices= it is built; square() takes the largest square."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DbcsrError, match="no CUDA device"):
        tdist.ProcessGrid.make(2, 2)
    with pytest.raises(DbcsrError):
        tdist.ProcessGrid.square()
    with pytest.raises(DbcsrError):
        tdist.ProcessGrid.make(2, 2, devices=CPU8[:3])
    assert tdist.ProcessGrid.square(devices=CPU8).shape == (2, 2)


def test_distribution_helpers(rng):
    rbs, kbs, cbs = sizes(rng)
    np.testing.assert_array_equal(tdist.tile_dist_vector(rbs, 3, T),
                                  jdist.tile_dist_vector(rbs, 3, T))
    for majority in (False, True):
        for vec in (jdist.tile_dist_vector(rbs, 2, T), np.arange(len(rbs)) % 2):
            bj = jdist.dist_tile_bins(vec, rbs, T, majority=majority)
            bt = tdist.dist_tile_bins(vec, rbs, T, majority=majority)
            assert (bj is None) == (bt is None)
            if bj is not None:
                np.testing.assert_array_equal(bt, bj)
    for mj, mt in zip(jdist.local_map(np.arange(len(kbs)) % 3, kbs, 3),
                      tdist.local_map(np.arange(len(kbs)) % 3, kbs, 3)):
        np.testing.assert_array_equal(mt.blocks, mj.blocks)
        np.testing.assert_array_equal(mt.elem_offset, mj.elem_offset)
        assert mt.nelems == mj.nelems
    gj, gt = jax_grid((2, 3, 1)), tdist.ProcessGrid.make(2, 3, devices=CPU8)
    for dj, dt_ in ((jdist.tile_aligned_dist(gj, rbs, cbs, T),
                     tdist.tile_aligned_dist(gt, rbs, cbs, T)),
                    (jdist.block_cyclic_dist(gj, len(rbs), len(cbs)),
                     tdist.block_cyclic_dist(gt, len(rbs), len(cbs)))):
        np.testing.assert_array_equal(dt_.row_dist, dj.row_dist)
        np.testing.assert_array_equal(dt_.col_dist, dj.col_dist)
        tj, tt = dj.transposed(), dt_.transposed()
        np.testing.assert_array_equal(tt.row_dist, tj.row_dist)
        assert tt.grid.shape == (3, 2)
    np.testing.assert_array_equal(
        dtt.random_dist_vector(50, 3, np.random.default_rng(5)),
        djax.random_dist_vector(50, 3, np.random.default_rng(5)))


# ---------------------------------------------------------------------------
# plans: identical arrays; the ranks' stacks are the plan's minus trash rows
# ---------------------------------------------------------------------------

def _plan_inputs(rng, shape):
    rbs, kbs, cbs = sizes(rng)
    (aj, at), (bj, bt) = mats(rng, np.float64, [(rbs, kbs), (kbs, cbs)])
    with jax_override(tile_size=T):
        cj = djax.multiply("N", "N", 1.0, aj, bj)  # the product's index
    gj, gt = jax_grid(shape), tdist.ProcessGrid.make(*shape, devices=CPU8)
    dj = jdist.tile_aligned_dist(gj, rbs, cbs, T)
    return (aj, at), (bj, bt), cj.index, (dj, carry_dist(dj, shape)), gt, kbs


def _check_rank_stacks(rp: RankPlan, stacks, n_c):
    """Each rank's device stack equals the plan's rows below the trash slot,
    with C slots renumbered among those it touches."""
    st = stacks.reshape(len(rp.ticks), len(rp.ticks[0]), -1, 3)
    for r, per in enumerate(rp.ticks):
        for t, ts in enumerate(per):
            rows = st[r, t][st[r, t, :, 0] < n_c]
            if ts is None:
                assert len(rows) == 0
                continue
            touched = (np.arange(n_c) if ts.touched is None
                       else ts.touched.numpy())
            c = np.repeat(np.arange(ts.stack.n_c), np.diff(ts.stack.c_ptr_host))
            np.testing.assert_array_equal(touched[c], rows[:, 0])
            np.testing.assert_array_equal(ts.stack.a_idx.numpy(), rows[:, 1])
            np.testing.assert_array_equal(ts.stack.b_idx.numpy(), rows[:, 2])
    assert rp.n_stack == int((stacks[..., 0] < n_c).sum())


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (2, 2, 2)], ids=gid)
def test_tiled_cannon_plan(rng, shape):
    (aj, at), (bj, bt), c_index, (dj, dt_), gt, kbs = _plan_inputs(rng, shape)
    with both():
        pj = jcannon._try_tiled_plan(aj, False, bj, False, c_index, dj,
                                     jdist.tile_dist_vector(kbs, shape[0], T), T, shape[2])
        pt = tcannon.plan_distributed(at, False, bt, False, c_index, dt_,
                                      tdist.tile_dist_vector(kbs, shape[0], T), "cannon",
                                      tiled=True).plan
    for f in ("p", "layers", "n_a", "n_b", "n_c", "s_max"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("a_pack", "b_pack", "stacks", "c_unpack"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    rp = RankPlan.build("cannon", gt, T, pt.n_a, pt.n_b, pt.n_c, pt.stacks)
    _check_rank_stacks(rp, pj.stacks, pj.n_c)


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 2, 2)], ids=gid)
def test_element_cannon_plan(rng, shape):
    (aj, at), (bj, bt), c_index, _, gt, kbs = _plan_inputs(rng, shape)
    gj = jax_grid(shape)
    dj = jdist.block_cyclic_dist(gj, aj.nblkrows, bj.nblkcols)
    dt_ = carry_dist(dj, shape)
    kd = np.arange(len(kbs)) % shape[0]
    pj = jcannon.plan_cannon(aj.index, False, bj.index, False, c_index, dj, kd, T)
    pt = tcannon.plan_cannon(at.index, False, bt.index, False, c_index, dt_, kd, T)
    for f in ("p", "layers", "n_a", "n_b", "n_c", "s_max"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("a_dest", "b_dest", "stacks", "c_src"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    rp = RankPlan.build("cannon", gt, T, pt.n_a, pt.n_b, pt.n_c, pt.stacks)
    _check_rank_stacks(rp, pj.stacks, pj.n_c)


@pytest.mark.parametrize("shape", [(2, 3, 1), (2, 4, 1), (2, 2, 2)], ids=gid)
def test_summa_plan(rng, shape):
    (aj, at), (bj, bt), c_index, (dj, dt_), gt, kbs = _plan_inputs(rng, shape)
    p, q, l = shape
    rowb = jdist.dist_tile_bins(dj.row_dist, aj.row_block_sizes, T, majority=True)
    colb = jdist.dist_tile_bins(dj.col_dist, bj.col_block_sizes, T, majority=True)
    kb = jdist.dist_tile_bins(jdist.tile_dist_vector(kbs, max(p, q), T), kbs, T,
                              majority=True)
    lay = djax.block.store.store_layout(c_index, T)
    args = (aj.layout.tile_coords, bj.layout.tile_coords, lay, rowb, colb, kb % q,
            kb % p, p, q, l)
    pj, pt = jsumma.plan_summa(*args), tsumma.plan_summa(*args)
    for f in ("p", "q", "n_a", "n_b", "n_c", "s_max", "layers"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("a_pack", "b_pack", "stacks", "c_unpack"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    rp = RankPlan.build("summa", gt, T, pt.n_a, pt.n_b, pt.n_c,
                        pt.stacks.reshape(p, q, l, 1, pt.s_max, 3))
    _check_rank_stacks(rp, pj.stacks, pj.n_c)
    if l == 1:
        caps = (pj.n_a + 3, pj.n_b + 1, pj.n_c + 2, pj.s_max + 5)
        qj, qt = jsumma.pad_summa_plan(pj, *caps), tsumma.pad_summa_plan(pt, *caps)
        for f in ("a_pack", "b_pack", "stacks", "c_unpack"):
            np.testing.assert_array_equal(getattr(qt, f), getattr(qj, f))


# ---------------------------------------------------------------------------
# multiply(dist=...): grids x dtypes, beta*C, comm statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("shape", GRIDS, ids=gid)
def test_multiply_dist(rng, shape, dtype):
    rbs, kbs, cbs = sizes(rng)
    (aj, at), (bj, bt), (cj, ct) = mats(rng, dtype, [(rbs, kbs), (kbs, cbs), (rbs, cbs)])
    dj = jdist.tile_aligned_dist(jax_grid(shape), rbs, cbs, T)
    dt_ = carry_dist(dj, shape)
    alpha = 0.5 - 0.25j if dtype == np.complex128 else 0.5
    reset_stats()
    with both():
        outj = djax.multiply("N", "N", alpha, aj, bj, -1.5, cj, dist=dj)
        outt = dtt.multiply("N", "N", alpha, at, bt, -1.5, ct, dist=dt_)
    assert_product(outj, outt, dtype)
    assert outt.dist is None and outj.dist is None  # C's own (none), as in JAX
    assert comm(tstats) == comm(jstats)
    assert tstats.get_stats().hardware_flops == jstats.get_stats().hardware_flops


@pytest.mark.parametrize("trans", ["TN", "NT", "CC"])
@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 4, 1)], ids=gid)
def test_multiply_dist_trans(rng, shape, trans):
    dtype = np.complex128 if "C" in trans else np.float64
    rbs, kbs, cbs = sizes(rng)
    a_shape = (kbs, rbs) if trans[0] != "N" else (rbs, kbs)
    b_shape = (cbs, kbs) if trans[1] != "N" else (kbs, cbs)
    (aj, at), (bj, bt) = mats(rng, dtype, [a_shape, b_shape])
    dj = jdist.tile_aligned_dist(jax_grid(shape), rbs, cbs, T)
    with both():
        outj = djax.multiply(trans[0], trans[1], 1.0, aj, bj, dist=dj)
        outt = dtt.multiply(trans[0], trans[1], 1.0, at, bt, dist=carry_dist(dj, shape))
    assert_product(outj, outt, dtype)


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 2, 2)], ids=gid)
def test_multiply_block_cyclic_element_plan(rng, shape):
    """A block-cyclic distribution through the element-granular plan
    (``use_tiled_cannon`` off), with ``filter_eps`` as the dryrun passes."""
    rbs, kbs, cbs = sizes(rng)
    (aj, at), (bj, bt) = mats(rng, np.float64, [(rbs, kbs), (kbs, cbs)])
    dj = jdist.block_cyclic_dist(jax_grid(shape), len(rbs), len(cbs))
    reset_stats()
    with both(use_tiled_cannon=False):
        outj = djax.multiply("N", "N", 1.0, aj, bj, dist=dj, filter_eps=1e-2)
        outt = dtt.multiply("N", "N", 1.0, at, bt, dist=carry_dist(dj, shape),
                            filter_eps=1e-2)
    assert_product(outj, outt, np.float64)
    assert comm(tstats) == comm(jstats)


def test_multiply_dist_routing(rng):
    """``mm_dist_algo``: Cannon on a non-square grid raises in both
    packages; SUMMA forced on a square grid gives the same product; the
    effective dist comes from ``c.dist``, then ``a.dist``."""
    rbs, kbs, cbs = sizes(rng)
    (aj, at), (bj, bt), (cj, ct) = mats(rng, np.float64,
                                        [(rbs, kbs), (kbs, cbs), (rbs, cbs)])
    dj = jdist.tile_aligned_dist(jax_grid((2, 3, 1)), rbs, cbs, T)
    dt_ = carry_dist(dj, (2, 3, 1))
    with both(mm_dist_algo="cannon"):
        with pytest.raises(Exception, match="square"):
            djax.multiply("N", "N", 1.0, aj, bj, dist=dj)
        with pytest.raises(DbcsrError, match="square"):
            dtt.multiply("N", "N", 1.0, at, bt, dist=dt_)
    d22 = jdist.tile_aligned_dist(jax_grid((2, 2, 1)), rbs, cbs, T)
    t22 = carry_dist(d22, (2, 2, 1))
    reset_stats()
    with both(mm_dist_algo="summa"):
        outj = djax.multiply("N", "N", 1.0, aj, bj, 1.0, djax.redistribute(cj, d22))
        outt = dtt.multiply("N", "N", 1.0, at, bt, 1.0, dtt.redistribute(ct, t22))
    assert_product(outj, outt, np.float64)
    assert outt.dist is t22 and comm(tstats) == comm(jstats)
    assert "allgather_a" in {k for k, _ in tstats.get_stats().comm_msgs}
    (sj, st), = mats(rng, np.float64, [(rbs, rbs)])
    ds = carry_dist(jdist.tile_aligned_dist(jax_grid((2, 3, 1)), rbs, rbs, T), (2, 3, 1))
    with both():
        outt2 = dtt.multiply("N", "N", 1.0, dtt.distribute(st, ds), st)
    assert outt2.dist is ds
    dense = st.to_dense().numpy()
    assert rel_err(outt2.to_dense().numpy(), dense @ dense) <= 1e-12


# ---------------------------------------------------------------------------
# build_distributed_executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("shape,algo", [((2, 2, 1), "cannon"), ((2, 4, 1), "summa"),
                                        ((2, 2, 2), "cannon"), ((2, 2, 2), "summa")],
                         ids=lambda x: gid(x) if isinstance(x, tuple) else x)
def test_distributed_executor(rng, shape, algo, dtype):
    rbs, kbs, cbs = sizes(rng)
    (aj, at), (bj, bt) = mats(rng, dtype, [(rbs, kbs), (kbs, cbs)], occ=0.4)
    dj = jdist.tile_aligned_dist(jax_grid(shape), rbs, cbs, T)
    with both():
        fj, cij, ej = jax_build_dist("N", "N", aj, bj, dj, algo=algo)
        ft, cit, et = dtt.build_distributed_executor("N", "N", at, bt,
                                                     carry_dist(dj, shape), algo=algo)
        outj = np.asarray(fj(aj.data, bj.data))
        outt = ft(at.data, bt.data)
    np.testing.assert_array_equal(cit.row_ptr, cij.row_ptr)
    np.testing.assert_array_equal(cit.col_idx, cij.col_idx)
    assert et == ej and ft.algo == algo
    assert rel_err(outt.numpy(), outj) <= RTOL[dtype]
    # reproducible: a second call is bitwise the first
    assert torch.equal(ft(at.data, bt.data), outt)
    assert ft.plan.launches == sum(ts is not None for per in ft.plan.ticks for ts in per)


def test_distributed_executor_transposes(rng):
    rbs, kbs, cbs = sizes(rng)
    (aj, at), (bj, bt) = mats(rng, np.complex128, [(kbs, rbs), (cbs, kbs)])
    dj = jdist.tile_aligned_dist(jax_grid((2, 2, 2)), rbs, cbs, T)
    with both():
        fj, _, _ = jax_build_dist("C", "T", aj, bj, dj)
        ft, _, _ = dtt.build_distributed_executor("C", "T", at, bt,
                                                  carry_dist(dj, (2, 2, 2)))
        assert rel_err(ft(at.data, bt.data).numpy(),
                       np.asarray(fj(aj.data, bj.data))) <= 1e-12


# ---------------------------------------------------------------------------
# one planner: multiply(dist=) and build_distributed_executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,trans,tile", [
    ((2, 2, 1), np.float64, "NN", 64),
    ((2, 2, 2), np.float32, "NN", T),
    ((2, 4, 1), np.float64, "NN", T),
    ((2, 2, 1), np.complex128, "TC", T),
], ids=["cannon-f64-T64", "cannon25d-f32", "summa-f64", "cannon-TC"])
def test_oneshot_and_executor_share_a_plan(rng, monkeypatch, shape, dtype, trans, tile):
    """``multiply(dist=)`` and ``build_distributed_executor`` plan through
    ``plan_distributed``: the same C store bitwise, the same rank stacks,
    K masks and flop figures; a repeated one-shot call plans nothing."""
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    made, resident = [], []
    plan_fn, resident_fn = tcannon.plan_distributed, tcannon.DistPlan.resident

    def spy_plan(*args, **kw):
        made.append(plan_fn(*args, **kw))
        return made[-1]

    def spy_resident(self, *args):
        resident.append(resident_fn(self, *args))
        return resident[-1]

    monkeypatch.setattr(tcannon, "plan_distributed", spy_plan)
    monkeypatch.setattr(tcannon.DistPlan, "resident", spy_resident)
    get_plan_cache().clear()
    p, q, _ = shape
    algo = "cannon" if p == q else "summa"
    rbs, kbs, cbs = sizes(rng)
    a_shape = (kbs, rbs) if trans[0] != "N" else (rbs, kbs)
    b_shape = (cbs, kbs) if trans[1] != "N" else (kbs, cbs)
    with torch_override(tile_size=tile, mm_dist_algo=algo):
        a = dtt.random_matrix(*a_shape, 0.2, rng, device="cpu", dtype=dtype)
        b = dtt.random_matrix(*b_shape, 0.2, rng, device="cpu", dtype=dtype)
        dist = tdist.tile_aligned_dist(tdist.ProcessGrid.make(*shape, devices=CPU8),
                                       rbs, cbs, tile)
        one = dtt.multiply(trans[0], trans[1], 1.0, a, b, dist=dist)
        again = dtt.multiply(trans[0], trans[1], 1.0, a, b, dist=dist)
        assert len(made) == 1, "a repeated one-shot call must not plan again"
        fn, c_index, _ = dtt.build_distributed_executor(trans[0], trans[1], a, b, dist)
        out = fn(a.data, b.data)
    assert len(made) == 2 and len(resident) == 2
    np.testing.assert_array_equal(one.index.row_ptr, c_index.row_ptr)
    np.testing.assert_array_equal(one.index.col_idx, c_index.col_idx)
    assert torch.equal(one.data, out) and torch.equal(again.data, out)
    d1, d2 = made
    assert d1.algo == d2.algo == fn.algo == algo and fn.dist_plan is d2
    for f in ("stacks", "rowb", "colb", "kb"):
        np.testing.assert_array_equal(getattr(d1, f), getattr(d2, f))
    masked = dtype == np.float64 and tile == 64 and algo == "cannon"
    assert (d1.chunks is not None) == masked and (d2.chunks is not None) == masked
    if masked:
        for x, y in zip(d1.chunks, d2.chunks):
            np.testing.assert_array_equal(x, y)
    r1, r2 = resident[0].plan, fn.plan
    assert r1.n_stack == r2.n_stack and (r1.n_a, r1.n_b, r1.n_c) == (r2.n_a, r2.n_b, r2.n_c)
    np.testing.assert_array_equal(r1.hw_flops, r2.hw_flops)
    np.testing.assert_array_equal(r1.padded_flops, r2.padded_flops)
    if masked:
        assert r1.hw_flops.sum() < r1.padded_flops.sum()
    for per1, per2 in zip(r1.ticks, r2.ticks):
        for t1, t2 in zip(per1, per2):
            assert (t1 is None) == (t2 is None)
            if t1 is None:
                continue
            assert (t1.touched is None) == (t2.touched is None)
            if t1.touched is not None:
                assert torch.equal(t1.touched, t2.touched)
            for f in ("c_ptr", "a_idx", "b_idx", "a_chunks", "b_chunks"):
                x, y = getattr(t1.stack, f), getattr(t2.stack, f)
                assert (x is None and y is None) or torch.equal(x, y), f


# ---------------------------------------------------------------------------
# the host API carries the distribution
# ---------------------------------------------------------------------------

def test_dist_through_host_api(rng, tmp_path):
    rbs, kbs, _ = sizes(rng)
    (aj, at), = mats(rng, np.float64, [(rbs, kbs)])
    dj = jdist.block_cyclic_dist(jax_grid((2, 3, 1)), len(rbs), len(kbs))
    dt_ = carry_dist(dj, (2, 3, 1))
    path = str(tmp_path / "a.bin")
    dtt.binary_write(at, path)
    with torch_override(tile_size=T):
        back = dtt.binary_read(path, device="cpu", dist=dt_)
    assert back.dist is dt_ and torch.equal(back.data, at.data)
    csr = dtt.to_csr(at)
    with torch_override(tile_size=T):
        assert dtt.from_csr(csr, rbs, kbs, device="cpu", dist=dt_).dist is dt_
    assert dtt.get_info(back)["distributed"] and not dtt.get_info(at)["distributed"]
    for r, c in ((0, 0), (3, 5), (len(rbs) - 1, len(kbs) - 1)):
        assert dtt.get_stored_coordinates(back, r, c) == djax.get_stored_coordinates(
            djax.redistribute(aj, dj), r, c)
    assert dtt.transpose(back).dist.grid.shape == (3, 2)
    assert dtt.replicate_all(back).dist is None
    assert dtt.ops.transform.complete_redistribute(at, dt_).dist is dt_
    s = dtt.sum_replicated([at, at, at])
    assert torch.equal(s.data, at.data * 3)
