"""Port parity, the sharded at-rest form: ``ShardLayout`` and the shard
stores (``dist/sharded.py``), the sharded executors, ``sharded_multiply``
and every sharded op of ``dist/sharded_ops.py``, and checkpoints written
by one package and read by the other; against dbcsr_tpu on the 8-device
virtual CPU mesh of ``tests/conftest.py``, the port on ``cpu`` ranks.

The JAX package's sharded array ``[ndev, n_max, T, T]`` is the port's list
of rank shards stacked. Layout maps, shard stores, patterns and moved data
must be identical; products agree within 1e-12 of the largest reference
entry in float64/complex128 (the JAX side at ``f64_method="native"``) and
1e-5 in float32; reductions within 1e-12 (float64, summed in rank order
where the JAX package's psum picks its own) and block norms (float32, as
the reference keeps them) within 1e-6.
"""
import os
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
import dbcsr_tpu.dist as jdist
import dbcsr_tpu.dist.sharded as jsharded
from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.mm.engine import build_distributed_executor as jax_build_dist

import dbcsr_tpu_torch as dtt
import dbcsr_tpu_torch.dist as tdist
import dbcsr_tpu_torch.dist.sharded as tsharded
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.testing import (
    distribution_from_arrays,
    matrix_from_arrays,
    sharded_from_arrays,
)

torch.set_num_threads(1)

T = 8
CPU8 = [torch.device("cpu")] * 8
RTOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-5}


def both():
    es = ExitStack()
    es.enter_context(jax_override(tile_size=T, f64_method="native"))
    es.enter_context(torch_override(tile_size=T))
    return es


def gid(shape):
    return "x".join(map(str, shape))


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def carry(mj):
    return matrix_from_arrays(mj.row_block_sizes, mj.col_block_sizes,
                              mj.index.blk_rows, mj.index.col_idx,
                              np.asarray(mj.data), device="cpu", name=mj.name)


def jax_grid(shape):
    p, q, l = shape
    return jdist.ProcessGrid.make(p, q, l) if l > 1 else jdist.ProcessGrid.make(p, q)


def carry_dist(dj, shape):
    return distribution_from_arrays(dj.row_dist, dj.col_dist, shape, devices=CPU8)


def stacked(shards):
    return np.stack([s.numpy() for s in shards])


def square(rng, dtype, n=3, occ=(0.4, 0.4, 0.3), shape=(2, 2, 1)):
    """``n`` square matrices over one block structure and a tile-aligned
    distribution of it, in both packages."""
    with jax_override(tile_size=T):
        rbs = djax.random_block_sizes(60, [2, 4], rng)
        mj = [djax.random_matrix(rbs, rbs, occ[i], rng, dtype=dtype, name=f"M{i}")
              for i in range(n)]
    dj = jdist.tile_aligned_dist(jax_grid(shape), rbs, rbs, T)
    return mj, [carry(m) for m in mj], dj, carry_dist(dj, shape)


def sharded_pair(rng, dtype, shape=(2, 2, 1)):
    mj, mt, dj, dt_ = square(rng, dtype, shape=shape)
    sj = [jdist.shard_matrix(m, dj) for m in mj]
    st = [tdist.shard_matrix(m, dt_) for m in mt]
    return mj, mt, sj, st


def assert_sharded(sj, st, rtol=0.0):
    np.testing.assert_array_equal(st.index.row_ptr, sj.index.row_ptr)
    np.testing.assert_array_equal(st.index.col_idx, sj.index.col_idx)
    np.testing.assert_array_equal(st.shard.pos_of_slot, sj.shard.pos_of_slot)
    got, ref = stacked(st.data), np.asarray(sj.data)
    if rtol:
        assert rel_err(got, ref) <= rtol
    else:
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# layouts and stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 4, 1), (2, 2, 2)], ids=gid)
def test_shard_layout_and_store(rng, shape):
    mj, mt, dj, dt_ = square(rng, np.float64, n=1, shape=shape)
    slj = jsharded.shard_layout(mj[0].index, T, dj)
    slt = tsharded.shard_layout(mt[0].index, T, dt_)
    assert (slt.p, slt.q, slt.n_max, slt.ndev) == (slj.p, slj.q, slj.n_max, slj.ndev)
    for f in ("owner_of_slot", "local_of_slot", "pos_of_slot", "slot_of_pos"):
        np.testing.assert_array_equal(getattr(slt, f), getattr(slj, f))
    shards = tsharded.shard_store(mt[0], dt_)
    assert len(shards) == shape[0] * shape[1]
    np.testing.assert_array_equal(stacked(shards),
                                  np.asarray(jsharded.shard_store(mj[0], dj)))
    back = tsharded.unshard_store(shards, mt[0].index, T, dt_)
    assert torch.equal(back, mt[0].data)


def test_sharded_from_arrays(rng):
    mj, mt, sj, st = sharded_pair(rng, np.float32)
    dt_ = st[0].dist
    sm = sharded_from_arrays(mj[0].row_block_sizes, mj[0].col_block_sizes,
                             mj[0].index.blk_rows, mj[0].index.col_idx,
                             np.asarray(sj[0].data), dt_)
    assert_sharded(sj[0], sm)
    assert torch.equal(sm.to_local().data, mt[0].data)


# ---------------------------------------------------------------------------
# the sharded executors and sharded_multiply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,algo", [((2, 2, 1), "cannon"), ((2, 4, 1), "summa"),
                                        ((2, 2, 2), "cannon"), ((2, 2, 2), "summa")],
                         ids=lambda x: gid(x) if isinstance(x, tuple) else x)
def test_sharded_executor(rng, shape, algo):
    with jax_override(tile_size=T):
        rbs = djax.random_block_sizes(60, [2, 4], rng)
        kbs = djax.random_block_sizes(48, [4], rng)
        cbs = djax.random_block_sizes(52, [2], rng)
        aj = djax.random_matrix(rbs, kbs, 0.4, rng, dtype=np.float32)
        bj = djax.random_matrix(kbs, cbs, 0.4, rng, dtype=np.float32)
    at, bt = carry(aj), carry(bj)
    dj = jdist.tile_aligned_dist(jax_grid(shape), rbs, cbs, T)
    with both():
        fj, _, _ = jax_build_dist("N", "N", aj, bj, dj, algo=algo, sharded=True)
        ft, _, _ = dtt.build_distributed_executor("N", "N", at, bt,
                                                  carry_dist(dj, shape), algo=algo,
                                                  sharded=True)
        for x in ("a", "b", "c"):
            np.testing.assert_array_equal(getattr(ft, f"shard_{x}").pos_of_slot,
                                          getattr(fj, f"shard_{x}").pos_of_slot)
        grid_t = ft.plan.grid
        outj = np.asarray(fj(jsharded.shard_store_with_layout(aj, fj.shard_a, dj.grid.mesh),
                             jsharded.shard_store_with_layout(bj, fj.shard_b, dj.grid.mesh)))
        a_sh = tsharded.shard_store_with_layout(at, ft.shard_a, grid_t)
        b_sh = tsharded.shard_store_with_layout(bt, ft.shard_b, grid_t)
        outt = ft(a_sh, b_sh)
    assert rel_err(stacked(outt), outj) <= 1e-5
    again = ft(a_sh, b_sh)
    assert all(torch.equal(x, y) for x, y in zip(again, outt))


@pytest.mark.parametrize("trans,dtype", [("TN", np.float64), ("NT", np.float64),
                                         ("CT", np.complex128)])
def test_sharded_executor_transposes(rng, trans, dtype):
    with jax_override(tile_size=T):
        rbs = djax.random_block_sizes(56, [4], rng)
        kbs = djax.random_block_sizes(48, [2, 4], rng)
        a_shape = (kbs, rbs) if trans[0] != "N" else (rbs, kbs)
        b_shape = (rbs, kbs) if trans[1] != "N" else (kbs, rbs)
        aj = djax.random_matrix(*a_shape, 0.5, rng, dtype=dtype)
        bj = djax.random_matrix(*b_shape, 0.5, rng, dtype=dtype)
    at, bt = carry(aj), carry(bj)
    dj = jdist.tile_aligned_dist(jax_grid((2, 2, 1)), rbs, rbs, T)
    with both():
        fj, _, _ = jax_build_dist(trans[0], trans[1], aj, bj, dj, sharded=True)
        ft, _, _ = dtt.build_distributed_executor(trans[0], trans[1], at, bt,
                                                  carry_dist(dj, (2, 2, 1)), sharded=True)
        outj = np.asarray(fj(jsharded.shard_store_with_layout(aj, fj.shard_a, dj.grid.mesh),
                             jsharded.shard_store_with_layout(bj, fj.shard_b, dj.grid.mesh)))
        g = ft.plan.grid
        outt = ft(tsharded.shard_store_with_layout(at, ft.shard_a, g),
                  tsharded.shard_store_with_layout(bt, ft.shard_b, g))
    assert rel_err(stacked(outt), outj) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=lambda d: d.__name__)
@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 2, 2)], ids=gid)
def test_sharded_multiply(rng, shape, dtype):
    mj, mt, sj, st = sharded_pair(rng, dtype, shape=shape)
    alpha = 2.0 + 0.5j if dtype == np.complex128 else 2.0
    with both():
        outj = jdist.sharded_multiply("N", "N", alpha, sj[0], sj[1], beta=-0.5, c=sj[2])
        outt = tdist.sharded_multiply("N", "N", alpha, st[0], st[1], beta=-0.5, c=st[2])
        again = tdist.sharded_multiply("N", "N", alpha, st[0], st[1], beta=-0.5, c=st[2])
    assert_sharded(outj, outt, rtol=RTOL[dtype])
    assert all(torch.equal(x, y) for x, y in zip(again.data, outt.data))


# ---------------------------------------------------------------------------
# elementwise, reductions, pattern changes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=lambda d: d.__name__)
def test_sharded_add_hadamard_scale(rng, dtype):
    mj, mt, sj, st = sharded_pair(rng, dtype)
    assert_sharded(jdist.sharded_add(0.5, sj[0], -2.0, sj[1]),
                   tdist.sharded_add(0.5, st[0], -2.0, st[1]), rtol=1e-15)
    assert_sharded(jdist.sharded_hadamard(sj[0], sj[1]),
                   tdist.sharded_hadamard(st[0], st[1]), rtol=1e-15)
    assert_sharded(jdist.sharded_scale(sj[0], 3.0), tdist.sharded_scale(st[0], 3.0),
                   rtol=1e-15)


@pytest.mark.parametrize("side", ["left", "right"])
def test_sharded_scale_by_vector(rng, side):
    mj, mt, sj, st = sharded_pair(rng, np.float64)
    vec = np.random.default_rng(3).standard_normal(mj[0].index.nfullrows)
    assert_sharded(jdist.sharded_scale_by_vector(sj[0], vec, side),
                   tdist.sharded_scale_by_vector(st[0], vec, side), rtol=1e-15)


@pytest.mark.parametrize("fn", ["abs", "exp", "cos"])
def test_sharded_function_of_elements(rng, fn):
    mj, mt, sj, st = sharded_pair(rng, np.float64)
    assert_sharded(jdist.sharded_function_of_elements(sj[0], fn),
                   tdist.sharded_function_of_elements(st[0], fn), rtol=1e-14)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=lambda d: d.__name__)
def test_sharded_reductions(rng, dtype):
    mj, mt, sj, st = sharded_pair(rng, dtype)
    for fj, ft, args in ((jdist.sharded_trace, tdist.sharded_trace, (0,)),
                         (jdist.sharded_dot, tdist.sharded_dot, (0, 1)),
                         (jdist.sharded_frobenius, tdist.sharded_frobenius, (0,)),
                         (jdist.sharded_maxabs, tdist.sharded_maxabs, (0,))):
        vj = fj(*(sj[i] for i in args))
        vt = ft(*(st[i] for i in args))
        assert abs(vt - vj) <= 1e-12 * max(abs(vj), 1.0), ft.__name__
    assert abs(tdist.sharded_trace(st[0]) - dtt.trace(mt[0])) <= 1e-12 * max(
        abs(dtt.trace(mt[0])), 1.0)


@pytest.mark.parametrize("shape", [(2, 2, 1), (2, 4, 1)], ids=gid)
def test_sharded_block_norms_and_filter(rng, shape):
    mj, mt, sj, st = sharded_pair(rng, np.float64, shape=shape)
    nj = jdist.sharded_block_norms(sj[0])
    nt = tdist.sharded_block_norms(st[0])
    np.testing.assert_allclose(nt, nj, rtol=1e-6)
    eps = float(np.sqrt(np.median(nj)))
    fj, ft = jdist.sharded_filter(sj[0], eps), tdist.sharded_filter(st[0], eps)
    assert ft.index.nblks < st[0].index.nblks
    assert_sharded(fj, ft)
    np.testing.assert_array_equal(ft.to_local().to_dense().numpy(),
                                  dtt.filter_blocks(mt[0], eps).to_dense().numpy())


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.complex128], ids=lambda d: d.__name__)
def test_sharded_checkpoint_across_packages(rng, tmp_path, dtype):
    mj, mt, sj, st = sharded_pair(rng, dtype)
    dj, dt_ = sj[0].dist, st[0].dist
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jdist.sharded_checkpoint_write(sj[0], pj)
    tdist.sharded_checkpoint_write(st[0], pt)
    for d in range(4):  # the shard files: byte for byte
        with open(os.path.join(pj, f"shard_{d}.npy"), "rb") as f1, \
                open(os.path.join(pt, f"shard_{d}.npy"), "rb") as f2:
            assert f1.read() == f2.read()
    zj, zt = np.load(os.path.join(pj, "index.npz")), np.load(os.path.join(pt, "index.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k])
    back_t = tdist.sharded_checkpoint_read(pj, dt_.grid)  # JAX's files, port reads
    back_j = jdist.sharded_checkpoint_read(pt, dj.grid)   # the port's, JAX reads
    assert_sharded(sj[0], back_t)
    assert_sharded(back_j, st[0])
    assert back_t.dtype == st[0].dtype and back_t.sym == st[0].sym
