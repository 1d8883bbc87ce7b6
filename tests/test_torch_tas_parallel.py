"""Port parity, the rank-parallel TAS and tensor forms: ``tas_multiply_parallel``
(long_dim m, n, k, auto; contiguous and cyclic splits),
``tas_multiply_subgrid`` (every group SUMMA on a 2-D sub-grid),
``tas_multiply(dist=...)``, ``default_pgrid_dims``/``TensorPGrid`` and
``contract`` over a ``TensorPGrid``'s grid, against dbcsr_tpu on the
8-device virtual CPU mesh of ``tests/conftest.py``; the port's groups and
ranks on ``cpu`` devices.

C's block index and the effective flops must be identical; products agree
within 1e-12 of the largest reference entry in float64/complex128 (the JAX
side at ``f64_method="native"``) and 1e-5 in float32.
"""
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
import dbcsr_tpu.dist as jdist
import dbcsr_tpu.tas as jtas
import dbcsr_tpu.tensors as jten
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
import dbcsr_tpu_torch.tas as ttas
import dbcsr_tpu_torch.tensors as tten
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.core.errors import DbcsrError
from dbcsr_tpu_torch.testing import (
    distribution_from_arrays,
    matrix_from_arrays,
    tensor_from_arrays,
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


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def carry(mj):
    return matrix_from_arrays(mj.row_block_sizes, mj.col_block_sizes,
                              mj.index.blk_rows, mj.index.col_idx,
                              np.asarray(mj.data), device="cpu", name=mj.name)


def mats(rng, dtype, m=160, k=20, n=24, occ=0.4):
    with jax_override(tile_size=T):
        mbs = djax.random_block_sizes(m, [2, 3], rng)
        kbs = djax.random_block_sizes(k, [2], rng)
        nbs = djax.random_block_sizes(n, [3], rng)
        aj = djax.random_matrix(mbs, kbs, occ, rng, dtype=dtype, name="A")
        bj = djax.random_matrix(kbs, nbs, 0.7, rng, dtype=dtype, name="B")
    return aj, bj, carry(aj), carry(bj)


def assert_same(cj, ct, dtype):
    np.testing.assert_array_equal(ct.index.row_ptr, cj.index.row_ptr)
    np.testing.assert_array_equal(ct.index.col_idx, cj.index.col_idx)
    assert ct.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert rel_err(ct.to_dense().numpy(), np.asarray(cj.to_dense())) <= RTOL[dtype]


# (long_dim, shape (m, k, n) in rows)
_DIMS = {"m": (160, 20, 24), "n": (20, 24, 160), "k": (20, 160, 24),
         "auto": (24, 20, 140)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("long_dim", ["m", "n", "k", "auto"])
def test_parallel(rng, long_dim, dtype):
    m, k, n = _DIMS[long_dim]
    aj, bj, at, bt = mats(rng, dtype, m, k, n)
    with both():
        cj, fj = jtas.tas_multiply_parallel(aj, bj, long_dim=long_dim, nsplit=4,
                                            return_flops=True)
        ct, ft = ttas.tas_multiply_parallel(at, bt, long_dim=long_dim, nsplit=4,
                                            devices=CPU8, return_flops=True)
    assert_same(cj, ct, dtype)
    assert ft == fj


@pytest.mark.parametrize("long_dim", ["m", "k"])
def test_parallel_cyclic_complex(rng, long_dim):
    m, k, n = _DIMS[long_dim]
    aj, bj, at, bt = mats(rng, np.complex128, m, k, n)
    with both():
        cj = jtas.tas_multiply_parallel(aj, bj, long_dim=long_dim, nsplit=3,
                                        split_kind="cyclic")
        ct = ttas.tas_multiply_parallel(at, bt, long_dim=long_dim, nsplit=3,
                                        split_kind="cyclic", devices=CPU8)
    assert_same(cj, ct, np.complex128)


def test_parallel_default_devices_need_cuda(rng, monkeypatch):
    _, _, at, bt = mats(rng, np.float64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DbcsrError, match="no CUDA device"):
        ttas.tas_multiply_parallel(at, bt, nsplit=2)


@pytest.mark.parametrize("long_dim,nsplit,p,q", [("m", 2, 2, 2), ("n", 2, 2, 2),
                                                  ("m", 4, 1, 2)])
def test_subgrid(rng, long_dim, nsplit, p, q):
    m, k, n = (160, 24, 20) if long_dim == "m" else (20, 24, 160)
    aj, bj, at, bt = mats(rng, np.float64, m, k, n)
    with both():
        cj, fj = jtas.tas_multiply_subgrid(aj, bj, long_dim=long_dim, nsplit=nsplit,
                                           subgrid=(p, q), return_flops=True)
        ct, ft = ttas.tas_multiply_subgrid(at, bt, long_dim=long_dim, nsplit=nsplit,
                                           subgrid=(p, q), devices=CPU8,
                                           return_flops=True)
    assert_same(cj, ct, np.float64)
    assert ft == fj


def test_tas_multiply_over_dist(rng):
    """``tas_multiply(dist=...)`` reaches ``multiply`` over the grid (one
    group: a group of a split is a compacted matrix the distribution's maps
    no longer fit, in both packages)."""
    with jax_override(tile_size=T):
        rbs = djax.random_block_sizes(60, [2, 4], rng)
        aj = djax.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64)
        bj = djax.random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64)
    at, bt = carry(aj), carry(bj)
    dj = jdist.tile_aligned_dist(jdist.ProcessGrid.make(2, 2), rbs, rbs, T)
    dt_ = distribution_from_arrays(dj.row_dist, dj.col_dist, (2, 2), devices=CPU8)
    with both():
        cj = jtas.tas_multiply("N", "N", 1.0, aj, bj, nsplit=1, dist=dj).matrix
        ct = ttas.tas_multiply("N", "N", 1.0, at, bt, nsplit=1, dist=dt_).matrix
    assert_same(cj, ct, np.float64)


def test_pgrid():
    for n, nd in ((8, 3), (12, 2), (1, 4), (6, 3), (16, 2)):
        assert tten.default_pgrid_dims(n, nd) == jten.default_pgrid_dims(n, nd)
    pj = jten.TensorPGrid.make(3)
    pt = tten.TensorPGrid.make(3, devices=CPU8)
    assert pt.dims == pj.dims and pt.ndim == 3
    assert pt.mapping.map1 == pj.mapping.map1 and pt.mapping.map2 == pj.mapping.map2
    assert pt.grid.shape == (pj.grid.nprow, pj.grid.npcol)
    with pytest.raises(DbcsrError):
        tten.TensorPGrid(dims=(2, 2, 2), mapping=pt.mapping,
                         grid=dtt.dist.ProcessGrid.make(2, 2, devices=CPU8))


def _tensors(rng, dtype):
    bs_i = np.asarray([4] * 12, np.int32)
    bs_j = np.asarray([4] * 3, np.int32)
    bs_k = np.asarray([4] * 10, np.int32)
    bs_l = np.asarray([4] * 8, np.int32)
    with jax_override(tile_size=T):
        tb = jten.TensorBuilder([bs_i, bs_j, bs_k], jten.NDMapping(3, (0, 1), (2,)),
                                dtype=dtype)
        for bi in np.ndindex(12, 3, 10):
            if rng.random() < 0.2:
                tb.put_block(bi, rng.standard_normal((4, 4, 4)).astype(dtype))
        mb = jten.TensorBuilder([bs_k, bs_l], dtype=dtype)
        for bi in np.ndindex(10, 8):
            if rng.random() < 0.5:
                mb.put_block(bi, rng.standard_normal((4, 4)).astype(dtype))
        tj, mj = tb.finalize(), mb.finalize()

    def carry_t(x):
        return tensor_from_arrays(x.block_sizes, x.mapping.map1, x.mapping.map2,
                                  x.matrix.index.blk_rows, x.matrix.index.col_idx,
                                  x.matrix.flat_host(), dtype=dtype, device="cpu",
                                  tile=T)

    return tj, mj, carry_t(tj), carry_t(mj), bs_l


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("dims", [(2, 2, 1), (2, 2, 2)], ids=lambda d: "x".join(map(str, d)))
def test_contract_over_pgrid(rng, dims, dtype):
    """contract(dist=...) with the grid of a TensorPGrid: the tensor
    contraction's folded product over the pgrid's 2-D grid (Cannon on 2×2,
    SUMMA on 2×4), as ``tests/test_contract_distributed.py`` drives it."""
    tj, mj, tt, mt, bs_l = _tensors(rng, dtype)
    pj = jten.TensorPGrid.make(3, dims=dims)
    pt = tten.TensorPGrid.make(3, dims=dims, devices=CPU8)
    rows = tj.matrix.index.row_block_sizes
    dj = jdist.tile_aligned_dist(pj.grid, rows, bs_l, T)
    dt_ = dtt.dist.tile_aligned_dist(pt.grid, rows, bs_l, T)
    kw = dict(contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,),
              notcontract_2=(1,), nsplit=1)
    with both():
        cj = jten.contract(1.0, tj, mj, dist=dj, **kw)
        ct = tten.contract(1.0, tt, mt, dist=dt_, **kw)
    assert_same(cj.matrix, ct.matrix, dtype)
    ref = np.einsum("ijk,kl->ijl", np.asarray(tj.to_dense()), np.asarray(mj.to_dense()))
    assert rel_err(ct.to_dense().numpy(), ref) <= RTOL[dtype]


@pytest.mark.parametrize("long_dim", ["m", "k"])
def test_parallel_structurally_zero_tiles(long_dim):
    """A tridiagonal band of 5/13/23-blocks at T = 16: some tile products
    meet in tiles no block pair reaches. The JAX package asserts there are
    none (``dbcsr_tpu/tas/parallel.py``, m/n split) and raises; the port
    drops those tiles and matches the dense product (``long_dim='k'``
    drops them from the union C pattern the same way)."""
    rng = np.random.default_rng(0)
    tile = 16
    rbs = rng.choice([5, 13, 23], 40).astype(np.int32)
    n = len(rbs)
    i = np.repeat(np.arange(n), 3)
    j = i + np.tile(np.arange(-1, 2), n)
    keep = (j >= 0) & (j < n)
    blocks = [rng.standard_normal((rbs[r], rbs[c])) for r, c in zip(i[keep], j[keep])]
    with jax_override(tile_size=tile, f64_method="native"):
        aj = djax.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs)
        if long_dim == "m":
            with pytest.raises(djax.DbcsrError, match="group product tiles"):
                jtas.tas_multiply_parallel(aj, aj, long_dim="m", nsplit=2)
    at = carry(aj)
    with torch_override(tile_size=tile):
        ct = ttas.tas_multiply_parallel(at, at, long_dim=long_dim, nsplit=2, devices=CPU8)
    dense = np.asarray(aj.to_dense())
    assert rel_err(ct.to_dense().numpy(), dense @ dense) <= 1e-12
