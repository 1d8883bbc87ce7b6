"""Port parity, ``ops/``: block norms, matrix norms, the arithmetic of
``ops/arithmetic.py`` and the symmetric transforms, against dbcsr_tpu on
the same matrices (built in the JAX package from a seed, carried into the
port by ``matrix_from_arrays``), in float64 and float32.

Tolerances: block indices match exactly; values to 1e-12 (float64) or 1e-5
(float32) relative to the largest reference entry — the same arithmetic,
reductions (trace, dot, norms) summed in another order. ``block_norms_sq``
is float32 on both sides and matches bit for bit on data whose float32
sums are exact in any order (quarter-integers); on random data it is held
to 1e-6 relative, because XLA picks the summation order of its indicator
contractions by shape (at some shapes it equals torch's, at others not).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.testing import matrix_from_arrays

torch.set_num_threads(1)

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
T = 16


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def pair(seed, dtype, *, sym="N", tile=T, occ=0.3, n=90):
    rng = np.random.default_rng(seed)
    rbs = djax.random_block_sizes(n, [2, 3, 5, 13], np.random.default_rng(0))
    with jax_override(tile_size=tile):
        mj = djax.random_matrix(rbs, rbs, occ, rng, dtype=dtype, sym=sym)
    mt = matrix_from_arrays(rbs, rbs, mj.index.blk_rows, mj.index.col_idx,
                            np.asarray(mj.data), device="cpu", sym=mj.sym)
    return mj, mt


def assert_same(mj, mt, dtype):
    np.testing.assert_array_equal(mj.index.row_ptr, mt.index.row_ptr)
    np.testing.assert_array_equal(mj.index.col_idx, mt.index.col_idx)
    assert mj.sym == mt.sym
    assert rel_err(mt.data.numpy(), np.asarray(mj.data)) <= RTOL[dtype]


@pytest.mark.parametrize("data", ["exact", "random"])
@pytest.mark.parametrize("tile", [16, 128])
@pytest.mark.parametrize("sym", ["N", "S"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_norms_sq(dtype, sym, tile, data):
    mj, mt = pair(1, dtype, sym=sym, tile=tile)
    if data == "exact":
        from dataclasses import replace

        q = np.clip(np.round(np.asarray(mj.data) * 4) / 4, -2, 2).astype(dtype)
        mj = replace(mj, data=jnp.asarray(q))
        mt = mt.with_data(torch.from_numpy(q))
    nj, nt = np.asarray(djax.block_norms_sq(mj)), dtt.block_norms_sq(mt)
    assert nt.dtype == np.float32 and nj.dtype == np.float32
    if data == "exact":
        np.testing.assert_array_equal(nt, nj)
    else:
        assert rel_err(nt, nj) <= 1e-6
    assert dtt.block_norms_sq(mt) is nt  # memoized against the store
    assert rel_err(dtt.block_norms(mt), np.asarray(djax.block_norms(mj))) <= 1e-6


@pytest.mark.parametrize("norm", ["norm_frobenius", "norm_maxabs", "norm_column",
                                  "norm_gershgorin"])
@pytest.mark.parametrize("sym", ["N", "S", "A"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matrix_norms(dtype, sym, norm):
    mj, mt = pair(2, dtype, sym=sym)
    vj, vt = getattr(djax, norm)(mj), getattr(dtt, norm)(mt)
    # on symmetric storage both packages sum the float32 block norms of
    # the off-diagonal blocks (the reference's single-precision norms)
    tol = 1e-6 if (norm == "norm_frobenius" and sym != "N") else RTOL[dtype]
    assert isinstance(vt, float) and abs(vt - vj) <= tol * abs(vj)


@pytest.mark.parametrize("sym", ["S", "A"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_symmetric_transforms(dtype, sym):
    mj, mt = pair(3, dtype, sym=sym)
    dj, dt_ = djax.desymmetrize(mj), dtt.desymmetrize(mt)
    assert_same(dj, dt_, dtype)
    assert dt_.sym == "N"
    np.testing.assert_array_equal(dt_.to_dense().numpy(), mt.to_dense().numpy())
    from dbcsr_tpu.ops.transform import fold_symmetric as jax_fold

    assert_same(jax_fold(dj, sym), dtt.fold_symmetric(dt_, sym), dtype)
    assert_same(djax.transpose(mj), dtt.transpose(mt), dtype)
    assert_same(djax.transpose(dj), dtt.transpose(dt_), dtype)
    c = dtt.copy(mt, name="copy")
    assert c.name == "copy" and c.data is mt.data and c.sym == mt.sym


def _arith_cases(dtype):
    """(name, jax result, port result) for every op of ops/arithmetic.py."""
    aj, at = pair(4, dtype)
    bj, bt = pair(5, dtype, occ=0.2)
    sj, st = pair(6, dtype, sym="S")
    n = at.shape[0]
    vec = np.random.default_rng(7).standard_normal(n).astype(dtype)
    eps = float(np.sqrt(np.median(np.asarray(djax.block_norms_sq(aj)))))
    yield "add", djax.add(0.5, aj, -2.0, bj), dtt.add(0.5, at, -2.0, bt)
    yield "add_sym", djax.add(1.0, sj, 1.0, aj), dtt.add(1.0, st, 1.0, at)
    yield "scale", djax.scale(aj, -1.5), dtt.scale(at, -1.5)
    for side in ("left", "right"):
        yield (f"scale_by_vector_{side}", djax.scale_by_vector(aj, vec, side),
               dtt.scale_by_vector(at, vec, side))
    yield "set_value", djax.set_value(aj, 2.5), dtt.set_value(at, 2.5)
    yield "zero", djax.zero(aj), dtt.zero(at)
    yield "hadamard", djax.hadamard_product(aj, bj), dtt.hadamard_product(at, bt)
    yield "filter", djax.filter_blocks(aj, eps), dtt.filter_blocks(at, eps)
    for fn in ("inverse", "tanh", "exp", "log", "sqrt", "abs"):
        yield (f"function_{fn}", djax.function_of_elements(aj, fn),
               dtt.function_of_elements(at, fn))
    yield "block_diag", djax.get_block_diag(aj), dtt.get_block_diag(at)
    yield "triu", djax.triu(aj), dtt.triu(at)
    yield "set_diag", djax.set_diag(aj, vec), dtt.set_diag(at, vec)
    yield "add_on_diag", djax.add_on_diag(aj, 0.75), dtt.add_on_diag(at, 0.75)
    yield "crop", djax.crop(aj, (2, 9), (1, 12)), dtt.crop(at, (2, 9), (1, 12))
    yield "trace", djax.trace(sj), dtt.trace(st)
    yield "dot", djax.dot(aj, sj), dtt.dot(at, st)
    yield "get_diag", np.asarray(djax.get_diag(sj)), dtt.get_diag(st).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_arithmetic_matches_jax(dtype):
    seen = []
    for name, rj, rt in _arith_cases(dtype):
        seen.append(name)
        if isinstance(rj, float):
            assert isinstance(rt, float) and abs(rt - rj) <= RTOL[dtype] * abs(rj), name
        elif isinstance(rj, np.ndarray):
            assert rel_err(rt, rj) <= RTOL[dtype], name
        else:
            assert_same(rj, rt, dtype)
            assert rt.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype, name
    assert len(seen) == 23
    _, at = pair(4, dtype)
    # filtering keeps the store invariant: dropped blocks sharing a tile
    # with survivors are zeroed, padding stays 0
    eps = float(np.sqrt(np.median(dtt.block_norms_sq(at))))
    ft = dtt.filter_blocks(at, eps)
    assert 0 < ft.nblks < at.nblks
    assert not ft.data[dtt.block.tileops.valid_mask(ft.index, T, "cpu") == 0].any()
    assert dtt.filter_blocks(ft, eps).index is ft.index


def test_bad_arguments():
    _, at = pair(8, np.float64)
    _, other = pair(8, np.float64, n=60)
    with pytest.raises(dtt.DbcsrError):
        dtt.add(1.0, at, 1.0, other)
    with pytest.raises(dtt.DbcsrError):
        dtt.scale_by_vector(at, np.ones(at.shape[0]), "middle")
    with pytest.raises(dtt.DbcsrError):
        dtt.function_of_elements(at, "nonsense")
