"""Port parity, eps-filtering: the one-shot ``multiply(filter_eps=...)``
and the plan-once ``build_filtered_executor`` against dbcsr_tpu, on the
decayed banded operands of ``tests/test_filtered_exec.py`` (the SCF
density-matrix shape: off-diagonal blocks decay as exp(-0.8·|bi-bj|), so
the filter truncates the product's tail), plus symmetric operands.

Inputs are made once in the JAX package from a seed and carried into the
port (``matrix_from_arrays``). Kept patterns must be identical; values on
kept blocks agree to 1e-12 in float64 (the JAX side at
``f64_method="native"``: both sum the same float64 products in another
order) and to 1e-5 relative in float32 (IEEE float32 on both sides).
"""
from contextlib import ExitStack
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dbcsr_tpu as djax
from dbcsr_tpu.block.tileops import coord_mask
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.testing import matrix_from_arrays

torch.set_num_threads(1)

T = 16
EPS = 3e-2
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def both(**kw):
    es = ExitStack()
    es.enter_context(jax_override(tile_size=T, f64_method="native", **kw))
    es.enter_context(torch_override(tile_size=T, **kw))
    return es


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def carry(mj):
    return matrix_from_arrays(mj.row_block_sizes, mj.col_block_sizes,
                              mj.index.blk_rows, mj.index.col_idx,
                              np.asarray(mj.data), device="cpu", sym=mj.sym)


def decayed_pair(seed, dtype, n=60, sym="N"):
    """Operands of tests/test_filtered_exec.py:_decayed_pair, in both
    packages."""
    rng = np.random.default_rng(seed)
    rbs = djax.random_block_sizes(n, [2, 3, 5], rng)
    offs = jnp.asarray(np.concatenate(([0], np.cumsum(rbs.astype(np.int64)))))

    def f(r, c):
        br = jnp.searchsorted(offs, r, side="right") - 1
        bc = jnp.searchsorted(offs, c, side="right") - 1
        return jnp.exp(-0.8 * jnp.abs(br - bc).astype(jnp.float32))

    out = []
    with jax_override(tile_size=T):
        for name in ("A", "B"):
            m = djax.random_matrix(rbs, rbs, 0.5, rng, dtype=dtype, name=name, sym=sym)
            m = replace(m, data=m.data * coord_mask(m.layout, f).astype(m.dtype))
            out.append((m, carry(m)))
    return out


def pattern(m):
    return set(zip(m.index.blk_rows.tolist(), m.index.col_idx.tolist()))


def assert_same_result(rj, rt, dtype):
    assert pattern(rt) == pattern(rj)
    np.testing.assert_array_equal(rt.index.col_idx, rj.index.col_idx)
    assert rel_err(rt.to_dense().numpy(), np.asarray(rj.to_dense())) <= RTOL[dtype]


@pytest.mark.parametrize("filter_mode", ["sum", "exact"])
@pytest.mark.parametrize("per_row_eps", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_one_shot_matches_jax(dtype, per_row_eps, filter_mode):
    (aj, at), (bj, bt) = decayed_pair(1, dtype)
    with both(per_row_eps=per_row_eps, filter_mode=filter_mode):
        for ta, tb in (("N", "N"), ("T", "N"), ("N", "T")):
            rj, fj = djax.multiply(ta, tb, 1.0, aj, bj, filter_eps=EPS, return_flops=True)
            rt, ft = dtt.multiply(ta, tb, 1.0, at, bt, filter_eps=EPS, return_flops=True)
            assert_same_result(rj, rt, dtype)
            assert ft == fj
            unfiltered = dtt.multiply(ta, tb, 1.0, at, bt)
            assert 0 < rt.nblks < unfiltered.nblks  # the filter truncated
            # every kept block clears eps
            assert dtt.block_norms_sq(rt).min() >= np.float32(EPS) ** 2
        # alpha/beta with an existing C, and retain_sparsity (no final filter)
        for kw in ({}, {"retain_sparsity": True}):
            rj = djax.multiply("N", "N", 0.5, aj, bj, -1.0, aj, filter_eps=EPS, **kw)
            rt = dtt.multiply("N", "N", 0.5, at, bt, -1.0, at, filter_eps=EPS, **kw)
            assert_same_result(rj, rt, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_executor_matches_jax(dtype):
    """Same keep mask and values as the JAX executor, step after step with
    data that varies (which blocks clear eps changes) and no replan; the
    compacted result equals the one-shot filtered multiply."""
    (aj, at), (bj, bt) = decayed_pair(2, dtype)
    with both():
        exj = djax.build_filtered_executor("N", "N", aj, bj, EPS)
        ext = dtt.build_filtered_executor("N", "N", at, bt, EPS)
        np.testing.assert_array_equal(ext.c_index.col_idx, exj.c_index.col_idx)
        assert ext.eff_flops == exj.eff_flops
        keeps = []
        for scale in (1.0, 0.31, 4.0):
            a_j = replace(aj, data=aj.data * np.asarray(scale, dtype))
            a_t = at.with_data(at.data * torch.tensor(scale, dtype=at.dtype))
            cj, kj, nj = exj.step(a_j.data, bj.data)
            ct, kt, nt = ext.step(a_t.data, bt.data)
            assert kt.dtype == torch.float32 and nt.dtype == torch.float32
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            assert rel_err(nt.numpy(), np.asarray(nj)) <= 1e-6  # float32 norms
            assert rel_err(ct.numpy(), np.asarray(cj)) <= RTOL[dtype]
            assert ext.kept_flops(kt) == exj.kept_flops(kj)
            got = ext.compact(ct, kt)
            assert_same_result(djax.multiply("N", "N", 1.0, a_j, bj, filter_eps=EPS), got, dtype)
            assert_same_result(exj.compact(cj, kj), got, dtype)
            keeps.append(kt.numpy().astype(bool))
        assert not np.array_equal(keeps[0], keeps[1])
        assert not np.array_equal(keeps[0], keeps[2])
    with pytest.raises(dtt.DbcsrError):
        dtt.build_filtered_executor("N", "N", at, bt, 0.0)


@pytest.mark.parametrize("filtered", [False, True])
def test_symmetric_operands(filtered):
    """Symmetric A, B and C through multiply, against the JAX package and
    against the same product of the expanded matrices; the result for a
    symmetric C is folded back into symmetric storage."""
    dtype = np.float64
    (aj, at), (bj, bt) = decayed_pair(3, dtype, sym="S")
    eps = EPS if filtered else None
    with both():
        for c_j, c_t in ((None, None), (bj, bt)):
            rj = djax.multiply("N", "N", 1.0, aj, aj, 1.0, c_j, filter_eps=eps)
            rt = dtt.multiply("N", "N", 1.0, at, at, 1.0, c_t, filter_eps=eps)
            assert rt.sym == rj.sym == ("S" if c_t is not None else "N")
            assert_same_result(rj, rt, dtype)
        full = dtt.multiply("N", "N", 1.0, dtt.desymmetrize(at), dtt.desymmetrize(bt),
                            filter_eps=eps)
        sym = dtt.multiply("N", "N", 1.0, at, bt, filter_eps=eps)
        assert torch.equal(sym.data, full.data)
        # the executor counts flops on the expanded pattern (the JAX package
        # reads the stored triangle there and undercounts)
        ex = dtt.build_filtered_executor("N", "N", at, bt, EPS)
        assert ex.kept_flops(np.ones(ex.c_index.nblks)) == ex.eff_flops
        exj = djax.build_filtered_executor("N", "N", aj, bj, EPS)
        assert ex.eff_flops == exj.eff_flops
        assert exj.kept_flops(np.ones(exj.c_index.nblks)) < exj.eff_flops
