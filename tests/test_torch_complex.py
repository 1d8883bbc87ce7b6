"""Port parity, complex matrices: complex64 and complex128 stores through the
port's entry points against dbcsr_tpu on the CPU (the JAX package
multiplies complex natively there through its XLA stack), on the same
matrices, made in the JAX package from a seed and carried across by
``matrix_from_arrays`` (or drawn in both from one seed).

Covered: the multiply in all four types and every N/T/C pair in complex,
complex ``alpha``/``beta``, mixed real × complex operands, the 'H' and 'A'
folds, ``transpose(conjugate=True)``, norms, trace, dot and add, filtering
(``filter_mode="exact"``: identical kept blocks) and the ``FilteredExecutor``
step, checkpoints both ways, CSR, ``tas_multiply``, ``contract`` and a
``.perf`` recipe of data type 7; the plain run sums keep the imaginary part,
and the conjugate transpose reaches the kernels' inputs as conjugated memory
(a lazy ``torch.conj`` view would not).

Tolerances, relative to the largest reference entry: complex64 1e-5 against
dbcsr_tpu (both sum float32 products, in other orders) and 1e-4 against a
complex128 dense host product; complex128 1e-12 against both; float32 and
float64 as in tests/test_torch_engine.py (1e-5, 1e-12). Block patterns must
match exactly.
"""
import dataclasses
import functools
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu import perf as jax_perf
from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.tas import tas_multiply as jax_tas_multiply
from dbcsr_tpu.tensors import TensorBuilder as JaxTensorBuilder
from dbcsr_tpu.tensors import contract as jax_contract

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch import perf
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.mm.c_stack import (
    tile_stack_matmul_c,
    tile_stack_matmul_c64,
    tile_stack_matmul_c128,
    tile_stack_matmul_c_plain,
)
from dbcsr_tpu_torch.mm.kernels import device_stack, run_sums_plain
from dbcsr_tpu_torch.tas import tas_multiply
from dbcsr_tpu_torch.tensors import BatchedContract, TensorBuilder, contract
from dbcsr_tpu_torch.testing import matrix_from_arrays, to_numpy

torch.set_num_threads(1)

T = 8
CPLX = [np.complex64, np.complex128]
RTOL = {np.float32: 1e-5, np.float64: 1e-12, np.complex64: 1e-5, np.complex128: 1e-12}
HOST_RTOL = {np.complex64: 1e-4, np.complex128: 1e-12}


def both(**kw):
    es = ExitStack()
    es.enter_context(jax_override(tile_size=T, **kw))
    es.enter_context(torch_override(tile_size=T, **kw))
    return es


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got.astype(np.complex128) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


def carry(mj):
    return matrix_from_arrays(mj.row_block_sizes, mj.col_block_sizes,
                              mj.index.blk_rows, mj.index.col_idx,
                              np.asarray(mj.data), device="cpu", sym=mj.sym, name=mj.name)


@functools.lru_cache(maxsize=None)
def pair(seed, dtype, *, n=60, m=None, occ=0.06, sym="N", name="M"):
    """One random matrix of ``n`` (x ``m``) block rows of 2-5 elements in
    both packages; cached, so that the tests share operands (and the JAX
    package compiles each operation once per store shape). Both are
    immutable: a test derives new matrices, it never changes these."""
    rng = np.random.default_rng(seed)
    rbs = djax.random_block_sizes(n * 3, [2, 3, 5], np.random.default_rng(0))
    cbs = rbs if m is None else djax.random_block_sizes(
        m * 3, [2, 3, 5], np.random.default_rng(1))
    with jax_override(tile_size=T):
        mj = djax.random_matrix(rbs, cbs, occ, rng, dtype=dtype, sym=sym, name=name)
    return mj, carry(mj)


def dense_j(m):
    return np.asarray(m.to_dense())


def dense_t(m):
    return to_numpy(m.to_dense())


def assert_same(rj, rt, dtype):
    np.testing.assert_array_equal(rt.index.row_ptr, rj.index.row_ptr)
    np.testing.assert_array_equal(rt.index.col_idx, rj.index.col_idx)
    assert rt.dtype == dtt.block.bcsr.torch_dtype(np.dtype(dtype))
    assert rel_err(dense_t(rt), dense_j(rj)) <= RTOL[dtype]


# ---------------------------------------------------------------------------
# matrices, random draws, the plain product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sym", ["N", "H"])
@pytest.mark.parametrize("dtype", CPLX)
def test_random_matrix_draws_as_jax(dtype, sym):
    """One seed, one matrix: the imaginary part is drawn right after the
    real part of each block, in the JAX package's order."""
    rbs = djax.random_block_sizes(60, [2, 3, 5], np.random.default_rng(0))
    with jax_override(tile_size=T):
        mj = djax.random_matrix(rbs, rbs, 0.4, np.random.default_rng(5), dtype=dtype, sym=sym)
    with torch_override(tile_size=T):
        mt = dtt.random_matrix(rbs, rbs, 0.4, np.random.default_rng(5), dtype=dtype,
                               sym=sym, device="cpu")
    assert mt.dtype == dtt.block.bcsr.torch_dtype(np.dtype(dtype))
    np.testing.assert_array_equal(mt.index.col_idx, mj.index.col_idx)
    np.testing.assert_array_equal(mt.data.numpy(), np.asarray(mj.data))
    assert np.abs(mt.data.numpy().imag).max() > 0
    np.testing.assert_array_equal(dense_t(mt), dense_j(mj))  # 'H' reflects conjugated
    if sym == "H":
        d = dense_t(mt)
        np.testing.assert_array_equal(np.triu(d, 1), np.triu(d.conj().T, 1))
        r, c = np.argwhere(np.abs(np.tril(d, -1)) > 0)[0]
        blk_r = np.searchsorted(np.cumsum(rbs), r, side="right")
        blk_c = np.searchsorted(np.cumsum(rbs), c, side="right")
        got = mt.get_block(int(blk_r), int(blk_c))
        np.testing.assert_array_equal(got, np.asarray(mj.get_block(int(blk_r), int(blk_c))))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_plain_run_sums_keep_the_imaginary_part(dtype):
    """The plain version sums complex products in their own complex type: a
    float32 accumulator would keep the real part alone."""
    rng = np.random.default_rng(3)
    stack = np.array([[0, 0, 1], [0, 1, 0], [1, 2, 2], [3, 1, 1]], dtype=np.int32)
    a = torch.from_numpy(rng.standard_normal((3, 4, 4)) + 1j * rng.standard_normal((3, 4, 4)))
    b = torch.from_numpy(rng.standard_normal((3, 4, 4)) + 1j * rng.standard_normal((3, 4, 4)))
    a, b = a.to(dtype), b.to(dtype)
    ds = device_stack(stack, 4, "cpu")
    out = tile_stack_matmul_c_plain(a, b, ds)
    ref = np.zeros((4, 4, 4), np.complex128)
    for c, ia, ib in stack:
        ref[c] += a[ia].numpy().astype(np.complex128) @ b[ib].numpy().astype(np.complex128)
    assert out.dtype == dtype and np.abs(out.numpy().imag).max() > 1.0
    assert rel_err(out.numpy(), ref) <= HOST_RTOL[np.complex64]
    assert not out[2].any()  # C tile 2 has no entry
    for wrap in (tile_stack_matmul_c, tile_stack_matmul_c64 if dtype == torch.complex64
                 else tile_stack_matmul_c128):
        assert torch.equal(wrap(a, b, ds), out)  # CPU tensors: the plain version
    raw = run_sums_plain(a, b, ds.c_ptr_host, ds.a_idx.long(), ds.b_idx.long(), dtype)
    assert torch.equal(raw, out)
    with pytest.raises(TypeError):
        tile_stack_matmul_c_plain(a.real.contiguous(), b.real.contiguous(), ds)


def test_conjugate_transpose_reaches_the_kernels_as_memory():
    """'C' hands the stack kernels op(A) = Aᴴ as conjugated MEMORY: a lazy
    ``torch.conj`` view reads as A's raw values (it cannot even be viewed as
    real), so a raw-pointer kernel given one would compute with Aᵀ where Aᴴ
    was asked for."""
    aj, at = pair(1, np.complex128, name="A")
    with both():
        fn, _, _ = dtt.build_multiply_executor("C", "N", at, at)
        assert fn.plan.route == "c_stack" and fn.plan.a_conj and not fn.plan.b_conj
        a_st, b_st = fn.plan.op_stores(at.data, at.data)
        assert not a_st.is_conj() and not b_st.is_conj()
        t_st, _ = dtt.build_multiply_executor("T", "N", at, at)[0].plan.op_stores(
            at.data, at.data)
        # the raw memory the kernel reads is the conjugate of 'T''s
        torch.testing.assert_close(torch.view_as_real(a_st),
                                   torch.view_as_real(t_st.conj_physical()), rtol=0, atol=0)
        with pytest.raises(RuntimeError):
            torch.view_as_real(t_st.conj())  # what the lazy view would have been
        got = dtt.multiply("C", "N", 1.0, at, at)
        ref = djax.multiply("C", "N", 1.0, aj, aj)
    assert_same(ref, got, np.complex128)
    d = dense_t(at)
    assert rel_err(dense_t(got), d.conj().T @ d) <= 1e-12
    assert rel_err(dense_t(got), d.T @ d) > 0.1  # Aᵀ·A is another matrix


# ---------------------------------------------------------------------------
# the multiply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_multiply_all_dtypes(dtype):
    aj, at = pair(1, dtype, name="A")
    bj, bt = pair(2, dtype, name="B")
    with both():
        rj = djax.multiply("N", "N", 1.0, aj, bj)
        rt = dtt.multiply("N", "N", 1.0, at, bt)
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, bt)
    assert_same(rj, rt, dtype)
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    assert fn.plan.route == ("c_stack" if cplx else
                             "f64_stack" if dtype == np.float64 else "stack")
    assert torch.equal(fn(at.data, bt.data), rt.data)
    if cplx:
        ref = dense_t(at).astype(np.complex128) @ dense_t(bt).astype(np.complex128)
        assert rel_err(dense_t(rt), ref) <= HOST_RTOL[dtype]


@pytest.mark.parametrize("dtype", CPLX)
def test_every_transpose_pair_with_complex_coefficients(dtype):
    aj, at = pair(1, dtype, name="A")
    bj, bt = pair(2, dtype, name="B")
    cj, ct = pair(5, dtype, name="C", occ=0.03)
    da, db, dc = (dense_t(m).astype(np.complex128) for m in (at, bt, ct))
    ops = {"N": lambda d: d, "T": lambda d: d.T, "C": lambda d: d.conj().T}
    alpha, beta = 1.0 - 0.5j, 0.25 + 1.0j
    with both():
        for ta in "NTC":
            for tb in "NTC":
                rj = djax.multiply(ta, tb, alpha, aj, bj, beta, cj)
                rt = dtt.multiply(ta, tb, alpha, at, bt, beta, ct)
                assert_same(rj, rt, dtype)
                ref = alpha * (ops[ta](da) @ ops[tb](db)) + beta * dc
                assert rel_err(dense_t(rt), ref) <= HOST_RTOL[dtype], ta + tb
                fn, c_index, _ = dtt.build_multiply_executor(ta, tb, at, bt)
                assert fn.plan.route == "c_stack"
                prod = dtt.BCSRMatrix(name="P", index=c_index, data=fn(at.data, bt.data))
                assert rel_err(dense_t(prod), ops[ta](da) @ ops[tb](db)) <= HOST_RTOL[dtype]


@pytest.mark.parametrize("driver", ["auto", "stack", "panel", "band", "grouped", "dense"])
def test_every_driver_takes_the_complex_stack(driver):
    """Each sparse driver runs the complex flat stack (the JAX package's
    native complex takes its flat stack too); the dense class stays a
    complex matmul."""
    aj, at = pair(1, np.complex128, name="A")
    bj, bt = pair(2, np.complex128, name="B")
    with both():
        rj = djax.multiply("N", "T", 0.5j, aj, bj)
    with torch_override(tile_size=T, mm_driver=driver, panel_runlen=4):
        rt = dtt.multiply("N", "T", 0.5j, at, bt)
        fn, _, _ = dtt.build_multiply_executor("N", "T", at, bt)
    assert_same(rj, rt, np.complex128)
    assert fn.plan.route == ("dense" if driver == "dense" else "c_stack")


@pytest.mark.parametrize("order", ["complex_real", "real_complex"])
def test_mixed_real_and_complex_operands_promote(order):
    """A real and a complex operand multiply in the promoted complex type.
    Complex A times real B matches dbcsr_tpu's CPU path; for real A times
    complex B that path keeps A's real type and drops the imaginary part,
    so the port is held to the dense product there."""
    cj, ct = pair(1, np.complex128, name="A")
    rj, rt = pair(2, np.float64, name="B")
    (aj, at), (bj, bt) = ((cj, ct), (rj, rt)) if order == "complex_real" else (
        (rj, rt), (cj, ct))
    with both():
        got = dtt.multiply("N", "N", 1.0, at, bt)
        fn, c_index, _ = dtt.build_multiply_executor("N", "N", at, bt)
        exe = dtt.BCSRMatrix(name="P", index=c_index, data=fn(at.data, bt.data))
        if order == "complex_real":
            assert_same(djax.multiply("N", "N", 1.0, aj, bj), got, np.complex128)
    assert got.dtype == torch.complex128 and fn.plan.route == "c_stack"
    ref = dense_t(at) @ dense_t(bt)
    assert rel_err(dense_t(got), ref) <= 1e-12
    assert rel_err(dense_t(exe), ref) <= 1e-12


@pytest.mark.parametrize("sym", ["H", "A"])
def test_desymmetrize_and_multiply(sym):
    hj, ht = pair(11, np.complex128, sym=sym, occ=0.5)
    with both():
        fj, ft = djax.desymmetrize(hj), dtt.desymmetrize(ht)
        assert_same(fj, ft, np.complex128)
        rj = djax.multiply("C", "N", 1.0, hj, hj)
        rt = dtt.multiply("C", "N", 1.0, ht, ht)
    assert_same(rj, rt, np.complex128)
    d = dense_t(ht)
    if sym == "H":
        np.testing.assert_allclose(np.tril(d, -1), np.tril(d.conj().T, -1), rtol=0, atol=0)
    else:
        np.testing.assert_allclose(np.tril(d, -1), -np.tril(d.T, -1), rtol=0, atol=0)
    assert rel_err(dense_t(rt), d.conj().T @ d) <= 1e-12


@pytest.mark.parametrize("dtype", CPLX)
def test_transpose_conjugate_fold_and_dense_forms(dtype):
    mj, mt = pair(12, dtype, m=30)
    with both():
        for conj in (False, True):
            assert_same(djax.transpose(mj, conjugate=conj),
                        dtt.transpose(mt, conjugate=conj), dtype)
        d = dense_t(mt)
        np.testing.assert_array_equal(dense_t(dtt.transpose(mt, conjugate=True)), d.conj().T)
        sq_j, sq_t = pair(13, dtype)
        from dbcsr_tpu.ops.transform import fold_symmetric as jax_fold

        assert_same(jax_fold(sq_j, "H"), dtt.fold_symmetric(sq_t, "H"), dtype)
        dense = dtt.make_dense(mt)
        assert dense.nblks == 1 and dense.dtype == mt.dtype
        np.testing.assert_array_equal(dense_t(dense), d)
        back = dtt.make_undense(dense, mt.row_block_sizes, mt.col_block_sizes)
        assert_same(mj, back, dtype)
        re = dtt.retile(mt, 16)
        assert re.tile == 16 and re.dtype == mt.dtype
        np.testing.assert_array_equal(dense_t(re), d)
        np.testing.assert_array_equal(dense_t(dtt.copy(mt)), d)


# ---------------------------------------------------------------------------
# norms and arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sym", ["N", "H"])
@pytest.mark.parametrize("dtype", CPLX)
def test_norms(dtype, sym):
    mj, mt = pair(1, dtype, name="A") if sym == "N" else pair(14, dtype, sym=sym)
    nj, nt = np.asarray(djax.block_norms_sq(mj)), dtt.block_norms_sq(mt)
    assert nt.dtype == np.float32 and rel_err(nt, nj) <= 1e-6
    for name in ("norm_frobenius", "norm_maxabs", "norm_column", "norm_gershgorin"):
        got, ref = getattr(dtt, name)(mt), getattr(djax, name)(mj)
        assert isinstance(got, float) and got == pytest.approx(ref, rel=1e-6), name
    d = dense_t(mt).astype(np.complex128)
    assert dtt.norm_frobenius(mt) == pytest.approx(np.linalg.norm(d), rel=1e-6)


@pytest.mark.parametrize("dtype", CPLX)
def test_arithmetic(dtype):
    aj, at = pair(1, dtype, name="A")
    bj, bt = pair(2, dtype, name="B")
    tol = RTOL[dtype]
    with both():
        assert_same(djax.add(0.5 + 2j, aj, -1j, bj), dtt.add(0.5 + 2j, at, -1j, bt), dtype)
        assert_same(djax.scale(aj, 2 - 1j), dtt.scale(at, 2 - 1j), dtype)
        for fn in ("trace", "dot"):
            args_j, args_t = ((aj,), (at,)) if fn == "trace" else ((aj, bj), (at, bt))
            got, ref = getattr(dtt, fn)(*args_t), getattr(djax, fn)(*args_j)
            assert isinstance(got, complex) and abs(got - ref) <= tol * 10 * max(abs(ref), 1)
        da, db = dense_t(at).astype(np.complex128), dense_t(bt).astype(np.complex128)
        assert abs(dtt.dot(at, bt) - np.vdot(da, db)) <= 1e-4 * abs(np.vdot(da, db))
        assert_same(djax.hadamard_product(aj, bj), dtt.hadamard_product(at, bt), dtype)
        assert_same(djax.set_value(aj, 1.5 - 0.5j), dtt.set_value(at, 1.5 - 0.5j), dtype)
        assert_same(djax.filter_blocks(aj, 2.0), dtt.filter_blocks(at, 2.0), dtype)
    # the rest against the dense host formulas (the same elementwise math)
    da = dense_t(at)
    stored = dense_t(dtt.set_value(at, 1.0)) != 0
    vec = (np.linspace(-1, 1, at.shape[1]) + 0.5j).astype(dtype)
    np.testing.assert_allclose(dense_t(dtt.scale_by_vector(at, vec)), da * vec[None, :],
                               rtol=RTOL[dtype])
    diag = np.diag(np.diag(stored)).astype(bool)
    np.testing.assert_array_equal(dense_t(dtt.add_on_diag(at, 3j)),
                                  np.where(diag, da + dtype(3j), da))
    np.testing.assert_array_equal(dense_t(dtt.triu(at)), np.triu(da))
    np.testing.assert_array_equal(to_numpy(dtt.get_diag(at)), np.diag(da))


@pytest.mark.parametrize("dtype", CPLX)
def test_the_other_arithmetic(dtype):
    """zero, set_diag, function_of_elements, get_block_diag and crop on
    complex stores: block structure against dbcsr_tpu, values against the
    dense host matrix."""
    aj, at = pair(27, dtype, occ=0.2)
    with both():
        assert_same(djax.get_block_diag(aj), dtt.get_block_diag(at), dtype)
        assert_same(djax.crop(aj, (3, 30), (10, 50)), dtt.crop(at, (3, 30), (10, 50)), dtype)
    da = dense_t(at)
    stored = dense_t(dtt.set_value(at, 1.0)) != 0
    assert not dense_t(dtt.zero(at)).any() and dtt.zero(at).dtype == at.dtype
    diag = (np.arange(da.shape[0]) * (1 - 1j)).astype(dtype)
    on = np.diag(np.diag(stored)).astype(bool)
    np.testing.assert_array_equal(dense_t(dtt.set_diag(at, diag)),
                                  np.where(on, np.diag(diag), da))
    got = dense_t(dtt.function_of_elements(at, "exp"))
    np.testing.assert_allclose(got, np.where(stored, np.exp(da), 0), rtol=RTOL[dtype] * 10)


def test_self_tests_take_complex():
    """``test_mm`` sweeps N/T/C with complex coefficients, and
    ``check_multiply`` holds 'C' to the conjugate transpose: a product
    computed with 'T' in its place fails it."""
    from dbcsr_tpu_torch import testing

    assert testing.test_mm("cpu", nblkrows=14, nblkcols=12, nblkks=13, dtype=np.complex128)
    aj, at = pair(1, np.complex128, name="A")
    with torch_override(tile_size=T):
        good = dtt.multiply("C", "N", 1.0, at, at)
        wrong = dtt.multiply("T", "N", 1.0, at, at)
    assert testing.check_multiply("C", "N", 1.0, at, at, 0.0, None, good)
    assert not testing.check_multiply("C", "N", 1.0, at, at, 0.0, None, wrong)


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------

def decayed(seed, dtype, name):
    """A complex matrix whose blocks decay as exp(-0.8·|bi - bj|), in both
    packages (the shape of tests/test_torch_filtered.py)."""
    mj, _ = pair(seed, dtype, name=name, occ=0.5)
    rbs = mj.row_block_sizes
    blocks = []
    for i, j, blk in mj.iter_blocks():
        blocks.append(blk * np.exp(-0.8 * abs(i - j)).astype(blk.real.dtype))
    rows, cols = mj.index.blk_rows, mj.index.col_idx
    with jax_override(tile_size=T):
        mj = djax.BCSRMatrix.from_blocks(rows, cols, blocks, rbs, rbs, dtype=np.dtype(dtype),
                                         name=name)
    return mj, carry(mj)


@pytest.mark.parametrize("dtype", CPLX)
def test_filtered_multiply_exact(dtype):
    aj, at = decayed(17, dtype, "A")
    bj, bt = decayed(18, dtype, "B")
    eps = 5e-2
    with both(filter_mode="exact"):
        for ta, tb in (("N", "N"), ("C", "N")):
            rj = djax.multiply(ta, tb, 1.0 + 1j, aj, bj, filter_eps=eps)
            rt = dtt.multiply(ta, tb, 1.0 + 1j, at, bt, filter_eps=eps)
            assert_same(rj, rt, dtype)  # the kept blocks are identical
            assert 0 < rt.nblks < dtt.multiply(ta, tb, 1.0, at, bt).nblks
            assert dtt.block_norms_sq(rt).min() >= np.float32(eps) ** 2


def test_filtered_executor_step():
    aj, at = decayed(19, np.complex128, "A")
    bj, bt = decayed(20, np.complex128, "B")
    eps = 5e-2
    with both():
        exj = djax.build_filtered_executor("N", "C", aj, bj, eps)
        ext = dtt.build_filtered_executor("N", "C", at, bt, eps)
        np.testing.assert_array_equal(ext.c_index.col_idx, exj.c_index.col_idx)
        for scale in (1.0, 0.3 - 0.2j):
            a_t = at.with_data(at.data * scale)
            cj, kj, nj = exj.step(aj.data * np.complex128(scale), bj.data)
            ct, kt, nt = ext.step(a_t.data, bt.data)
            assert kt.dtype == torch.float32 and nt.dtype == torch.float32
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            assert rel_err(nt.numpy(), np.asarray(nj)) <= 1e-6
            assert rel_err(ct.numpy(), np.asarray(cj)) <= 1e-12
            got = ext.compact(ct, kt)
            assert_same(exj.compact(cj, kj), got, np.complex128)
            one_shot = dtt.multiply("N", "C", 1.0, a_t, bt, filter_eps=eps)
            np.testing.assert_array_equal(got.index.col_idx, one_shot.index.col_idx)
            assert rel_err(dense_t(got), dense_t(one_shot)) <= 1e-12


# ---------------------------------------------------------------------------
# the host API: checkpoints, CSR, limits, the .perf driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", CPLX)
def test_checkpoints_both_ways(dtype, tmp_path):
    mj, mt = pair(21, dtype, sym="H")
    pj, pt = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    djax.binary_write(mj, pj)
    dtt.binary_write(mt, pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()  # the same bytes
    with torch_override(tile_size=T):
        back = dtt.binary_read(pj, device="cpu")
    assert back.sym == "H" and back.dtype == mt.dtype and torch.equal(back.data, mt.data)
    with jax_override(tile_size=T):
        bj = djax.binary_read(pt)
    np.testing.assert_array_equal(np.asarray(bj.data), np.asarray(mj.data))
    assert dtt.checksum(mt) == djax.checksum(mj)
    assert dtt.checksum(mt, pos=True) == djax.checksum(mj, pos=True)


@pytest.mark.parametrize("dtype", CPLX)
def test_csr_round_trip(dtype):
    mj, mt = pair(22, dtype, sym="H")
    cj, ct = djax.to_csr(mj), dtt.to_csr(mt)
    assert ct.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(ct.indptr, cj.indptr)
    np.testing.assert_array_equal(ct.data, cj.data)
    with torch_override(tile_size=T):
        back = dtt.from_csr(ct, mt.row_block_sizes, mt.col_block_sizes, device="cpu")
    assert back.dtype == mt.dtype
    np.testing.assert_array_equal(dense_t(back), dense_t(mt))


def test_limits_keep_the_conjugate():
    aj, at = pair(1, np.complex128, name="A")
    bj, bt = pair(2, np.complex128, name="B")
    lim = {"rows": (3, 25), "cols": (0, 30), "k": (5, 35)}
    with both():
        rj = djax.multiply("C", "N", 2j, aj, bj, 0.5, bj, limits=lim)
        rt = dtt.multiply("C", "N", 2j, at, bt, 0.5, bt, limits=lim)
    assert_same(rj, rt, np.complex128)


@pytest.mark.parametrize("data_type", [5, 7])
def test_perf_recipe_of_complex_types(tmp_path, data_type):
    """A .perf recipe of data type 5 (complex64) or 7 (complex128) with
    complex alpha/beta, written here: the checksum of the JAX package's
    driver, the executor on the complex stack route."""
    recipe = tmp_path / "complex.perf"
    recipe.write_text("\n".join([
        "1", "F", "dbcsr_multiply", "180 160 140", "0.94 0.95 0.97", "C N", "N N N",
        str(data_type), "0.5 0.25", "0.0 1.0", "0 0", "0 0", "0 0", "F", "2",
        "1", "1", "1", "2 3", "3 5", "1 2", "F",
    ]).replace(" ", "\n") + "\n")
    cfg = perf.parse_perf(str(recipe))
    assert cfg.data_type == data_type and cfg.alpha == 0.5 + 0.25j and cfg.beta == 1j
    with both():
        ref = jax_perf.run_perf(jax_perf.PerfConfig(**dataclasses.asdict(cfg)), seed=2,
                                verbose=False)
        got = perf.run_perf(cfg, device="cpu", seed=2, verbose=False)
    rtol = RTOL[np.complex64 if data_type == 5 else np.complex128]
    assert got["checksum"] == pytest.approx(ref["checksum"], rel=rtol)
    assert got["route"] == "c_stack"


# ---------------------------------------------------------------------------
# TAS and tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsplit", [1, 3])
def test_tas_multiply_complex(nsplit):
    rng = np.random.default_rng(25)
    mbs = djax.random_block_sizes(150, [2, 3], rng)
    kbs = djax.random_block_sizes(24, [2], rng)
    nbs = djax.random_block_sizes(30, [3], rng)
    with jax_override(tile_size=T):
        aj = djax.random_matrix(mbs, kbs, 0.4, rng, dtype=np.complex128)
        bj = djax.random_matrix(kbs, nbs, 0.7, rng, dtype=np.complex128)
    at, bt = carry(aj), carry(bj)
    with both():
        oj = jax_tas_multiply("N", "N", 1.0 + 1.0j, aj, bj, nsplit=nsplit)
        ot = tas_multiply("N", "N", 1.0 + 1.0j, at, bt, nsplit=nsplit)
    assert_same(oj.matrix, ot.matrix, np.complex128)
    ref = (1.0 + 1.0j) * dense_t(at) @ dense_t(bt)
    assert rel_err(dense_t(ot.matrix), ref) <= 1e-12


def test_contract_complex():
    bs_i, bs_k, bs_j = np.array([2, 3, 2]), np.array([2, 2, 3]), np.array([4, 1])
    rng = np.random.default_rng(26)
    tensors = []
    for shape_bs in ([bs_i, bs_k], [bs_k, bs_j]):
        nbpd = [len(b) for b in shape_bs]
        tj = JaxTensorBuilder(shape_bs, dtype=np.complex128)
        tt = TensorBuilder(shape_bs, dtype=np.complex128, device="cpu")
        for flat in range(int(np.prod(nbpd))):
            bi = np.unravel_index(flat, nbpd)
            shp = tuple(int(shape_bs[d][bi[d]]) for d in range(len(shape_bs)))
            blk = rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
            tj.put_block(bi, blk)
            tt.put_block(bi, blk)
        tensors.append((tj.finalize(), tt.finalize()))
    (aj, at), (bj, bt) = tensors
    kw = dict(contract_1=(1,), notcontract_1=(0,), contract_2=(0,), notcontract_2=(1,))
    with both():
        oj = jax_contract(1.0 - 2j, aj, bj, **kw)
        ot = contract(1.0 - 2j, at, bt, **kw)
        batched = BatchedContract()
        ob = [batched.contract(at, bt, **kw) for _ in range(2)]
    ref = np.einsum("ik,kj->ij", at.to_dense().numpy(), bt.to_dense().numpy())
    assert rel_err(ot.to_dense().numpy(), np.asarray(oj.to_dense())) <= 1e-12
    assert rel_err(ot.to_dense().numpy(), (1.0 - 2j) * ref) <= 1e-12
    for got in ob:
        assert rel_err(got.to_dense().numpy(), ref) <= 1e-12
