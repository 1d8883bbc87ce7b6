"""Port parity, ``tensors/``: index folding, block access, every refold of
a rank-3 and a rank-4 tensor, block splitting, matrix↔tensor, permuted
copies and every contraction case of ``tests/test_tensor.py`` and
``tests/test_contract_bounds.py``, against dbcsr_tpu on the same tensors
(built in the JAX package from a seed, carried into the port by
``testing.tensor_from_arrays``); the RI-type 3-center contraction of
``chip_smoke.py`` phase 11 at 12 atoms; the refold's cached device map.

Block indices, C's index and ``eff_flops`` must be identical; refolds move
elements, so their values are equal bit for bit; contractions agree within
1e-12 (float64: the JAX side at ``f64_method="native"``) or 1e-5 (float32 at
"highest") of the largest reference entry.
"""
import itertools
import os
import sys
from contextlib import ExitStack

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import dbcsr_tpu as djax
import dbcsr_tpu.tensors as jten
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
import dbcsr_tpu_torch.tensors as tten
from dbcsr_tpu_torch.block.gather import apply_store_gather, flat_gather_store_map
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.mm.plancache import get_plan_cache
from dbcsr_tpu_torch.testing import matrix_from_arrays, tensor_from_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]
T = 16


def both():
    es = ExitStack()
    es.enter_context(jax_override(tile_size=T, f64_method="native"))
    es.enter_context(torch_override(tile_size=T))
    return es


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def carry(tj):
    m = tj.matrix
    return tensor_from_arrays(
        tj.block_sizes, tj.mapping.map1, tj.mapping.map2, m.index.blk_rows,
        m.index.col_idx, m.flat_host(), dtype=np.asarray(m.data).dtype,
        device="cpu", tile=T, name=tj.name,
    )


def rand_pair(block_sizes, occ, rng, mapping=None, dtype=np.float64, name="T"):
    """The same random tensor in both packages (JAX's builder, then carried)."""
    bs = [np.asarray(b, dtype=np.int32) for b in block_sizes]
    jmap = None if mapping is None else jten.NDMapping(*mapping)
    builder = jten.TensorBuilder(bs, jmap, name=name, dtype=dtype)
    nbpd = [len(b) for b in bs]
    for flat in np.flatnonzero(rng.random(int(np.prod(nbpd))) < occ):
        bi = np.unravel_index(flat, nbpd)
        builder.put_block(bi, rng.standard_normal(tuple(int(bs[d][bi[d]]) for d in range(len(bs)))))
    with jax_override(tile_size=T):
        tj = builder.finalize()
    return tj, carry(tj)


def assert_same(tj, tt, dtype, exact=False):
    assert tt.mapping.map1 == tj.mapping.map1 and tt.mapping.map2 == tj.mapping.map2
    for bj, bt in zip(tj.block_sizes, tt.block_sizes):
        np.testing.assert_array_equal(bt, bj)
    mj, mt = tj.matrix, tt.matrix
    np.testing.assert_array_equal(mt.index.row_ptr, mj.index.row_ptr)
    np.testing.assert_array_equal(mt.index.col_idx, mj.index.col_idx)
    assert tt.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    if exact:
        np.testing.assert_array_equal(mt.flat_host(), mj.flat_host())
    else:
        assert rel_err(mt.flat_host(), mj.flat_host()) <= RTOL[dtype]


def mappings(ndim):
    """Every (map1, map2): an ordered split of a permutation of the dims."""
    for perm in itertools.permutations(range(ndim)):
        for h in range(1, ndim):
            yield perm[:h], perm[h:]


# ---- index folding ------------------------------------------------------------

@pytest.mark.parametrize("dims", [(3, 4, 5), (7,), (2, 1, 3, 2)])
def test_fold_unfold(dims):
    rng = np.random.default_rng(0)
    dims = np.asarray(dims)
    idx = np.stack([rng.integers(0, d, size=50) for d in dims], axis=1)
    flat = tten.fold_indices(idx, dims)
    np.testing.assert_array_equal(flat, jten.fold_indices(idx, dims))
    np.testing.assert_array_equal(tten.unfold_indices(flat, dims), idx)
    m_t, m_j = tten.NDMapping(3, (0, 2), (1,)), jten.NDMapping(3, (0, 2), (1,))
    bi = np.array([[1, 2, 3], [0, 0, 1]])
    for x, y in zip(m_t.fold(bi, [2, 3, 4]), m_j.fold(bi, [2, 3, 4])):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(m_t.unfold(*m_t.fold(bi, [2, 3, 4]), [2, 3, 4]), bi)
    bs = [np.array([2, 3]), np.array([4]), np.array([1, 5, 2])]
    for sel in ([], [0], [2, 0], [1, 2, 0]):
        np.testing.assert_array_equal(tten.grouped_block_sizes(bs, sel),
                                      jten.grouped_block_sizes(bs, sel))
    with pytest.raises(dtt.DbcsrError):
        tten.NDMapping(3, (0,), (0, 1))


# ---- block access ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_block_access(dtype):
    rng = np.random.default_rng(1)
    bs = [np.array([2, 3]), np.array([4]), np.array([2, 2])]
    tj, tt = rand_pair(bs, 0.6, rng, (3, (1,), (2, 0)), dtype)
    assert (tt.ndim, tt.nblk_per_dim, tt.shape, tt.nblks) == (
        tj.ndim, tj.nblk_per_dim, tj.shape, tj.nblks)
    assert tt.occupation() == tj.occupation()
    np.testing.assert_array_equal(tt.block_indices(), tj.block_indices())
    for (bi_t, bt), (bi_j, bj) in zip(tt.iter_blocks(), tj.iter_blocks()):
        assert bi_t == bi_j
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(tt.get_block(bi_t), bj)
    dense = tt.to_dense()
    assert dense.dtype == tt.dtype and dense.device == tt.device
    np.testing.assert_array_equal(dense.numpy(), tj.to_dense())
    # builder: put, accumulate, reserve, absent
    blk = rng.standard_normal((3, 4, 2))
    b = tten.TensorBuilder(bs, tten.NDMapping(3, (1,), (2, 0)), dtype=dtype,
                           device="cpu", tile=T)
    b.put_block((1, 0, 1), blk)
    b.put_block((1, 0, 1), blk, sum=True)
    b.reserve_block((0, 0, 0))
    b.reserve_block((1, 0, 1))  # keeps the staged block
    t2 = b.finalize()
    np.testing.assert_allclose(t2.get_block((1, 0, 1)), 2 * blk.astype(dtype), rtol=1e-7)
    assert not t2.get_block((0, 0, 0)).any()
    assert t2.get_block((0, 0, 1)) is None
    assert tten.TensorBuilder(bs, device="cpu").finalize().nblks == 0


# ---- refolds ------------------------------------------------------------------

RANK3_BS = [np.array([2, 3]), np.array([1, 4, 2]), np.array([3, 2])]
RANK4_BS = [np.array([2, 1]), np.array([3]), np.array([1, 2, 2]), np.array([2, 3])]


@pytest.mark.parametrize("target", list(mappings(3)))
def test_with_layout_rank3(target):
    rng = np.random.default_rng(2)
    tj, tt = rand_pair(RANK3_BS, 0.7, rng, (3, (0,), (1, 2)), np.float64)
    with both():
        rj = tj.with_layout(jten.NDMapping(3, *target))
        rt = tt.with_layout(tten.NDMapping(3, *target))
    assert_same(rj, rt, np.float64, exact=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_with_layout_rank4_every_mapping(dtype):
    rng = np.random.default_rng(3)
    tj, tt = rand_pair(RANK4_BS, 0.6, rng, (4, (0, 1), (2, 3)), dtype)
    seen = 0
    with both():
        for target in mappings(4):
            rj = tj.with_layout(jten.NDMapping(4, *target))
            rt = tt.with_layout(tten.NDMapping(4, *target))
            assert_same(rj, rt, dtype, exact=True)
            seen += 1
    assert seen == 72


def test_refold_cached_map_is_bitwise_apply_store_gather():
    """The refold's cached plan, on the tensor's device, gives the
    bits of the one-call store gather through the host map the refold
    composes, and a cache hit gives them again."""
    rng = np.random.default_rng(4)
    _, tt = rand_pair(RANK3_BS, 0.8, rng, (3, (0,), (1, 2)), np.float32)
    target = tten.NDMapping(3, (2,), (1, 0))
    pc = get_plan_cache()
    pc.clear()
    first = tt.with_layout(target)
    hits = pc.hits
    second = tt.with_layout(target)
    assert pc.hits == hits + 1 and second.matrix.index is first.matrix.index
    # the host map, composed as the refold composes it
    from dbcsr_tpu_torch.block.index import build_index
    from torch_refold_map import refold_flat_map

    bis = tt.block_indices()
    rows, cols = target.fold(bis, tt.nblk_per_dim)
    new_index, order = build_index(rows, cols, first.matrix.row_block_sizes,
                                   first.matrix.col_block_sizes)
    gmap = refold_flat_map(tt.block_sizes, tt.mapping, target, bis,
                           tt.matrix.index.blk_offset, order, new_index.nelems)
    inv = flat_gather_store_map(new_index, T, tt.matrix.layout, gmap)
    ref = apply_store_gather(tt.matrix.data, inv, first.matrix.data.shape[0], T)
    for got in (first.matrix.data, second.matrix.data):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    np.testing.assert_array_equal(first.to_dense().numpy(), tt.to_dense().numpy())


def test_refold_map_is_the_jax_map():
    """The port's cached refold plan moves each element as the JAX
    package's map does (the same per-block loop, composed with the same
    store layouts): position for position, the JAX map's out-of-range
    sentinel where the port moves nothing."""
    from dbcsr_tpu_torch.block.refold import apply_refold
    from dbcsr_tpu.mm.plancache import get_plan_cache as jax_cache

    rng = np.random.default_rng(5)
    tj, tt = rand_pair(RANK4_BS, 0.7, rng, (4, (3, 1), (0, 2)), np.float64)
    sentinel = np.iinfo(np.int32).max
    with both():
        for target in [((0,), (1, 2, 3)), ((2, 0), (3, 1)), ((1, 2, 3), (0,))]:
            tt.with_layout(tten.NDMapping(4, *target))
            tj.with_layout(jten.NDMapping(4, *target))
            plan = [v for k, v in get_plan_cache()._store.items()
                    if k[0] == "with_layout"][-1][1]
            jinv = np.asarray([v for k, v in jax_cache()._store.items()
                               if k[0] == "with_layout"][-1][1]).astype(np.int64)
            # the port keeps a block plan: the map it moves by is where each
            # position of the new store takes its value from (1 + position,
            # exact in float64; 0 where nothing is moved)
            pos = torch.arange(1, len(plan.src_keys) * T * T + 1, dtype=torch.float64)
            inv = apply_refold(pos.view(-1, T, T), plan).reshape(-1).long().numpy() - 1
            np.testing.assert_array_equal(np.where(jinv == sentinel, -1, jinv), inv)


# ---- conversions and copies -------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_split_blocks(dtype):
    rng = np.random.default_rng(1)
    tj, tt = rand_pair([np.array([4, 2]), np.array([6])], 1.0, rng, None, dtype)
    fine = [np.array([2, 2, 2]), np.array([3, 3])]
    with both():
        sj, st_ = jten.split_blocks(tj, fine), tten.split_blocks(tt, fine)
    assert_same(sj, st_, dtype, exact=True)
    assert st_.nblk_per_dim == (3, 2)
    with pytest.raises(dtt.DbcsrError):
        tten.split_blocks(tt, [np.array([3, 3]), np.array([6])])
    with pytest.raises(dtt.DbcsrError):
        tten.split_blocks(tt, [np.array([4, 2]), np.array([5])])


@pytest.mark.parametrize("dtype", DTYPES)
def test_matrix_tensor_roundtrip(dtype):
    rng = np.random.default_rng(4)
    rbs = djax.random_block_sizes(12, [2, 3], rng)
    cbs = djax.random_block_sizes(10, [2, 5], rng)
    with jax_override(tile_size=T):
        mj = djax.random_matrix(rbs, cbs, 0.5, rng, dtype=dtype)
    mt = matrix_from_arrays(rbs, cbs, mj.index.blk_rows, mj.index.col_idx,
                            np.asarray(mj.data), device="cpu")
    tj, tt = jten.tensor_from_matrix(mj), tten.tensor_from_matrix(mt, name="m")
    assert tt.ndim == 2 and tt.name == "m" and tt.matrix is mt
    with both():
        fj = jten.matrix_from_tensor(tj.with_layout(jten.NDMapping(2, (1,), (0,))))
        ft = tten.matrix_from_tensor(tt.with_layout(tten.NDMapping(2, (1,), (0,))))
    np.testing.assert_array_equal(ft.index.col_idx, fj.index.col_idx)
    np.testing.assert_array_equal(ft.flat_host(), fj.flat_host())
    np.testing.assert_array_equal(ft.to_dense().numpy(), mt.to_dense().numpy())
    with pytest.raises(dtt.DbcsrError):
        tten.matrix_from_tensor(rand_pair(RANK3_BS, 0.5, rng)[1])


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))))
def test_copy_tensor_order(order):
    rng = np.random.default_rng(3)
    tj, tt = rand_pair([np.array([2, 2]), np.array([3]), np.array([1, 2])], 0.8, rng)
    target = ((1,), (0, 2))
    with both():
        pj = jten.copy_tensor(tj, order=order, name="p")
        pt = tten.copy_tensor(tt, order=order, name="p")
        qj = jten.copy_tensor(tj, order=order, mapping=jten.NDMapping(3, *target))
        qt = tten.copy_tensor(tt, order=order, mapping=tten.NDMapping(3, *target))
    assert pt.name == "p" and pt.matrix is tt.matrix  # relabeling is free
    assert_same(pj, pt, np.float64, exact=True)
    assert_same(qj, qt, np.float64, exact=True)
    np.testing.assert_array_equal(qt.to_dense().numpy(),
                                  np.transpose(tt.to_dense().numpy(), order))


# ---- contraction ----------------------------------------------------------------

def _case(name, rng, dtype):
    """(einsum spec, A pair, B pair, contract kwargs) of the cases of
    tests/test_tensor.py:115-261."""
    R = lambda *a, **k: rand_pair(*a, **k, rng=rng, dtype=dtype)  # noqa: E731
    kw = dict(contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,), notcontract_2=(1,))
    if name == "rank3_rank2":
        a = R([[2, 3], [2, 2], [3, 1, 2]], 0.7, mapping=(3, (0, 1), (2,)))
        b = R([[3, 1, 2], [4]], 0.8, mapping=(2, (0,), (1,)))
        return "ijk,kl->ijl", a, b, kw
    if name == "rank3_rank3_to_rank2":
        a = R([[3, 2], [2, 1], [2, 2]], 0.6, mapping=(3, (0,), (1, 2)))
        b = R([[2, 1], [2, 2], [3, 3]], 0.6, mapping=(3, (2,), (0, 1)))
        return "ijk,jkl->il", a, b, dict(contract_1=(1, 2), notcontract_1=(0,),
                                         contract_2=(0, 1), notcontract_2=(2,))
    if name == "rank4_with_maps":
        a = R([[2, 2], [3], [2, 1]], 0.8)
        b = R([[2, 1], [2], [1, 2]], 0.8)
        return "ijk,klm->limj", a, b, dict(contract_1=(2,), notcontract_1=(0, 1),
                                           contract_2=(0,), notcontract_2=(1, 2),
                                           map_1=(1, 3), map_2=(0, 2))
    if name == "rank4_inputs":
        a = R([[2, 2], [3], [2, 1], [2]], 0.7, mapping=(4, (0, 1), (2, 3)))
        b = R([[2, 1], [2], [2], [1, 2]], 0.7, mapping=(4, (0, 1), (2, 3)))
        return "ijkl,klmn->ijmn", a, b, dict(contract_1=(2, 3), notcontract_1=(0, 1),
                                             contract_2=(0, 1), notcontract_2=(2, 3))
    if name == "rank4_rank2_misaligned":
        a = R([[2], [2, 1], [3], [2, 2]], 0.8, mapping=(4, (0, 2), (1, 3)))
        b = R([[2, 2], [3, 1]], 0.9)
        return "ijkl,lp->ijkp", a, b, dict(contract_1=(3,), notcontract_1=(0, 1, 2),
                                           contract_2=(0,), notcontract_2=(1,))
    raise KeyError(name)


CASES = ["rank3_rank2", "rank3_rank3_to_rank2", "rank4_with_maps", "rank4_inputs",
         "rank4_rank2_misaligned"]


def contract_both(aj, at, bj, bt, *, cj=None, ct=None, alpha=1.0, beta=0.0, **kw):
    with both():
        oj, fj = jten.contract(alpha, aj, bj, beta, cj, return_flops=True, **kw)
        ot, ft = tten.contract(alpha, at, bt, beta, ct, return_flops=True, **kw)
    assert ft == fj
    return oj, ot


@pytest.mark.parametrize("nsplit", [None, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_contract_cases(name, dtype, nsplit):
    rng = np.random.default_rng(CASES.index(name) + 5)
    spec, (aj, at), (bj, bt), kw = _case(name, rng, dtype)
    oj, ot = contract_both(aj, at, bj, bt, alpha=1.5, nsplit=nsplit, **kw)
    assert_same(oj, ot, dtype)
    ref = 1.5 * np.einsum(spec, at.to_dense().double().numpy(), bt.to_dense().double().numpy())
    assert rel_err(ot.to_dense().numpy(), ref) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_contract_alpha_beta_accumulate(dtype):
    rng = np.random.default_rng(8)
    bs_i, bs_k, bs_j = [2, 3], [2, 2], [4]
    aj, at = rand_pair([bs_i, bs_k], 0.8, rng, dtype=dtype)
    bj, bt = rand_pair([bs_k, bs_j], 0.8, rng, dtype=dtype)
    cj, ct = rand_pair([bs_i, bs_j], 0.6, rng, (2, (1,), (0,)), dtype=dtype, name="C")
    kw = dict(contract_1=(1,), notcontract_1=(0,), contract_2=(0,), notcontract_2=(1,))
    oj, ot = contract_both(aj, at, bj, bt, cj=cj, ct=ct, alpha=2.0, beta=0.5, **kw)
    assert ot.name == "C" and ot.mapping.map1 == (1,)
    assert_same(oj, ot, dtype)


def test_contract_filter_eps_drops_tiny_blocks():
    bs = np.array([2, 2])
    builder = jten.TensorBuilder([bs, bs], dtype=np.float64)
    builder.put_block((0, 0), np.full((2, 2), 10.0))
    builder.put_block((1, 1), np.full((2, 2), 1e-14))
    with jax_override(tile_size=T):
        aj = builder.finalize()
    at = carry(aj)
    kw = dict(contract_1=(1,), notcontract_1=(0,), contract_2=(0,), notcontract_2=(1,))
    oj, ot = contract_both(aj, at, aj, at, filter_eps=1e-6, **kw)
    assert ot.nblks == 1 and ot.get_block((0, 0)) is not None
    assert_same(oj, ot, np.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_contract_bounds_batched_k_sum(dtype):
    rng = np.random.default_rng(10)
    bs_i, bs_k, bs_j = np.array([3, 2]), np.array([2, 3, 1, 2]), np.array([2, 2])
    aj, at = rand_pair([bs_i, bs_k], 0.9, rng, dtype=dtype)
    bj, bt = rand_pair([bs_k, bs_j], 0.9, rng, dtype=dtype)
    kw = dict(contract_1=(1,), notcontract_1=(0,), contract_2=(0,), notcontract_2=(1,))
    koff = np.concatenate([[0], np.cumsum(bs_k)])
    full = contract_both(aj, at, bj, bt, **kw)[1].to_dense()
    acc = torch.zeros_like(full)
    for b0, b1 in [(0, 2), (2, 4)]:
        pj, pt = contract_both(aj, at, bj, bt, bounds={
            "contract": {1: (int(koff[b0]), int(koff[b1]))}}, **kw)
        assert_same(pj, pt, dtype)
        acc = acc + pt.to_dense()
    assert rel_err(acc.numpy(), full.numpy()) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bounds_nc_windows_tile_the_result(dtype):
    rng = np.random.default_rng(0)
    bs_i, bs_k, bs_j = np.array([2, 3, 2, 3]), np.array([2, 2]), np.array([3, 3, 2])
    aj, at = rand_pair([bs_i, bs_k], 0.9, rng, dtype=dtype)
    bj, bt = rand_pair([bs_k, bs_j], 0.9, rng, dtype=dtype)
    kw = dict(contract_1=(1,), notcontract_1=(0,), contract_2=(0,), notcontract_2=(1,))
    full = contract_both(aj, at, bj, bt, **kw)[1].to_dense()
    ioff = np.concatenate([[0], np.cumsum(bs_i)])
    acc = torch.zeros_like(full)
    for b0, b1 in [(0, 2), (2, 4)]:
        wj, wt = contract_both(aj, at, bj, bt, bounds={
            "nc1": {0: (int(ioff[b0]), int(ioff[b1]))}}, **kw)
        assert_same(wj, wt, dtype)
        acc = acc + wt.to_dense()
    assert rel_err(acc.numpy(), full.numpy()) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_bounds_nc2_and_beta_accumulate(dtype):
    rng = np.random.default_rng(1)
    bs_i, bs_k, bs_j = np.array([2, 2]), np.array([3, 2]), np.array([2, 3, 2])
    aj, at = rand_pair([bs_i, bs_k], 0.9, rng, dtype=dtype)
    bj, bt = rand_pair([bs_k, bs_j], 0.9, rng, dtype=dtype)
    cj, ct = rand_pair([bs_i, bs_j], 0.7, rng, dtype=dtype)
    joff = np.concatenate([[0], np.cumsum(bs_j)])
    oj, ot = contract_both(aj, at, bj, bt, cj=cj, ct=ct, alpha=2.0, beta=0.5,
                           contract_1=(1,), notcontract_1=(0,), contract_2=(0,),
                           notcontract_2=(1,),
                           bounds={"nc2": {1: (int(joff[0]), int(joff[2]))}})
    assert_same(oj, ot, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bounds_combined_contract_and_nc(dtype):
    rng = np.random.default_rng(2)
    bs = np.array([2, 2, 2])
    aj, at = rand_pair([bs, bs], 0.9, rng, dtype=dtype)
    bj, bt = rand_pair([bs, bs], 0.9, rng, dtype=dtype)
    koff = np.concatenate([[0], np.cumsum(bs)])
    oj, ot = contract_both(aj, at, bj, bt, contract_1=(1,), notcontract_1=(0,),
                           contract_2=(0,), notcontract_2=(1,), bounds={
                               "contract": {1: (0, int(koff[2]))},
                               "nc1": {0: (int(koff[1]), int(koff[3]))}})
    assert_same(oj, ot, dtype)
    with pytest.raises(dtt.DbcsrError):
        tten.contract(1.0, at, bt, contract_1=(1,), notcontract_1=(0,), contract_2=(0,),
                      notcontract_2=(1,), bounds={"nc1": {0: (1, 4)}})


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_contract_and_layouts(dtype):
    rng = np.random.default_rng(11)
    la, lb, lc = tten.contraction_layouts(3, (2,), (0, 1), 2, (0,), (1,))
    jl = jten.contraction_layouts(3, (2,), (0, 1), 2, (0,), (1,))
    assert [(m.map1, m.map2) for m in (la, lb, lc)] == [(m.map1, m.map2) for m in jl]
    aj, at = rand_pair([[2, 2], [3], [2, 1]], 0.9, rng, (3, la.map1, la.map2), dtype)
    bj, bt = rand_pair([[2, 1], [4]], 1.0, rng, (2, lb.map1, lb.map2), dtype)
    assert at.with_layout(la) is at and bt.with_layout(lb) is bt
    kw = dict(contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,), notcontract_2=(1,))
    with both():
        with jten.BatchedContract() as bcj:
            oj = bcj.contract(aj, bj, **kw)
        with tten.BatchedContract() as bc:
            o1 = bc.contract(at, bt, **kw)
            o2 = bc.contract(at, bt, **kw)
            assert len(bc._tas._cache) == 1
        once = tten.contract(1.0, at, bt, nsplit=1, **kw)
    assert_same(oj, o1, dtype)
    assert torch.equal(o1.matrix.data, o2.matrix.data)
    np.testing.assert_array_equal(once.matrix.index.col_idx, o1.matrix.index.col_idx)
    assert rel_err(o1.matrix.flat_host(), once.matrix.flat_host()) <= RTOL[dtype]


def test_contract_rejects():
    rng = np.random.default_rng(12)
    _, at = rand_pair([[2, 2], [3]], 0.9, rng)
    _, bt = rand_pair([[2], [3]], 0.9, rng)
    kw = dict(contract_1=(1,), notcontract_1=(0,), contract_2=(1,), notcontract_2=(0,))
    with pytest.raises(dtt.DbcsrError):
        tten.contract(1.0, at, at, contract_1=(0,), notcontract_1=(1,),
                      contract_2=(1,), notcontract_2=(0,))
    # dist is ported since: the folded product runs over the grid's ranks
    from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist

    grid = ProcessGrid.make(2, 2, devices=[torch.device("cpu")] * 4)
    d = block_cyclic_dist(grid, 2, 1)
    with torch_override(tile_size=T):
        got = tten.contract(1.0, at, bt, nsplit=1, dist=d, **kw)
        ref = tten.contract(1.0, at, bt, nsplit=1, **kw)
    assert torch.allclose(got.to_dense(), ref.to_dense(), rtol=1e-12, atol=1e-12)


# ---- random layouts (bounded hypothesis) ----------------------------------------

def _rand_mapping(rng, ndim):
    dims = list(rng.permutation(ndim))
    h = int(rng.integers(1, ndim))
    return (ndim, tuple(int(d) for d in dims[:h]), tuple(int(d) for d in dims[h:]))


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 999))
def test_contract_random_layouts_vs_einsum(seed):
    rng = np.random.default_rng(seed)
    bs = [np.asarray(rng.integers(1, 4, size=2), np.int32) for _ in range(4)]
    aj, at = rand_pair(bs[:3], 0.8, rng, _rand_mapping(rng, 3))
    bj, bt = rand_pair([bs[2], bs[3]], 0.8, rng, _rand_mapping(rng, 2))
    oj, ot = contract_both(aj, at, bj, bt, contract_1=(2,), notcontract_1=(0, 1),
                           contract_2=(0,), notcontract_2=(1,))
    assert_same(oj, ot, np.float64)
    ref = np.einsum("ijk,kl->ijl", at.to_dense().numpy(), bt.to_dense().numpy())
    np.testing.assert_allclose(ot.to_dense().numpy(), ref, atol=1e-10)


# ---- the RI-type 3-center contraction of chip_smoke.py phase 11 ---------------------

def ri_pair(n_atoms, dtype):
    sys.path.insert(0, REPO)
    import chip_smoke

    ao, ri, a_idx, b_idx = chip_smoke.ri_pattern(n_atoms)
    rng = np.random.default_rng(0)
    la, lb, _ = jten.contraction_layouts(3, (2,), (0, 1), 2, (0,), (1,))
    out = []
    for bs, idx, lay in (([ao, ao, ri], a_idx, la), ([ri, ri], b_idx, lb)):
        builder = jten.TensorBuilder(bs, lay, dtype=dtype)
        for bi in idx:
            builder.put_block(bi, rng.standard_normal(tuple(int(bs[d][bi[d]])
                                                            for d in range(len(bs)))))
        with jax_override(tile_size=T):
            tj = builder.finalize()
        out.append((tj, carry(tj)))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_ri_3center_small(dtype):
    (aj, at), (bj, bt) = ri_pair(12, dtype)
    kw = dict(contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,), notcontract_2=(1,))
    for nsplit in (1, 4):
        oj, ot = contract_both(aj, at, bj, bt, nsplit=nsplit, **kw)
        assert_same(oj, ot, dtype)
    with tten.BatchedContract() as bc, both():
        ob = bc.contract(at, bt, **kw)
    assert rel_err(ob.matrix.flat_host(), oj.matrix.flat_host()) <= RTOL[dtype]
    # the k-long leg: C(P,Q) = sum_{mu nu} A(mu,nu,P) A(mu,nu,Q)
    kj, kt = contract_both(aj, at, aj, at, nsplit=4, contract_1=(0, 1), notcontract_1=(2,),
                           contract_2=(0, 1), notcontract_2=(2,))
    assert_same(kj, kt, dtype)
