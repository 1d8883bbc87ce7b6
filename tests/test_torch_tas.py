"""Port parity, ``tas/``: splits, block-subset extraction, both merges,
``tas_multiply`` in every orientation and split, the split estimate, the
result-index estimate and ``BatchedTAS``, against dbcsr_tpu on the same
matrices (built in the JAX package from a seed, carried into the port by
``matrix_from_arrays``); plus the prepared gathers the port adds.

Block indices, C's index, ``(long_dim, nsplit)`` and ``eff_flops`` must be
identical. Values: extraction and merge move elements, so they are equal
bit for bit; products agree within 1e-12 (float64: the JAX side at
``f64_method="native"``) or 1e-5 (float32 at "highest") of the largest
reference entry — the same products summed in another order.
"""
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
import dbcsr_tpu.tas as jtas
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
import dbcsr_tpu_torch.tas as ttas
from dbcsr_tpu_torch.block.gather import (
    apply_prepared_gather,
    apply_store_gather,
    block_permutation_gather,
    flat_gather_store_map,
    prepare_flat_gather,
)
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.mm.plancache import PlanCache, get_plan_cache
from dbcsr_tpu_torch.testing import matrix_from_arrays

torch.set_num_threads(1)

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


def carry(mj):
    return matrix_from_arrays(
        mj.row_block_sizes, mj.col_block_sizes, mj.index.blk_rows,
        mj.index.col_idx, np.asarray(mj.data), device="cpu", name=mj.name,
    )


def bs(n, rng):
    return djax.random_block_sizes(n, [2, 3, 5], rng)


def mat(rbs, cbs, occ, rng, dtype, name="M"):
    with jax_override(tile_size=T):
        mj = djax.random_matrix(rbs, cbs, occ, rng, dtype=dtype, name=name)
    return mj, carry(mj)


def assert_same(mj, mt, dtype, exact=False):
    np.testing.assert_array_equal(mj.index.row_ptr, mt.index.row_ptr)
    np.testing.assert_array_equal(mj.index.col_idx, mt.index.col_idx)
    np.testing.assert_array_equal(mj.row_block_sizes, mt.row_block_sizes)
    np.testing.assert_array_equal(mj.col_block_sizes, mt.col_block_sizes)
    assert mt.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    if exact:
        np.testing.assert_array_equal(mt.flat_host(), mj.flat_host())
    else:
        assert rel_err(mt.flat_host(), mj.flat_host()) <= RTOL[dtype]


# ---- splits ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cyclic", "contiguous", "trivial"])
@pytest.mark.parametrize("rowcol,nblk,nsplit", [("R", 10, 3), ("C", 17, 4)])
def test_split_maps(kind, rowcol, nblk, nsplit):
    args = (rowcol, nblk) if kind == "trivial" else (rowcol, nblk, nsplit)
    sj = getattr(jtas.TASSplit, kind)(*args)
    st = getattr(ttas.TASSplit, kind)(*args)
    assert (st.rowcol, st.nsplit, st.nblk_long) == (sj.rowcol, sj.nsplit, sj.nblk_long)
    np.testing.assert_array_equal(st.group_of_block, sj.group_of_block)
    np.testing.assert_array_equal(st.local_of_global(), sj.local_of_global())
    for g in range(st.nsplit):
        np.testing.assert_array_equal(st.blocks_of_group(g), sj.blocks_of_group(g))


def test_tas_from_matrix_and_groups():
    rng = np.random.default_rng(13)
    mj, mt = mat(bs(50, rng), bs(4, rng), 0.3, rng, np.float64)
    tj, tt = jtas.tas_from_matrix(mj, nsplit=4), ttas.tas_from_matrix(mt, nsplit=4)
    assert (tt.split.rowcol, tt.nsplit, tt.shape) == (tj.split.rowcol, tj.nsplit, tj.shape)
    for g in range(4):
        (sj, bj), (st, bt) = tj.group_matrix(g), tt.group_matrix(g)
        np.testing.assert_array_equal(bt, bj)
        assert_same(sj, st, np.float64, exact=True)
    wide = ttas.tas_from_matrix(dtt.transpose(mt), nsplit=4)
    assert wide.split.rowcol == "C"
    assert wide.with_split(ttas.TASSplit.trivial("C", mt.nblkrows)).nsplit == 1


# ---- extraction and merge ----------------------------------------------------

@pytest.mark.parametrize("which", ["rows", "cols", "both"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_block_subset(dtype, which):
    rng = np.random.default_rng(11)
    mj, mt = mat(bs(150, rng), bs(45, rng), 0.5, rng, dtype)
    rows = np.array([1, 3, 7, 20, 21, 39], dtype=np.int32)
    cols = np.array([0, 2, 5, 11], dtype=np.int32)
    kw = {"rows": dict(row_blocks=rows), "cols": dict(col_blocks=cols),
          "both": dict(row_blocks=rows, col_blocks=cols)}[which]
    with both():
        sj = jtas.extract_block_subset(mj, **kw)
        st = ttas.extract_block_subset(mt, **kw)
        again = ttas.extract_block_subset(mt, **kw)  # the cached gather
    assert_same(sj, st, dtype, exact=True)
    assert again.index is st.index and torch.equal(again.data, st.data)
    # an empty selection keeps the block sizes and stores nothing
    st0 = ttas.extract_block_subset(mt, row_blocks=np.array([], np.int32))
    assert st0.nblks == 0 and st0.data.shape == (0, T, T)


@pytest.mark.parametrize("rowcol", ["R", "C"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_groups(dtype, rowcol):
    rng = np.random.default_rng(12)
    mj, mt = mat(bs(30, rng), bs(25, rng), 0.4, rng, dtype)
    nblk = mt.nblkrows if rowcol == "R" else mt.nblkcols
    split = ttas.TASSplit.cyclic(rowcol, nblk, 3)
    key = "row_blocks" if rowcol == "R" else "col_blocks"
    with both():
        pj = [(jtas.extract_block_subset(mj, **{key: split.blocks_of_group(g)}),
               split.blocks_of_group(g)) for g in range(3)]
        pt = [(ttas.extract_block_subset(mt, **{key: split.blocks_of_group(g)}),
               split.blocks_of_group(g)) for g in range(3)]
        merge_j = jtas.matrix.merge_row_groups if rowcol == "R" else jtas.matrix.merge_col_groups
        merge_t = ttas.merge_row_groups if rowcol == "R" else ttas.merge_col_groups
        rj = merge_j(pj, mj.row_block_sizes, mj.col_block_sizes)
        rt = merge_t(pt, mt.row_block_sizes, mt.col_block_sizes)
    assert_same(rj, rt, dtype, exact=True)
    assert_same(mj, rt, dtype, exact=True)  # the groups tile the matrix
    np.testing.assert_array_equal(rt.data.numpy(), np.asarray(rj.data))


def test_merge_writes_equal_the_sum_of_parts():
    """The merge writes each disjoint part into one store where the JAX
    package sums full-size per-part stores: the two are bitwise equal, a
    -0.0 entry included (the sum turns it into +0.0, and so does the
    merge)."""
    rng = np.random.default_rng(3)
    _, mt = mat(bs(24, rng), bs(9, rng), 0.5, rng, np.float32)
    data = mt.data.clone()
    data[data != 0] = torch.where(data[data != 0] > 1.0, -0.0, data[data != 0])
    mt = mt.with_data(data)
    split = ttas.TASSplit.cyclic("R", mt.nblkrows, 4)
    parts = [(ttas.extract_block_subset(mt, row_blocks=split.blocks_of_group(g)),
              split.blocks_of_group(g)) for g in range(4)]
    merged = ttas.merge_row_groups(parts, mt.row_block_sizes, mt.col_block_sizes)
    summed = None
    for sub, blocks in parts:
        own = ttas.merge_row_groups([(sub, blocks)], mt.row_block_sizes,
                                    mt.col_block_sizes)
        contrib = dtt.ops.arithmetic._align_to(merged.layout.tile_keys(), own)
        summed = contrib if summed is None else summed + contrib
    assert bool((data.view(torch.int32) == torch.tensor(-0.0).view(torch.int32)).any())
    assert torch.equal(merged.data.view(torch.int32), summed.view(torch.int32))


def test_prepared_gather_is_bitwise_apply_store_gather():
    """The prepared device form of a flat map (composed per element) gives
    the bits of the one-call gather through the store map composed over the
    whole new store."""
    rng = np.random.default_rng(4)
    for dtype in DTYPES:
        _, mt = mat(bs(30, rng), bs(20, rng), 0.4, rng, dtype)
        sub = ttas.extract_block_subset(mt, row_blocks=np.arange(0, mt.nblkrows, 2))
        # the subset's map, composed as extraction composes it
        src_blks = np.asarray([mt.index.block_id(2 * int(r), int(c)) for r, c in
                               zip(sub.index.blk_rows, sub.index.col_idx)])
        gmap = block_permutation_gather(sub.index, mt.index, src_blks)
        inv = flat_gather_store_map(sub.index, T, mt.layout, gmap)
        n = sub.layout.n_tiles
        ref = apply_store_gather(mt.data, inv, n, T)
        g = prepare_flat_gather(sub.index, T, mt, gmap)
        assert g.dst.dtype == torch.int32 and g.n_tiles == n
        assert g.nbytes == 8 * g.dst.numel()
        for got in (apply_prepared_gather(mt.data, g), sub.data):
            assert torch.equal(got.view(-1).view(torch.uint8), ref.view(-1).view(torch.uint8))


# ---- tas_multiply ----------------------------------------------------------

# the 6 orientation combos of tests/test_tas.py:53-63
ORIENTATIONS = [
    ("N", "N", 40, 6, 7),   # m long
    ("T", "N", 7, 40, 6),   # k long
    ("N", "T", 6, 7, 40),   # n long
    ("T", "T", 40, 6, 7),   # m long, both transposed
    ("N", "N", 6, 40, 7),   # k long
    ("T", "N", 6, 7, 44),   # n long
]


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("transa,transb,m,k,n", ORIENTATIONS)
def test_tas_multiply_orientations(transa, transb, m, k, n, nsplit):
    rng = np.random.default_rng(1000 * m + 100 * k + n + (transa == "T") + 2 * (transb == "T"))
    mbs, kbs, nbs = bs(m, rng), bs(k, rng), bs(n, rng)
    aj, at = mat(kbs if transa == "T" else mbs, mbs if transa == "T" else kbs,
                 0.4, rng, np.float64, "A")
    bj, bt = mat(nbs if transb == "T" else kbs, kbs if transb == "T" else nbs,
                 0.4, rng, np.float64, "B")
    with both():
        oj, fj = jtas.tas_multiply(transa, transb, 1.5, aj, bj, nsplit=nsplit,
                                   return_flops=True)
        ot, ft = ttas.tas_multiply(transa, transb, 1.5, at, bt, nsplit=nsplit,
                                   return_flops=True)
    assert ft == fj
    assert (ot.split.rowcol, ot.nsplit) == (oj.split.rowcol, oj.nsplit)
    assert_same(oj.matrix, ot.matrix, np.float64)


@pytest.mark.parametrize("long_dim", ["m", "n"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tas_multiply_beta_c(dtype, long_dim):
    rng = np.random.default_rng(8)
    if long_dim == "m":
        mbs, kbs, nbs = bs(30, rng), bs(4, rng), bs(5, rng)
    else:
        mbs, kbs, nbs = bs(5, rng), bs(4, rng), bs(30, rng)
    aj, at = mat(mbs, kbs, 0.4, rng, dtype, "A")
    bj, bt = mat(kbs, nbs, 0.7, rng, dtype, "B")
    cj, ct = mat(mbs, nbs, 0.5, rng, dtype, "C")
    with both():
        oj, fj = jtas.tas_multiply("N", "N", 1.0, aj, bj, beta=0.5, c=cj, nsplit=4,
                                   return_flops=True)
        ot, ft = ttas.tas_multiply("N", "N", 1.0, at, bt, beta=0.5, c=ct, nsplit=4,
                                   return_flops=True)
    assert ft == fj
    assert_same(oj.matrix, ot.matrix, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tas_multiply_k_split_filter_eps(dtype):
    rng = np.random.default_rng(9)
    mbs, kbs, nbs = bs(5, rng), bs(50, rng), bs(6, rng)
    aj, at = mat(mbs, kbs, 0.4, rng, dtype, "A")  # k = 50 blocks long
    bj, bt = mat(kbs, nbs, 0.4, rng, dtype, "B")
    cj, ct = mat(mbs, nbs, 0.3, rng, dtype, "C")
    # eps at the median block norm of the unfiltered product, so that it bites
    with both():
        full = jtas.tas_multiply("N", "N", 1.0, aj, bj, nsplit=1).matrix
    eps = float(np.sqrt(np.median(np.asarray(djax.block_norms_sq(full)))))
    with both():
        oj, fj = jtas.tas_multiply("N", "N", 1.0, aj, bj, beta=-1.0, c=cj, nsplit=5,
                                   filter_eps=eps, return_flops=True)
        ot, ft = ttas.tas_multiply("N", "N", 1.0, at, bt, beta=-1.0, c=ct, nsplit=5,
                                   filter_eps=eps, return_flops=True)
    assert ft == fj
    assert 0 < ot.matrix.nblks < full.nblks
    assert_same(oj.matrix, ot.matrix, dtype)


@pytest.mark.parametrize("dims", [(100000, 100, 100), (10, 99999, 10), (10, 10, 10),
                                  (50, 60, 70000), (1, 0, 5)])
@pytest.mark.parametrize("occ", [1.0, 0.03, 1e-9])
def test_split_factor_estimate(dims, occ):
    assert (ttas.split_factor_estimate(*dims, occ_hint=occ)
            == jtas.split_factor_estimate(*dims, occ_hint=occ))


def test_tas_multiply_auto_split():
    rng = np.random.default_rng(7)
    mbs, kbs, nbs = bs(60, rng), bs(5, rng), bs(6, rng)
    aj, at = mat(mbs, kbs, 0.3, rng, np.float64, "A")
    bj, bt = mat(kbs, nbs, 0.8, rng, np.float64, "B")
    occ = max(at.occupation(), bt.occupation())
    m, k, n = (int(x.sum()) for x in (mbs, kbs, nbs))
    decision = ttas.split_factor_estimate(m, k, n, occ_hint=occ)
    assert decision == jtas.split_factor_estimate(m, k, n, occ_hint=occ)
    assert decision[0] == "m" and decision[1] > 1
    with both():
        oj, fj = jtas.tas_multiply("N", "N", 2.0, aj, bj, return_flops=True)
        ot, ft = ttas.tas_multiply("N", "N", 2.0, at, bt, return_flops=True)
    assert ft == fj > 0
    assert_same(oj.matrix, ot.matrix, np.float64)


@pytest.mark.parametrize("filter_eps", [None, 0.5])
def test_result_index_estimate(filter_eps):
    rng = np.random.default_rng(10)
    mbs, kbs, nbs = bs(20, rng), bs(6, rng), bs(8, rng)
    aj, at = mat(mbs, kbs, 0.3, rng, np.float32, "A")
    bj, bt = mat(kbs, nbs, 0.5, rng, np.float32, "B")
    with both():
        rj, cj, fj = jtas.result_index_estimate(aj, "N", bj, "N", filter_eps=filter_eps)
        rt, ct, ft = ttas.result_index_estimate(at, "N", bt, "N", filter_eps=filter_eps)
        out = ttas.tas_multiply("N", "N", 1.0, at, bt, nsplit=2).matrix
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ct, cj)
    assert ft == fj > 0
    if filter_eps is None:
        assert set(zip(rt.tolist(), ct.tolist())) == set(
            zip(out.index.blk_rows.tolist(), out.index.col_idx.tolist()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_tas_reuses_plan(dtype):
    rng = np.random.default_rng(12)
    mbs, kbs, nbs = bs(15, rng), bs(5, rng), bs(6, rng)
    aj, at = mat(mbs, kbs, 0.4, rng, dtype, "A")
    bj, bt = mat(kbs, nbs, 0.6, rng, dtype, "B")
    with both():
        with jtas.BatchedTAS() as bjx:
            rj = bjx.multiply("N", "N", aj, bj)
        with ttas.BatchedTAS() as batch:
            out1 = batch.multiply("N", "N", at, bt)
            # new data, same pattern -> the cached executor
            out2 = batch.multiply("N", "N", at.with_data(at.data * 2.0), bt)
            assert len(batch._cache) == 1
            batch.multiply("N", "T", at, dtt.transpose(bt))
            assert len(batch._cache) == 2
        assert len(batch._cache) == 0
    assert_same(rj, out1, dtype)
    assert torch.equal(out2.data, 2.0 * out1.data)


def test_unported_options_raise():
    rng = np.random.default_rng(14)
    _, at = mat(bs(12, rng), bs(4, rng), 0.5, rng, np.float64)
    # dist is ported since: the group multiply runs over the grid's ranks
    from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist

    grid = ProcessGrid.make(2, 2, devices=[torch.device("cpu")] * 4)
    d = block_cyclic_dist(grid, at.nblkrows, at.nblkrows)
    with torch_override(tile_size=T):
        got = ttas.tas_multiply("N", "T", 1.0, at, at, nsplit=1, dist=d).matrix
        ref = ttas.tas_multiply("N", "T", 1.0, at, at, nsplit=1).matrix
    assert np.array_equal(got.index.col_idx, ref.index.col_idx)
    assert torch.allclose(got.data, ref.data, rtol=1e-12, atol=1e-12)
    from dataclasses import replace

    # complex is ported since: extraction and merges move complex stores
    cplx = replace(at, data=at.data.to(torch.complex128) * 1j)
    sub = ttas.extract_block_subset(cplx, row_blocks=np.arange(3))
    assert torch.equal(sub.data, ttas.extract_block_subset(at, row_blocks=np.arange(3))
                       .data.to(torch.complex128) * 1j)
    merged = ttas.merge_row_groups([(cplx, np.arange(12))], at.row_block_sizes,
                                   at.col_block_sizes)
    assert merged.dtype == torch.complex128 and torch.equal(merged.data, cplx.data)
    empty = ttas.merge_row_groups([], at.row_block_sizes, at.col_block_sizes,
                                  device="cpu", dtype=torch.float64)
    assert empty.nblks == 0 and empty.dtype == torch.float64
    with pytest.raises(dtt.DbcsrError):
        ttas.merge_row_groups([], at.row_block_sizes, at.col_block_sizes)


def test_plan_cache_holds_the_prepared_gathers():
    rng = np.random.default_rng(15)
    kbs = bs(5, rng)
    _, at = mat(bs(20, rng), kbs, 0.5, rng, np.float32)
    _, bt = mat(kbs, bs(4, rng), 0.5, rng, np.float32)
    pc = get_plan_cache()
    pc.clear()
    ttas.tas_multiply("N", "N", 1.0, at, bt, nsplit=2)
    keys = [k[0] for k in pc._store if isinstance(k[0], str)]
    assert keys.count("extract_block_subset") == 2 and keys.count("merge_groups") == 1
    # every map's bytes are counted, and nothing else's
    gathers = [g for k, v in pc._store.items() if k[0] == "extract_block_subset"
               for g in [v[1]] if g is not None]
    gathers += [g for k, v in pc._store.items() if k[0] == "merge_groups" for g in v[1]]
    assert pc.nbytes == sum(g.nbytes for g in gathers) > 0


def test_plan_cache_byte_budget_evicts_sized_entries():
    """Over the budget, the least recently used entry that states a size
    goes (entries without one stay); an entry larger than the budget is not
    kept; replacing or dropping an entry hands its bytes back."""
    pc = PlanCache(max_bytes=100)
    pc.put("plan", 1)
    pc.put("a", 2, nbytes=40)
    pc.put("b", 3, nbytes=40)
    assert pc.get("a") == 2  # "b" is now the least recently used map
    pc.put("c", 4, nbytes=40)
    assert list(pc._store) == ["plan", "a", "c"] and pc.nbytes == 80
    pc.put("c", 5, nbytes=10)
    assert pc.nbytes == 50 and pc.get("c") == 5
    pc.put("huge", 6, nbytes=101)
    assert pc.get("huge") is None and pc.nbytes == 50
    pc.clear()
    assert pc.nbytes == 0 and not pc._store


@pytest.mark.parametrize("budget", [0, 20_000, 8 << 30])
def test_split_multiply_within_the_byte_budget(budget, monkeypatch):
    """A split multiply gives the same bits whatever its maps' budget, and
    the cache never holds more than the budget."""
    rng = np.random.default_rng(16)
    kbs = bs(5, rng)
    _, at = mat(bs(24, rng), kbs, 0.5, rng, np.float64)
    _, bt = mat(kbs, bs(4, rng), 0.5, rng, np.float64)
    pc = get_plan_cache()
    pc.clear()
    ref = ttas.tas_multiply("N", "N", 1.0, at, bt, nsplit=3).matrix
    full = pc.nbytes
    pc.clear()
    monkeypatch.setattr(pc, "max_bytes", budget)
    for _ in range(2):
        got = ttas.tas_multiply("N", "N", 1.0, at, bt, nsplit=3).matrix
        assert pc.nbytes <= budget
        assert torch.equal(got.data.view(torch.int64), ref.data.view(torch.int64))
    assert (pc.nbytes == full) == (budget >= full)
