"""Port parity, block layer: index, store layout, tile stores and the tile
operations of dbcsr_tpu_torch against dbcsr_tpu, built from one numpy seed.

Everything here is data movement or exact 0/1 arithmetic, so every
comparison is exact (bit-identical stores, equal index arrays)."""
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import dbcsr_tpu as djax
from dbcsr_tpu.block import gather as jgather
from dbcsr_tpu.block import tileops as jtileops
from dbcsr_tpu.core.config import config_override as jax_override

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.block import gather as tgather
from dbcsr_tpu_torch.block import tileops as ttileops
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.testing import matrix_from_arrays, to_numpy

torch.set_num_threads(1)


def both_tiles(tile):
    stack = ExitStack()
    stack.enter_context(jax_override(tile_size=tile))
    stack.enter_context(torch_override(tile_size=tile))
    return stack


def pair(seed, tile, dtype, occ=0.35, total=70, sizes=(2, 3, 5, 7)):
    """The same random matrix in both packages."""
    with both_tiles(tile):
        rbs = djax.random_block_sizes(total, list(sizes), np.random.default_rng(seed))
        rbs_t = dtt.random_block_sizes(total, list(sizes), np.random.default_rng(seed))
        np.testing.assert_array_equal(rbs, rbs_t)
        cbs = rbs[::-1].copy()
        mj = djax.random_matrix(rbs, cbs, occ, np.random.default_rng(seed + 1), dtype=dtype)
        mt = dtt.random_matrix(rbs, cbs, occ, np.random.default_rng(seed + 1),
                               dtype=dtype, device="cpu")
    return mj, mt


def assert_same_index(ij, it):
    for f in ("row_block_sizes", "col_block_sizes", "row_ptr", "col_idx", "blk_offset"):
        np.testing.assert_array_equal(getattr(ij, f), getattr(it, f), err_msg=f)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_matrix_bit_identical(tile, dtype):
    mj, mt = pair(3, tile, dtype)
    assert_same_index(mj.index, mt.index)
    lj, lt = mj.layout, mt.layout
    np.testing.assert_array_equal(lj.tile_coords, lt.tile_coords)
    np.testing.assert_array_equal(lj.tile_keys(), lt.tile_keys())
    np.testing.assert_array_equal(lj.elem_dest, lt.elem_dest)
    assert (lj.ntr, lj.ntc) == (lt.ntr, lt.ntc)
    assert mt.data.dtype == {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    np.testing.assert_array_equal(np.asarray(mj.data), mt.data.numpy())
    np.testing.assert_array_equal(np.asarray(mj.to_dense()), mt.to_dense().numpy())
    np.testing.assert_array_equal(mj.flat_host(), mt.flat_host())


def test_numpy_layout_path_matches_native():
    """The numpy store-layout fallback (no native planner) gives the same
    layout as the C++ planner."""
    _, mt = pair(5, 8, np.float64)
    with torch_override(use_native_planner=False):
        idx2, _ = dtt.build_index(mt.index.blk_rows, mt.index.col_idx,
                                  mt.row_block_sizes, mt.col_block_sizes)
        lay2 = dtt.block.store.store_layout(idx2, 8)
    np.testing.assert_array_equal(lay2.tile_coords, mt.layout.tile_coords)
    np.testing.assert_array_equal(lay2.elem_dest, mt.layout.elem_dest)


@pytest.mark.parametrize("tile", [8, 16])
def test_transpose_store(tile):
    mj, mt = pair(7, tile, np.float64)
    sj, cj = jtileops.transpose_store(mj.index, tile, mj.data)
    st, ct = ttileops.transpose_store(mt.index, tile, mt.data)
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert st.is_contiguous()


def test_take_tiles_with_sentinels():
    mj, mt = pair(11, 8, np.float32)
    n = mt.data.shape[0]
    rng = np.random.default_rng(0)
    slot_map = rng.integers(-1, n, 2 * n).astype(np.int32)
    slot_map[:3] = -1
    gj = jtileops.take_tiles(mj.data, slot_map, 8)
    gt = ttileops.take_tiles(mt.data, slot_map, 8)
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    assert not gt[:3].any()
    # identity alignment returns the store itself, no copy
    assert ttileops.take_tiles(mt.data, np.arange(n), 8) is mt.data
    # a complete map (no sentinel) is one gather
    perm = rng.permutation(n)[: n // 2].astype(np.int32)
    assert ttileops.tile_gather(perm, n, "cpu").complete
    np.testing.assert_array_equal(
        np.asarray(jtileops.take_tiles(mj.data, perm, 8)),
        ttileops.take_tiles(mt.data, perm, 8).numpy(),
    )
    assert ttileops.take_tiles(mt.data[:0], slot_map, 8).shape == (len(slot_map), 8, 8)


def test_tile_align_map_matches():
    rng = np.random.default_rng(1)
    src = np.unique(rng.integers(0, 200, 60)).astype(np.int64)
    dst = np.unique(rng.integers(0, 200, 80)).astype(np.int64)
    np.testing.assert_array_equal(
        jtileops.tile_align_map(dst, src), ttileops.tile_align_map(dst, src)
    )


@pytest.mark.parametrize("tile", [8, 16])
def test_valid_mask_and_block_info(tile):
    mj, mt = pair(13, tile, np.float32)
    vj = np.asarray(jtileops.valid_mask(mj.index, tile))
    vt = ttileops.valid_mask(mt.index, tile, "cpu")
    np.testing.assert_array_equal(vj, vt.numpy())
    # the store is exactly zero wherever the mask is (padding-zero invariant)
    assert not mt.data[vt == 0].any()
    ij, it = jtileops.tile_block_info(mj.index, tile), ttileops.tile_block_info(mt.index, tile)
    np.testing.assert_array_equal(ij.K, it.K)
    np.testing.assert_array_equal(ij.bid, it.bid)
    # the cache is keyed by device as well as tile
    assert ttileops.valid_mask(mt.index, tile, torch.device("cpu")) is vt


def test_matrix_from_arrays_round_trip():
    mj, _ = pair(17, 8, np.float64)
    mt = matrix_from_arrays(
        mj.row_block_sizes, mj.col_block_sizes, mj.index.blk_rows,
        mj.index.col_idx, np.asarray(mj.data), device="cpu",
    )
    assert_same_index(mj.index, mt.index)
    np.testing.assert_array_equal(np.asarray(mj.to_dense()), mt.to_dense().numpy())
    with pytest.raises(dtt.DbcsrError):
        matrix_from_arrays(
            mj.row_block_sizes, mj.col_block_sizes, mj.index.blk_rows,
            mj.index.col_idx, np.asarray(mj.data)[1:], device="cpu",
        )


def test_block_access_and_builder():
    mj, mt = pair(19, 8, np.float64)
    for r, c, blk in list(mt.iter_blocks())[:20]:
        np.testing.assert_array_equal(blk, mj.get_block(r, c))
        np.testing.assert_array_equal(mt.get_block(r, c), blk)
    assert mt.get_block(0, mt.nblkcols - 1) is None or mt.index.block_id(0, mt.nblkcols - 1) >= 0
    bj = djax.BCSRBuilder(mj.row_block_sizes, mj.col_block_sizes, dtype=np.float64, tile=8)
    bt = dtt.BCSRBuilder(mj.row_block_sizes, mj.col_block_sizes, dtype=np.float64,
                         tile=8, device="cpu")
    for r, c, blk in mt.iter_blocks():
        for b in (bj, bt):
            b.put_block(r, c, blk)
            b.put_block(r, c, blk, sum=True)
    fj, ft = bj.finalize(), bt.finalize()
    np.testing.assert_array_equal(np.asarray(fj.data), ft.data.numpy())
    again = mt.with_flat(mt.flat_host() * 2.0)
    np.testing.assert_array_equal(again.data.numpy(), 2.0 * mt.data.numpy())


def test_bf16_store_and_dense_conversion():
    _, m64 = pair(23, 8, np.float64)
    _, m32 = pair(23, 8, np.float32)
    mb = dtt.random_matrix(m32.row_block_sizes, m32.col_block_sizes, 0.35,
                           np.random.default_rng(24), dtype=torch.bfloat16,
                           device="cpu", tile=8)
    assert mb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        to_numpy(mb.data),
        m32.data.to(torch.bfloat16).float().numpy(),
    )
    d = dtt.make_dense(m64)
    assert d.nblks == 1
    np.testing.assert_array_equal(d.to_dense().numpy(), m64.to_dense().numpy())
    back = dtt.make_undense(d, m64.row_block_sizes, m64.col_block_sizes)
    np.testing.assert_array_equal(back.to_dense().numpy(), m64.to_dense().numpy())


def test_flat_gather_transposition_matches():
    """Element-level gather maps (transpose through block permutation) are
    identical, and applying one gives the JAX package's store."""
    mj, mt = pair(29, 8, np.float64)
    tij, permj = mj.index.transposed()
    tit, permt = mt.index.transposed()
    assert_same_index(tij, tit)
    np.testing.assert_array_equal(permj, permt)
    tr = np.ones(tit.nblks, dtype=bool)
    gj = jgather.block_permutation_gather(tij, mj.index, permj, tr)
    gt = tgather.block_permutation_gather(tit, mt.index, permt, tr)
    np.testing.assert_array_equal(gj, gt)
    sj = jgather.apply_flat_gather(tij, 8, mj, gj)
    st = tgather.apply_flat_gather(tit, 8, mt, gt)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    keep = np.arange(mt.nblks) % 3 == 0
    np.testing.assert_array_equal(
        jgather.block_subset_gather(mj.index, keep),
        tgather.block_subset_gather(mt.index, keep),
    )


def test_symmetric_to_dense_matches():
    rbs = np.full(9, 3, dtype=np.int32)
    with both_tiles(8):
        mj = djax.random_matrix(rbs, rbs, 0.5, np.random.default_rng(31),
                                dtype=np.float64, sym="S")
        mt = dtt.random_matrix(rbs, rbs, 0.5, np.random.default_rng(31),
                               dtype=np.float64, sym="S", device="cpu")
    np.testing.assert_array_equal(np.asarray(mj.to_dense()), mt.to_dense().numpy())
