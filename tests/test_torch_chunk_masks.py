"""The float64 stack kernel's K occupancy masks (``mm/f64_stack.py``), on
the CPU:

- ``tile_chunk_masks`` equals the nonzero depth structure of a dense
  store built from the same pattern, for T = 64 and 128, with block sizes
  1, 5, 13 and 23 straddling depth and tile edges, and
  ``operand_chunk_masks`` that of op(A)'s columns and op(B)'s rows for
  'N' and 'T';
- on the benchmark's water pattern at 2 × 2 × 2 cells, the masks equal
  the dense store's, and the plain float64 product with every masked-out
  depth zeroed is equal to the full plain product;
- the plan's ``hw_flops`` is 2·T²·8 times the depths set in both tiles of
  every entry, and the tile figure (``padded_flops``) when every mask is
  full.
"""
import json
import os

import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.block.index import build_index
from dbcsr_tpu_torch.block.store import store_layout
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.core.stats import get_stats, print_statistics, reset_stats
from dbcsr_tpu_torch.mm.f64_stack import (
    MMA_DEPTH,
    chunked_hw_flops,
    operand_chunk_masks,
    tile_chunk_masks,
    tile_stack_matmul_f64_plain,
)
from dbcsr_tpu_torch.mm.kernels import device_stack
from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores
from dbcsr_tpu_torch.testing import matrix_from_arrays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mixed_pattern(seed, n_blocks=60, occ=0.15):
    """Block sizes drawn from 1, 5, 13 and 23 (rows of 23 straddle every
    depth and, at T = 64, tile edges), a random pattern over them."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice([1, 5, 13, 23], n_blocks).astype(np.int32)
    keep = rng.random((n_blocks, n_blocks)) < occ
    rows, cols = np.nonzero(keep)
    return sizes, rows.astype(np.int32), cols.astype(np.int32)


def random_matrix(sizes, rows, cols, tile, seed):
    """The port's float64 matrix over the pattern, every stored element
    nonzero."""
    index, _ = build_index(rows, cols, sizes, sizes)
    lay = store_layout(index, tile)
    flat = np.random.default_rng(seed).uniform(1.0, 2.0, index.nelems)
    return matrix_from_arrays(sizes, sizes, index.blk_rows, index.col_idx,
                              lay.store_from_flat(flat), device="cpu")


def depth_bits(nonzero_lines: np.ndarray) -> np.ndarray:
    """[n, T] bool -> int32 [n]: bit h iff a line of depth h is nonzero."""
    n, t = nonzero_lines.shape
    per = nonzero_lines.reshape(n, t // MMA_DEPTH, MMA_DEPTH).any(axis=2)
    return (per.astype(np.int64) << np.arange(t // MMA_DEPTH)).sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_masks_equal_the_dense_store(tile, seed):
    sizes, rows, cols = mixed_pattern(seed)
    m = random_matrix(sizes, rows, cols, tile, seed)
    store = m.data.numpy()
    got_rows, got_cols = tile_chunk_masks(m.index, tile)
    assert got_rows.dtype == got_cols.dtype == np.int32
    np.testing.assert_array_equal(got_rows, depth_bits(np.any(store != 0, axis=2)))
    np.testing.assert_array_equal(got_cols, depth_bits(np.any(store != 0, axis=1)))
    # some tile is partly empty, or the test would show nothing
    assert np.any(got_cols != (1 << (tile // MMA_DEPTH)) - 1)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("trans", ["N", "T"])
def test_operand_masks_follow_the_op_store(tile, trans):
    from dbcsr_tpu_torch.mm.engine import _op_pattern, _op_store

    sizes, rows, cols = mixed_pattern(2)
    m = random_matrix(sizes, rows, cols, tile, 2)
    op = _op_pattern(m, trans == "T")
    perm = None if op.perm is None else torch.as_tensor(op.perm.astype(np.int64))
    store = _op_store(m.data, perm).numpy()
    a_mask = operand_chunk_masks(m.index, tile, trans == "T", op.perm, "a")
    b_mask = operand_chunk_masks(m.index, tile, trans == "T", op.perm, "b")
    np.testing.assert_array_equal(a_mask, depth_bits(np.any(store != 0, axis=1)))
    np.testing.assert_array_equal(b_mask, depth_bits(np.any(store != 0, axis=2)))


@pytest.fixture(scope="module")
def water():
    """A over the water pattern of the benchmark's configuration at the
    fewest cells its 8 Å cutoff admits (2 × 2 × 2: the pattern refuses a
    box under twice the cutoff), T = 128: its index, store layout and a host
    store (nonzero on every stored element). The pattern comes through
    ``benchmark.operands.pattern_of(cfg)`` alone, the benchmark's one entry
    point that the port's tools and tests read."""
    from benchmark.operands import pattern_of

    with open(os.path.join(REPO, "benchmark", "configs", "water_2048.json")) as f:
        cfg = json.load(f)
    cfg["replicas"] = [2, 2, 2]
    blocks = pattern_of(cfg).blocks
    sizes = blocks.row_sizes.astype(np.int32)
    index, _ = build_index(blocks.rows.astype(np.int32), blocks.cols.astype(np.int32),
                           sizes, sizes)
    lay = store_layout(index, 128)
    store = lay.store_from_flat(np.random.default_rng(1).uniform(1.0, 2.0, index.nelems))
    return index, lay, store


def test_tile_masks_equal_the_dense_store_on_water(water):
    index, lay, store = water
    got_rows, got_cols = tile_chunk_masks(index, 128)
    np.testing.assert_array_equal(got_rows, depth_bits(np.any(store != 0, axis=2)))
    np.testing.assert_array_equal(got_cols, depth_bits(np.any(store != 0, axis=1)))
    assert np.any(got_cols != 0xFFFF) and np.any(got_rows != 0xFFFF)


def test_masked_product_equals_the_full_product_on_water(water):
    """Every 200th C tile of A·A, each with its whole run (≈ 46 entries):
    the plain product with each entry's A columns and B rows zeroed outside
    the depths set in both its tiles' masks (the depths the kernel issues)
    is equal to the full plain product."""
    tile = 128
    index, lay, store = water
    grid = (lay.ntr, lay.ntc)
    plan = plan_tile_stacks_stores(lay.tile_coords, grid, lay.tile_coords, grid)
    sub = plan.stack[np.isin(plan.stack[:, 0], np.arange(0, plan.n_c_tiles, 200))]
    c = np.unique(sub[:, 0], return_inverse=True)[1]
    n_c = int(c.max()) + 1
    ia, ib = sub[:, 1], sub[:, 2]
    a = torch.from_numpy(store[ia])
    b = torch.from_numpy(store[ib])
    both = (operand_chunk_masks(index, tile, False, None, "a")[ia]
            & operand_chunk_masks(index, tile, False, None, "b")[ib])
    issued = torch.from_numpy(
        ((both[:, None] >> np.arange(tile // MMA_DEPTH)) & 1).repeat(MMA_DEPTH, axis=1) > 0)
    one_each = np.arange(len(sub))
    stack = device_stack(np.stack([c, one_each, one_each], axis=1), n_c, "cpu")
    want = tile_stack_matmul_f64_plain(a, b, stack)
    got = tile_stack_matmul_f64_plain(a.masked_fill(~issued[:, None, :], 0),
                                      b.masked_fill(~issued[:, :, None], 0), stack)
    assert torch.equal(got, want)
    assert not bool(issued.all())  # some depths are skipped


@pytest.mark.parametrize("tile", [64, 128])
def test_hw_flops_count_the_issued_depths(tile):
    sizes, rows, cols = mixed_pattern(4)
    a = random_matrix(sizes, rows, cols, tile, 4)
    b = random_matrix(sizes, rows, cols, tile, 5)
    with config_override(tile_size=tile, mm_driver="stack"):
        fn, _, _ = dtt.build_multiply_executor("N", "N", a, b)
    lp = fn.plan
    assert lp.route == "f64_stack"
    st = lp.tile_plan.stack
    pop = np.array([bin(int(x)).count("1") for x in
                    lp.stack.a_chunks.numpy()[st[:, 1]] & lp.stack.b_chunks.numpy()[st[:, 2]]])
    assert lp.hw_flops == 2.0 * tile * tile * MMA_DEPTH * pop.sum()
    assert lp.padded_flops == 2.0 * len(st) * tile**3 > lp.hw_flops
    reset_stats()
    fn(a.data, b.data)
    s = get_stats()
    assert (s.hardware_flops, s.padded_flops) == (lp.hw_flops, lp.padded_flops)
    skipped = 1.0 - lp.hw_flops / lp.padded_flops
    assert f" tile work skipped        {skipped:.3f}" in print_statistics()
    # with every mask full the count is the tile figure
    full = np.full(len(st), (1 << (tile // MMA_DEPTH)) - 1, np.int32)
    assert chunked_hw_flops(full, full, st[:, 1], st[:, 2], tile) == lp.padded_flops


def test_full_tiles_issue_every_depth():
    """A pattern whose tiles are full (one block a tile) gets all-ones masks
    and the tile figure."""
    tile = 64
    sizes = np.full(4, tile, np.int32)
    rows, cols = np.nonzero(np.eye(4) + np.eye(4, k=1))
    a = random_matrix(sizes, rows.astype(np.int32), cols.astype(np.int32), tile, 0)
    with config_override(tile_size=tile, mm_driver="stack"):
        fn, _, _ = dtt.build_multiply_executor("N", "T", a, a)
    assert fn.plan.route == "f64_stack"
    assert np.all(fn.plan.stack.a_chunks.numpy() == 0xFF)
    assert fn.plan.hw_flops == fn.plan.padded_flops


@pytest.mark.parametrize("tile", [16, 32])
def test_small_tiles_carry_no_masks(tile):
    sizes, rows, cols = mixed_pattern(3)
    a = random_matrix(sizes, rows, cols, tile, 3)
    with config_override(tile_size=tile, mm_driver="stack"):
        fn, _, _ = dtt.build_multiply_executor("N", "N", a, a)
    assert fn.plan.route == "f64_stack" and fn.plan.stack.a_chunks is None
    assert fn.plan.hw_flops == fn.plan.padded_flops
