"""The eps filter's passes over a tile store's atom-block segments
(``block/tileops.py``: ``tile_block_sumsq``, ``keep_blocks`` and their
plain versions; the kernels of ``csrc/block_filter.cu`` run on a card
only, ``tests/test_torch_cuda.py``), as far as the CPU can hold them:

- the segment plan (``segment_tables``, ``device_block_info``) against
  ``tile_block_info``'s cells and the blocks' own rows and columns, on
  random patterns whose blocks span tile edges and on the water pattern;
- ``walk_sumsq``, a numpy rendering of the kernel's walk (its reads and its
  order of sums), against the plain version's indicator matmuls;
- the keep-zeroing against ``c_sup * block_mask_store(keep)``, and the
  filtered step's mask form against the same;
- the invariant the zeroing rests on: the superset product leaves every
  position no stored block covers at exact zero;
- the wrappers' refusals, and the CPU's plain route for every store type
  the kernels take (float32, bfloat16, float64, complex64, complex128).

Tolerance of the norms² (``rtol_z``): the kernel sums the float32 squares
of a cell's rows, then its columns, one after the other; the indicator
matmuls sum the same nonnegative terms (and exact zeros) in their own
order. Each order is within (h + w - 2)·u of the exact sum of a cell of h
rows and w columns (u = 2⁻²⁴), h, w ≤ T, so the two are within 4·T·u of
each other, relative to the sum.
"""
import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.block.store import store_layout
from dbcsr_tpu_torch.block.tileops import (
    block_mask_store,
    device_block_info,
    keep_blocks,
    keep_blocks_plain,
    segment_bounds,
    slots_block_info,
    tile_block_info,
    tile_block_sumsq,
    tile_block_sumsq_plain,
    valid_mask,
)
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.core.stats import get_stats, print_statistics, reset_stats

from torch_mp_worker import water_case

CPU = torch.device("cpu")


def rtol_z(tile: int) -> float:
    return 4 * tile * 2.0 ** -24


def random_case(seed, tile, dtype=np.float64, sizes=(3, 13, 20, 40), total=160, occ=0.3,
                data_seed=None):
    """A random square matrix whose blocks (of ``sizes``, drawn from ``seed``)
    span tile edges; its pattern and data from ``data_seed`` (``seed``)."""
    rng = np.random.default_rng(seed)
    with config_override(tile_size=tile):
        rbs = dtt.random_block_sizes(total, list(sizes), rng)
        if data_seed is not None:
            rng = np.random.default_rng(data_seed)
        return dtt.random_matrix(rbs, rbs, occ, rng, dtype=dtype, device="cpu")


def as_store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A tile store ``x`` in ``dtype``; a complex one gets a random imaginary
    part (seed 0) wherever ``x`` is not 0, so its padding stays 0."""
    if not dtype.is_complex:
        return x.to(dtype).contiguous()
    im = torch.as_tensor(np.random.default_rng(0).standard_normal(x.shape), device=x.device)
    return torch.complex(x.double(), im * (x != 0)).to(dtype)


def kernel_squares(store: torch.Tensor) -> np.ndarray:
    """The kernel's squares, float32: ``x·x`` in the store's precision (a
    bfloat16 square rounded to bfloat16, as torch multiplies), ``re·re +
    im·im`` in the parts' precision for a complex store, each product and
    the sum rounded, then rounded to float32."""
    if store.is_complex():
        x = torch.view_as_real(store).numpy()
        return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]).astype(np.float32)
    return (store * store).float().numpy()


def walk_sumsq(store: torch.Tensor, info) -> np.ndarray:
    """``block_sumsq_kernel`` in numpy: for each stored cell, the float32
    squares of its rows added in row order, column by column, then the
    columns' partials added in column order; 0 for a cell with no block.
    The kernel's float32 adds round as numpy's do, so the two agree bit
    for bit."""
    sq = kernel_squares(store)
    T = store.shape[1]
    bid = info.bid_p1.numpy()
    rseg, cseg = info.rseg.numpy(), info.cseg.numpy()
    rows, cols = info.rows.numpy(), info.cols.numpy()
    n, amax, bmax = bid.shape
    z = np.zeros((n, amax, bmax), np.float32)
    for t in range(n):
        rs, cs = rseg[rows[t]], cseg[cols[t]]
        for a in range(amax):
            if not (bid[t, a] > 0).any():
                continue
            part = np.cumsum(sq[t, rs[a]:rs[a + 1]], axis=0, dtype=np.float32)[-1] \
                if rs[a + 1] > rs[a] else np.zeros(T, np.float32)
            for b in np.flatnonzero(bid[t, a] > 0):
                z[t, a, b] = np.cumsum(part[cs[b]:cs[b + 1]], dtype=np.float32)[-1]
    return z


def cell_rectangles(index, tile):
    """For every stored (tile, a, b) cell of ``tile_block_info``: the tile, the
    block, and the block's rows and columns inside that tile, from the
    block's own offsets."""
    info = tile_block_info(index, tile)
    coords = store_layout(index, tile).tile_coords.astype(np.int64)
    t, a, b = np.nonzero(info.bid >= 0)
    blk = info.bid[t, a, b]
    r0 = index.row_offsets[index.blk_rows[blk]] - coords[t, 0] * tile
    c0 = index.col_offsets[index.col_idx[blk]] - coords[t, 1] * tile
    m, n = (x.astype(np.int64)[blk] for x in index.blk_shapes)
    return (t, a, b, blk, np.maximum(r0, 0), np.minimum(r0 + m, tile),
            np.maximum(c0, 0), np.minimum(c0 + n, tile))


def cases():
    for tile in (16, 32):
        for seed in (1, 2):
            yield pytest.param("random", seed, tile, id=f"random-{seed}-T{tile}")
    yield pytest.param("random_fine", 3, 64, id="random_fine-3-T64")
    yield pytest.param("water", 5, 32, id="water-5-T32")


def matrix_of(kind, seed, tile):
    if kind == "water":
        return water_case((1, 1, 1), tile, seed)[2]
    if kind == "random_fine":  # many small segments a tile, and blocks past 2 tiles
        return random_case(seed, tile, sizes=(1, 2, 5, 13, 150), total=400, occ=0.15)
    return random_case(seed, tile)


@pytest.mark.parametrize("kind,seed,tile", list(cases()))
def test_segment_plan_matches_tile_block_info(kind, seed, tile):
    m = matrix_of(kind, seed, tile)
    idx = m.index
    info = device_block_info(idx, tile, CPU)
    tb = tile_block_info(idx, tile)
    rseg, cseg = info.rseg.numpy(), info.cseg.numpy()
    # bounds start at 0, never fall, and end at the tile row's last real row
    for seg, sizes in ((rseg, idx.row_block_sizes), (cseg, idx.col_block_sizes)):
        total = int(np.sum(sizes))
        assert (seg[:, 0] == 0).all() and (np.diff(seg, axis=1) >= 0).all()
        ends = np.minimum(tile, total - tile * np.arange(len(seg)))
        np.testing.assert_array_equal(seg[:, -1], ends)
    assert seg.dtype == np.int32
    np.testing.assert_array_equal(info.bid_p1.numpy(), tb.bid + 1)
    coords = store_layout(idx, tile).tile_coords
    np.testing.assert_array_equal(info.rows.numpy(), coords[:, 0])
    np.testing.assert_array_equal(info.cols.numpy(), coords[:, 1])
    # every stored cell's rectangle is its block's part of the tile
    t, a, b, blk, r0, r1, c0, c1 = cell_rectangles(idx, tile)
    assert (r1 > r0).all() and (c1 > c0).all()
    np.testing.assert_array_equal(rseg[coords[t, 0], a], r0)
    np.testing.assert_array_equal(rseg[coords[t, 0], a + 1], r1)
    np.testing.assert_array_equal(cseg[coords[t, 1], b], c0)
    np.testing.assert_array_equal(cseg[coords[t, 1], b + 1], c1)
    # the rectangles cover each block once
    m_, n_ = (x.astype(np.int64) for x in idx.blk_shapes)
    area = np.bincount(blk, weights=(r1 - r0) * (c1 - c0), minlength=idx.nblks)
    np.testing.assert_array_equal(area, m_ * n_)
    assert info.stored_elems == int((m_ * n_).sum())
    if kind != "water":
        assert (tb.bid >= 0).sum() > idx.nblks  # some blocks do span tile edges


def test_segment_bounds_of_indicators():
    J = np.zeros((2, 8, 3), np.float32)
    J[0, 0:3, 0] = J[0, 3:8, 1] = 1  # two segments
    J[1, 0:1, 0] = J[1, 1:5, 1] = J[1, 5:6, 2] = 1  # three, then 2 rows of padding
    np.testing.assert_array_equal(segment_bounds(J), [[0, 3, 8, 8], [0, 1, 5, 6]])


STORE_TYPES = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, torch.bfloat16, torch.complex64,
                                   torch.complex128])
@pytest.mark.parametrize("kind,seed,tile", list(cases()))
def test_kernel_walk_matches_plain(kind, seed, tile, dtype):
    m = matrix_of(kind, seed, tile)
    store = as_store(m.data, STORE_TYPES.get(dtype, dtype))
    info = device_block_info(m.index, tile, CPU)
    plain = tile_block_sumsq_plain(store, info).numpy()
    walk = walk_sumsq(store, info)
    stored = info.bid_p1.numpy() > 0
    assert stored.any()
    np.testing.assert_array_equal(plain[~stored], 0)  # padding is zero
    np.testing.assert_array_equal(walk[~stored], 0)
    np.testing.assert_allclose(walk[stored], plain[stored], rtol=rtol_z(tile), atol=0)
    # on the CPU the wrapper is the plain version
    assert torch.equal(tile_block_sumsq(store, info), torch.as_tensor(plain))


def eps_sq_at(nsq: torch.Tensor, q: float) -> float:
    """A float32 eps² between two block norms² at quantile ``q``."""
    v = np.sort(nsq.numpy().astype(np.float64))
    k = int(q * len(v))
    return float(np.float32(np.sqrt(v[k - 1] * v[k])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("kind,seed,tile", list(cases()))
def test_keep_zeroing_matches_mask_multiply(kind, seed, tile, dtype):
    m = matrix_of(kind, seed, tile)
    fn, c_index, _ = dtt.build_multiply_executor("N", "N", m, m)
    c_sup = as_store(fn(m.data, m.data), dtype)
    info = device_block_info(c_index, tile, CPU)
    nsq = info.block_sum(tile_block_sumsq(c_sup, info).reshape(-1))
    eps_sq = eps_sq_at(nsq, 0.5)
    ref_keep = (nsq >= eps_sq).to(torch.float32)
    ref = c_sup * block_mask_store(c_index, tile, CPU, keep=ref_keep).to(dtype)
    got = c_sup.clone()
    keep = keep_blocks(got, info, nsq, eps_sq)
    assert torch.equal(keep, ref_keep) and 0 < int(keep.sum()) < len(keep)
    assert torch.equal(got, ref)
    # kept blocks are untouched, bit for bit
    kept = block_mask_store(c_index, tile, CPU, keep=keep) > 0
    assert torch.equal(got[kept], c_sup[kept])
    again = c_sup.clone()
    assert torch.equal(keep_blocks_plain(again, info, nsq, eps_sq), keep)
    assert torch.equal(again, got)
    # independent of the indicators: the dropped blocks' rectangles, from
    # the blocks' own offsets, zeroed
    want = c_sup.clone()
    t, _, _, blk, r0, r1, c0, c1 = cell_rectangles(c_index, tile)
    for i in np.flatnonzero(keep.numpy()[blk] == 0):
        want[t[i], r0[i]:r1[i], c0[i]:c1[i]] = 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("driver", ["stack", "auto", "dense"])
@pytest.mark.parametrize("tile", [16, 32])
def test_superset_product_leaves_uncovered_positions_zero(tile, driver, dtype):
    """The zeroing writes only the dropped blocks: it rests on the superset
    product of stores with zero padding being exactly 0 wherever no stored
    block of C's superset lies."""
    a = random_case(11, tile, dtype)
    b = random_case(11, tile, dtype, data_seed=12)
    with config_override(tile_size=tile):
        fn, c_index, _ = dtt.build_multiply_executor("N", "N", a, b, driver=driver)
        c = fn(a.data, b.data)
    assert bool((c != 0).any())
    assert not bool(c[valid_mask(c_index, tile, CPU) == 0].any())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind,seed,tile", list(cases()))
def test_filtered_step_is_the_masked_superset(kind, seed, tile, dtype):
    """The step zeroes its own product in place: the same values as the
    superset product times the keep mask, padding at zero."""
    m = matrix_of(kind, seed, tile)
    m = m.astype(torch.float32) if dtype == np.float32 else m
    fn, c_index, _ = dtt.build_multiply_executor("N", "N", m, m)
    c_sup = fn(m.data, m.data)
    info = device_block_info(c_index, tile, CPU)
    nsq0 = info.block_sum(tile_block_sumsq(c_sup, info).reshape(-1))
    eps = float(np.sqrt(eps_sq_at(nsq0, 0.4)))
    ex = dtt.build_filtered_executor("N", "N", m, m, eps)
    c_data, keep, nsq = ex.step(m.data, m.data)
    assert torch.equal(nsq, nsq0)
    assert torch.equal(keep, (nsq >= float(np.float32(eps) ** 2)).to(torch.float32))
    mask = block_mask_store(c_index, tile, CPU, keep=keep).to(c_sup.dtype)
    assert torch.equal(c_data, c_sup * mask)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    m = random_case(4, 16)
    info = device_block_info(m.index, 16, CPU)
    nsq = info.block_sum(tile_block_sumsq(m.data, info).reshape(-1))
    for bad, err in ((m.data.to(torch.float16), TypeError),
                     (m.data.to(torch.int64), TypeError),
                     (m.data.transpose(1, 2), ValueError),  # not contiguous
                     (m.data[1:], ValueError),  # a store of other tiles than the plan's
                     (m.data.to("meta"), ValueError)):  # the plan is elsewhere
        with pytest.raises(err):
            tile_block_sumsq(bad, info)
        with pytest.raises(err):
            keep_blocks(bad, info, nsq, 1.0)
    with pytest.raises(TypeError):
        keep_blocks(m.data.clone(), info, nsq.double(), 1.0)
    with pytest.raises(TypeError):
        keep_blocks(m.data.clone(), info, nsq[1:], 1.0)
    with pytest.raises(ValueError):
        keep_blocks(m.data.clone(), info, nsq.to("meta"), 1.0)
    # the plan on another device than the store (a meta plan, a CPU store)
    meta = slots_block_info(m.index, 16, np.arange(m.data.shape[0]), "meta")
    with pytest.raises(ValueError):
        tile_block_sumsq(m.data, meta)


def check_plain_route(dtype):
    """On the CPU the wrappers are the plain versions for a ``dtype`` store:
    |z|² norms and the same zeroing as the mask multiply."""
    m = random_case(6, 16)
    c = as_store(m.data, dtype)
    info = device_block_info(m.index, 16, CPU)
    z = tile_block_sumsq(c, info)
    assert torch.equal(z, tile_block_sumsq_plain(c, info))
    nsq = info.block_sum(z.reshape(-1))
    eps_sq = eps_sq_at(nsq, 0.5)
    keep = (nsq >= eps_sq).to(torch.float32)
    ref = c * block_mask_store(m.index, 16, CPU, keep=keep).to(c.dtype)
    got = c.clone()
    assert torch.equal(keep_blocks(got, info, nsq, eps_sq), keep)
    assert torch.equal(got, ref)


def test_other_store_types_take_the_plain_versions():
    """Complex stores, which the kernels take on a card, go through the
    plain versions on the CPU."""
    check_plain_route(torch.complex128)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.bfloat16])
def test_complex64_and_bfloat16_take_the_plain_versions_on_the_cpu(dtype):
    check_plain_route(dtype)


def test_slots_block_info_follows_the_slots():
    """A shard's block info: its tiles in shard order, -1 for a zero tile
    that holds no block, the blocks keeping their ids."""
    m = random_case(7, 16)
    n = m.data.shape[0]
    slots = np.concatenate([np.arange(n)[::-2], [-1, -1]])
    info = slots_block_info(m.index, 16, slots, CPU)
    full = device_block_info(m.index, 16, CPU)
    held = slots[slots >= 0]
    assert torch.equal(info.bid_p1[:len(held)], full.bid_p1[held])
    assert not bool(info.bid_p1[len(held):].any())
    assert torch.equal(info.rows[:len(held)], full.rows[held])
    store = torch.cat([m.data[held], m.data.new_zeros((2, 16, 16))])
    z = tile_block_sumsq(store, info)
    assert torch.equal(z[:len(held)], tile_block_sumsq(m.data, full)[held])
    assert not bool(z[len(held):].any())


def test_plain_versions_count_no_kernel_bytes():
    """``filter_bytes`` counts the kernels' launches only: the plain versions
    add nothing, and ``print_statistics`` shows the line once it moves."""
    m = random_case(8, 16)
    reset_stats()
    ex = dtt.build_filtered_executor("N", "N", m, m, 1e-2)
    ex.step(m.data, m.data)
    assert get_stats().filter_bytes == 0
    assert "filter kernel bytes" not in print_statistics()
    get_stats().filter_bytes += 1.5e9
    assert " filter kernel bytes      1.500000E+09" in print_statistics()
    reset_stats()
