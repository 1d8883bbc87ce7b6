"""The float64 kernel's K occupancy masks in the Cannon ticks
(``mm/cannon.py``: ``cannon_piece_masks``, ``RankPlan.build``), on the CPU,
over water boxes of one and two 32-molecule cells (``water_case``) at 2×2
virtual ranks:

- every (rank, tick) stack's masks are ``tile_chunk_masks`` of the op-store
  tile that each piece slot holds after t ring shifts (the shifts replayed
  on the pack maps), padding slots carry 0, and the masks agree with the
  nonzero depths of the pieces the ticks actually multiply;
- the issued flops summed over ranks and ticks equal the one-card
  executor's ``chunked_hw_flops`` of the same product, and reach the
  statistics through ``add_tile_flops`` (filtered step and ``multiply``);
- float32, complex128, T = 32, SUMMA and the element-granular plan carry
  no masks and count the tile figure;
- the sharded filtered step keeps the one-card executor's blocks and stays
  within the benchmark's ``block_err`` limit of the plain reference.
"""
import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dt
from dbcsr_tpu_torch.block.store import store_layout
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.core.stats import get_stats, print_statistics, reset_stats
from dbcsr_tpu_torch.dist import ProcessGrid, block_cyclic_dist, tile_aligned_dist
from dbcsr_tpu_torch.dist.sharded import shard_store_with_layout, unshard_store_with_layout
from dbcsr_tpu_torch.mm.cannon import _element_exec, plan_cannon
from dbcsr_tpu_torch.mm.engine import _op_pattern
from dbcsr_tpu_torch.mm.f64_stack import MMA_DEPTH, tile_chunk_masks

from torch_mp_worker import water_case

from benchmark import products
from benchmark.reference.judge import block_err

CPU = torch.device("cpu")
LIMIT = 1e-10  # the benchmark's block_err limit
CASES = {"1x1x1": (1, 1, 1), "2x1x1": (2, 1, 1)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CASES: dict = {}


def case(name, tile):
    """(cfg, ops, A, B, eps, reference) of a water box at tile edge ``tile``."""
    if (name, tile) not in _CASES:
        _CASES[(name, tile)] = water_case(CASES[name], tile, 5)
    return _CASES[(name, tile)]


def grid_dist(a, shape=(2, 2)):
    g = ProcessGrid.make(*shape, devices=[CPU] * int(np.prod(shape)))
    return g, tile_aligned_dist(g, a.row_block_sizes, a.row_block_sizes, a.tile)


def depth_bits(nonzero_lines: torch.Tensor) -> np.ndarray:
    """[n, T] bool -> int32 [n]: bit h iff a line of depth h is nonzero."""
    n, t = nonzero_lines.shape
    per = nonzero_lines.reshape(n, t // MMA_DEPTH, MMA_DEPTH).any(dim=2).numpy()
    return (per.astype(np.int64) << np.arange(t // MMA_DEPTH)).sum(axis=1).astype(np.int32)


def shifted_packs(fn, g):
    """The op-store tile of every rank's A and B piece slots at every tick:
    the pack maps moved as the tick loop moves the pieces (A left along the
    grid row, B up along the grid column)."""
    hp, p = fn.host_plan, g.nprow
    ranks = g.ranks()
    rank = {rk: r for r, rk in enumerate(ranks)}
    a = [hp.a_pack[r * hp.n_a:(r + 1) * hp.n_a] for r in range(len(ranks))]
    b = [hp.b_pack[r * hp.n_b:(r + 1) * hp.n_b] for r in range(len(ranks))]
    out = []
    for _ in range(p):
        out.append((a, b))
        a = [a[rank[(i, (j + 1) % p, l)]] for (i, j, l) in ranks]
        b = [b[rank[((i + 1) % p, j, l)]] for (i, j, l) in ranks]
    return out


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "unsharded"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_tick_masks_follow_the_shifted_pieces(name, tile, trans, sharded):
    check_tick_masks(name, tile, trans, sharded, (2, 2))


def test_tick_masks_follow_the_shifted_pieces_in_layers():
    """2.5D Cannon, 2×2×2 ranks: each layer's ranks take their own layer's
    pieces."""
    check_tick_masks("2x1x1", 64, "N", False, (2, 2, 2))


def check_tick_masks(name, tile, trans, sharded, shape):
    cfg, ops, a, b, eps, ref = case(name, tile)
    g, dist = grid_dist(a, shape)
    fn, _, _ = dt.build_distributed_executor(trans, "N", a, b, dist, sharded=sharded)
    op = _op_pattern(a, trans == "T")
    rows, cols = tile_chunk_masks(a.index, tile)
    a_op = (rows if trans == "T" else cols)
    a_op = a_op if op.perm is None else a_op[op.perm]
    b_op = tile_chunk_masks(b.index, tile)[0]
    named = 0
    for t, (pa, pb) in enumerate(shifted_packs(fn, g)):
        for r in range(len(g.ranks())):
            ts = fn.plan.ticks[r][t]
            if ts is None:
                continue
            got_a, got_b = ts.stack.a_chunks.numpy(), ts.stack.b_chunks.numpy()
            np.testing.assert_array_equal(got_a, np.where(pa[r] >= 0, a_op[pa[r]], 0))
            np.testing.assert_array_equal(got_b, np.where(pb[r] >= 0, b_op[pb[r]], 0))
            assert (got_a[pa[r] < 0] == 0).all() and (got_b[pb[r] < 0] == 0).all()
            named += len(ts.stack.a_idx)
    assert named == fn.plan.n_stack > 0


@pytest.mark.parametrize("shape", [(2, 2), (3, 3)], ids=["2x2", "3x3"])
@pytest.mark.parametrize("tile", [64, 128])
def test_tick_masks_match_the_pieces_data(tile, shape):
    """The pieces the sharded ticks multiply (the ring shifts replayed on
    the gathered tensors): at every slot an entry names, the A mask is the
    piece tile's nonzero columns by depth and the B mask its nonzero rows
    (the data is nonzero on every stored element). On 3×3 ranks a shift
    the wrong way round would show."""
    cfg, ops, a, b, eps, ref = case("2x1x1", tile)
    g, dist = grid_dist(a, shape)
    fn, _, _ = dt.build_distributed_executor("N", "N", a, b, dist, sharded=True)
    ranks = g.ranks()
    rank = {rk: r for r, rk in enumerate(ranks)}
    pa = fn.pieces_a(shard_store_with_layout(a, fn.shard_a, g))
    pb = fn.pieces_b(shard_store_with_layout(b, fn.shard_b, g))
    skipped = False
    for t in range(g.nprow):
        for r in range(len(ranks)):
            ts = fn.plan.ticks[r][t]
            if ts is None:
                continue
            ia, ib = ts.stack.a_idx.long(), ts.stack.b_idx.long()
            want_a = depth_bits((pa[r][ia] != 0).any(dim=1))
            want_b = depth_bits((pb[r][ib] != 0).any(dim=2))
            np.testing.assert_array_equal(ts.stack.a_chunks[ia].numpy(), want_a)
            np.testing.assert_array_equal(ts.stack.b_chunks[ib].numpy(), want_b)
            skipped |= bool(((want_a & want_b) != (1 << (tile // MMA_DEPTH)) - 1).any())
        pa = [pa[rank[(i, (j + 1) % g.nprow, l)]] for (i, j, l) in ranks]
        pb = [pb[rank[((i + 1) % g.nprow, j, l)]] for (i, j, l) in ranks]
    assert skipped  # some entry leaves a depth empty


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_issued_flops_sum_to_the_one_card_count(name, tile):
    cfg, ops, a, b, eps, ref = case(name, tile)
    g, dist = grid_dist(a)
    fn, _, _ = dt.build_distributed_executor("N", "N", a, b, dist, sharded=True)
    with config_override(tile_size=tile):
        one, _, _ = dt.build_multiply_executor("N", "N", a, b, driver="stack")
    assert one.plan.route == "f64_stack"
    issued, padded = fn.plan.tile_flops()
    assert issued == one.plan.hw_flops
    assert padded == one.plan.padded_flops == 2.0 * fn.plan.n_stack * tile**3
    assert (fn.plan.hw_flops > 0).all() and (fn.plan.hw_flops <= fn.plan.padded_flops).all()
    if name == "2x1x1":
        assert issued < padded


def test_filtered_step_counts_what_each_rank_issues():
    """A filtered step adds, for every rank, the flops its ticks issue and
    its tile figure; the statistics print the skipped share."""
    cfg, ops, a, b, eps, ref = case("2x1x1", 64)
    g, dist = grid_dist(a)
    ex = dt.build_filtered_executor("N", "N", a, b, eps, dist=dist)
    plan = ex.fn.plan
    per = [(rf.hw_flops, rf.padded_flops) for rf in ex._ranks]
    assert per == [(plan.hw_flops[d], plan.padded_flops[d]) for d in range(4)]
    a_sh = shard_store_with_layout(a, ex.shard_a, g)
    reset_stats()
    ex.step(a_sh)
    s = get_stats()
    issued, padded = plan.tile_flops()
    assert (s.hardware_flops, s.padded_flops) == (issued, padded)
    assert issued < padded
    assert f" tile work skipped        {1.0 - issued / padded:.3f}" in print_statistics()


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_filtered_step_keeps_the_one_card_blocks(name, tile):
    cfg, ops, a, b, eps, ref = case(name, tile)
    one = dt.build_filtered_executor("N", "N", a, b, eps)
    _, k1, _ = one.step(a.data, b.data)
    g, dist = grid_dist(a)
    ex = dt.build_filtered_executor("N", "N", a, b, eps, dist=dist)
    assert any(ts is not None and ts.stack.a_chunks is not None
               for per in ex.fn.plan.ticks for ts in per)
    c, keep, _ = ex.step(shard_store_with_layout(a, ex.shard_a, g))
    kept = torch.full((ex.c_index.nblks,), -1.0)
    for d, blocks in enumerate(ex.rank_blocks):
        kept[torch.as_tensor(blocks)] = keep[d]
    assert torch.equal(kept, k1)
    store = unshard_store_with_layout(c, ex.shard_c, tile, CPU, grid=g, dtype=a.dtype)
    blocks = products.blocks_of(ex.c_index, ops.pattern)
    assert block_err(ref, ops.a[0], blocks, store, eps, cfg["norm_tie_rel"]) <= LIMIT


def test_multiply_counts_the_issued_flops():
    """``multiply(dist=)`` over the tiled Cannon plan adds the RankPlan's
    issued and padded flops; in float32 the same plan issues the tile
    figure."""
    cfg, ops, a, b, eps, ref = case("2x1x1", 64)
    g, dist = grid_dist(a)
    got = {}
    for dtype in (torch.float64, torch.float32):
        x, y = a.with_data(a.data.to(dtype)), b.with_data(b.data.to(dtype))
        fn, _, _ = dt.build_distributed_executor("N", "N", x, y, dist)
        reset_stats()
        with config_override(tile_size=64):
            dt.multiply("N", "N", 1.0, x, y, dist=dist)
        s = get_stats()
        got[dtype] = (s.hardware_flops, s.padded_flops)
        assert got[dtype] == fn.plan.tile_flops()
    assert got[torch.float64][0] < got[torch.float64][1] == got[torch.float32][0]


def no_masks(fn):
    return all(ts is None or ts.stack.a_chunks is None and ts.stack.b_chunks is None
               for per in fn.plan.ticks for ts in per)


@pytest.mark.parametrize("what", ["float32", "complex128", "T32", "summa"])
def test_other_stacks_carry_no_masks(what):
    tile = 32 if what == "T32" else 64
    cfg, ops, a, b, eps, ref = case("2x1x1", tile)
    dtype = {"float32": torch.float32, "complex128": torch.complex128}.get(what)
    if dtype is not None:
        a, b = a.with_data(a.data.to(dtype)), b.with_data(b.data.to(dtype))
    g, dist = grid_dist(a)
    fn, _, _ = dt.build_distributed_executor(
        "N", "N", a, b, dist, algo="summa" if what == "summa" else "cannon")
    assert fn.plan.launches > 0 and no_masks(fn)
    assert np.array_equal(fn.plan.hw_flops, fn.plan.padded_flops)
    assert fn.plan.tile_flops()[1] == 2.0 * fn.plan.n_stack * tile**3


def test_element_plan_carries_no_masks():
    cfg, ops, a, b, eps, ref = case("2x1x1", 64)
    g = ProcessGrid.make(2, 2, devices=[CPU] * 4)
    dist = block_cyclic_dist(g, a.nblkrows, b.nblkcols)
    c_index = dt.build_multiply_executor("N", "N", a, b)[1]
    kd = np.arange(a.nblkcols) % 2
    plan = plan_cannon(a.index, False, b.index, False, c_index, dist, kd, 64)
    ex = _element_exec(plan, a, b, store_layout(c_index, 64), g, 64, CPU)
    assert ex.plan.launches > 0 and no_masks(ex)
    assert np.array_equal(ex.plan.hw_flops, ex.plan.padded_flops)
