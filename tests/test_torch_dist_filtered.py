"""The eps-filtered step over a process grid, sharded at rest
(``build_filtered_executor(..., dist=)``), held against the benchmark's plain
reference (``benchmark/reference``: plain torch, numpy and scipy) and
against the one-card executor, on water boxes of one and two 32-molecule
cells with eps set so that about 40% of C's superset blocks drop:

- grids of 1×1 and 2×2 virtual ranks in this process, and 3×3 with ranks
  that own no tile (an empty shard);
- four ``gloo`` processes (``tests/torch_mp_worker.py``, scenario
  ``filtered_cannon``), each joined with a 120 s timeout, bitwise against
  the same grid of virtual ranks in one process.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dt
from dbcsr_tpu_torch.core.stats import get_stats, reset_stats
from dbcsr_tpu_torch.dist import ProcessGrid, tile_aligned_dist
from dbcsr_tpu_torch.dist.sharded import shard_store_with_layout, unshard_store_with_layout

from torch_mp_worker import water_case

from benchmark import products
from benchmark.reference.judge import block_err
from benchmark.reference.layout import tile_keys
from benchmark.reference.shards import Held, RowsProduct, held_block_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")
JOIN_TIMEOUT = 120
LIMIT = 1e-10  # the benchmark's block_err limit
CPU = torch.device("cpu")
CASES = {"1x1x1": ((1, 1, 1), 32), "2x1x1": ((2, 1, 1), 32)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CASES: dict = {}


def case(name):
    """(cfg, ops, A, B, eps, reference, one-card executor, its step)."""
    if name not in _CASES:
        replicas, tile = CASES[name]
        cfg, ops, a, b, eps, ref = water_case(replicas, tile, 5)
        one = dt.build_filtered_executor("N", "N", a, b, eps)
        _CASES[name] = (cfg, ops, a, b, eps, ref, one, one.step(a.data, b.data))
    return _CASES[name]


def run_grid(a, b, eps, shape):
    g = ProcessGrid.make(*shape, devices=[CPU] * (shape[0] * shape[1]))
    ex = dt.build_filtered_executor("N", "N", a, b, eps,
                                    dist=tile_aligned_dist(g, a.row_block_sizes,
                                                           a.row_block_sizes, a.tile))
    return g, ex, ex.step(shard_store_with_layout(a, ex.shard_a, g))


def keep_of(ex, keep) -> torch.Tensor:
    """The global keep vector over C's superset blocks, each rank's entries
    where it holds a part (every holder must agree)."""
    out = torch.full((ex.c_index.nblks,), -1.0)
    for d, blocks in enumerate(ex.rank_blocks):
        idx = torch.as_tensor(blocks)
        seen = out[idx]
        assert bool(((seen < 0) | (seen == keep[d])).all()), f"rank {d} disagrees"
        out[idx] = keep[d]
    assert bool((out >= 0).all())
    return out


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("name", list(CASES))
def test_against_reference_and_one_card(name, shape):
    cfg, ops, a, b, eps, ref, one, (c1, k1, _) = case(name)
    g, ex, (c, keep, nsq) = run_grid(a, b, eps, shape)
    kept = keep_of(ex, keep)
    dropped = 1.0 - float(kept.mean())
    assert 0.2 <= dropped <= 0.6, dropped
    assert torch.equal(kept, k1), "kept set differs from the one-card executor's"
    assert np.array_equal(ex.c_index.blk_rows, one.c_index.blk_rows)
    assert np.array_equal(ex.c_index.col_idx, one.c_index.col_idx)
    store = unshard_store_with_layout(c, ex.shard_c, a.tile, CPU, grid=g, dtype=a.dtype)
    blocks = products.blocks_of(ex.c_index, ops.pattern)
    assert block_err(ref, ops.a[0], blocks, store, eps, cfg["norm_tie_rel"]) <= LIMIT
    # the per-shard judge on each rank's own tiles
    sl = ex.shard_c
    keys = tile_keys(blocks, a.tile)
    counts = np.bincount(sl.owner_of_slot, minlength=sl.ndev)
    rows = RowsProduct(ops.pattern, ops.keys, ops.b, torch.float64)
    per_rank = [keys[sl.slot_of_pos[d * sl.n_max:d * sl.n_max + counts[d]]]
                for d in range(sl.ndev)]
    for d in range(sl.ndev):
        held = Held(keys=per_rank[d], ranks=per_rank if d == 0 else None)
        assert held_block_err(rows, ops.a[0], held, c[d][:counts[d]], eps,
                              cfg["norm_tie_rel"]) <= LIMIT


@pytest.mark.parametrize("name", list(CASES))
def test_spanning_blocks(name):
    """Under the tile-aligned distribution a block that straddles a tile
    boundary has parts on two (or four) ranks of a 2×2 grid: their partial
    norms² are summed on each holder, so every holder keeps or drops it
    alike, as the one-card executor does; a 1×1 grid has none."""
    cfg, ops, a, b, eps, ref, one, (c1, k1, n1) = case(name)
    _, ex1, _ = run_grid(a, b, eps, (1, 1))
    assert ex1.spanning == 0
    _, ex, (c, keep, nsq) = run_grid(a, b, eps, (2, 2))
    holders = np.bincount(np.concatenate(ex.rank_blocks), minlength=ex.c_index.nblks)
    assert ex.spanning == int((holders > 1).sum()) > 0
    full = torch.zeros(ex.c_index.nblks, dtype=torch.float32)
    for d, blocks in enumerate(ex.rank_blocks):
        full[torch.as_tensor(blocks)] = nsq[d]
    span = torch.as_tensor(holders > 1)
    assert torch.allclose(full[span], n1[span], rtol=1e-5)
    assert torch.equal(keep_of(ex, keep)[span], k1[span])


def test_empty_shard():
    """A 3×3 grid over a box of two 512-row tiles: the third grid row and
    column own no tile, their ranks' shards are padding alone, and the
    product is still the one-card product."""
    cfg, ops, a, b, eps, ref, one, (c1, k1, _) = case("1x1x1")
    from benchmark.operands import make_operands, pattern_of

    cfg5 = dict(cfg, tile=512)
    ops5 = make_operands(cfg5, pattern_of(cfg5), 5, 1, CPU)
    a5, b5 = products.matrices(cfg5, ops5)
    one5 = dt.build_filtered_executor("N", "N", a5, b5, eps)
    c15, k15, _ = one5.step(a5.data, b5.data)
    g, ex, (c, keep, nsq) = run_grid(a5, b5, eps, (3, 3))
    counts = np.bincount(ex.shard_c.owner_of_slot, minlength=9)
    assert (counts == 0).any() and (counts > 0).any()
    for d in np.flatnonzero(counts == 0):
        assert len(ex.rank_blocks[d]) == 0 and keep[d].numel() == 0
        assert not bool(c[d].any())
    assert torch.equal(keep_of(ex, keep), k15)
    store = unshard_store_with_layout(c, ex.shard_c, 512, CPU, grid=g, dtype=a5.dtype)
    assert float((store - c15).abs().max()) <= 1e-12 * float(c15.abs().max())


def test_counts_a_call():
    """A step adds one multiplication, the effective flops of the C
    elements its ranks own (they sum to the product's) and the tile work
    its ticks issue (whole tiles: at T = 32 the stacks carry no K masks)."""
    cfg, ops, a, b, eps, ref, one, _ = case("2x1x1")
    g = ProcessGrid.make(2, 2, devices=[CPU] * 4)
    ex = dt.build_filtered_executor("N", "N", a, b, eps,
                                    dist=tile_aligned_dist(g, a.row_block_sizes,
                                                           a.row_block_sizes, a.tile))
    a_sh = shard_store_with_layout(a, ex.shard_a, g)
    reset_stats()
    ex.step(a_sh)
    ex.step(a_sh)
    st = get_stats()
    entries = int((ex.fn.host_plan.stacks[..., 0] < ex.fn.host_plan.n_c).sum())
    assert st.num_multiplications == 2
    assert st.total_flops == pytest.approx(2 * ex.eff_flops, rel=1e-12)
    assert st.hardware_flops == st.padded_flops == 2 * 2.0 * a.tile ** 3 * entries
    effs = [rf.eff_flops for rf in ex._ranks]
    assert all(e > 0 for e in effs) and sum(effs) == pytest.approx(ex.eff_flops, rel=1e-12)


def test_refuses_a_driver():
    cfg, ops, a, b, eps, *_ = case("1x1x1")
    g = ProcessGrid.make(1, 1, devices=[CPU])
    with pytest.raises(dt.DbcsrError, match="driver"):
        dt.build_filtered_executor("N", "N", a, b, eps, driver="stack",
                                   dist=tile_aligned_dist(g, a.row_block_sizes,
                                                          a.row_block_sizes, a.tile))


def test_four_processes(tmp_path):
    """Four gloo processes on a 2×2 grid: each process's shards, keep and
    norms² bitwise the single-process virtual ranks', its tiles within the
    per-shard judge's limit, and blocks that span ranks."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    url = "file://" + os.path.join(str(tmp_path), "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, url, str(pid), "4", str(tmp_path), str(tmp_path),
         "filtered_cannon"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for pid in range(4)]
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=JOIN_TIMEOUT)
            assert p.returncode == 0, f"worker {pid} failed (rc {p.returncode}):\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    reports = [json.loads((tmp_path / f"report_{pid}.json").read_text()) for pid in range(4)]
    for pid, rep in enumerate(reports):
        assert "_error" not in rep, rep["_error"]
        r = rep["filtered_cannon"]
        assert not r["not_bitwise"], (pid, r["not_bitwise"])
        assert r["ok"] and r["spanning"] > 0
    moved = np.array([rep["filtered_cannon"]["moved"] for rep in reports])
    assert (moved[:, 0] > 0).all() and moved[:, 1].sum() == moved[:, 2].sum()
