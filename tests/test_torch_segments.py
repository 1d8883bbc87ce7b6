"""Run segments of the float64 stack kernel (``mm/f64_stack.py``): the host
planner that cuts long runs into segments of about equal issued work, the
plain version of a segmented launch and its fix-up (S1), and the
``split_runs`` / ``run_segments`` counters the executors add.

The kernel itself runs on the card (``tests/test_torch_cuda.py``, ``-k
segment``); here the plain versions stand in for it (the run sums of each
segment, then S1's plain version), and the planner is given the SM count a
card would report (on the CPU it cuts no run).
"""

import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.block.index import build_index
from dbcsr_tpu_torch.block.store import store_layout
from dbcsr_tpu_torch.core.stats import get_stats, print_statistics, reset_stats
from dbcsr_tpu_torch.mm import f64_stack
from dbcsr_tpu_torch.mm.f64_stack import (
    SEGMENTS_PER_SM,
    entry_depths,
    f64_device_stack,
    plan_run_segments,
    segment_sum_f64,
    tile_stack_matmul_f64,
    tile_stack_matmul_f64_plain,
)
from dbcsr_tpu_torch.mm.kernels import device_stack, run_sums_plain
from dbcsr_tpu_torch.mm.plancache import get_plan_cache

RTOL_F64 = 1e-12


def runs_stack(rng, lens, n_tiles=16):
    """A c-sorted stack with runs of the given lengths (0: an empty run)."""
    c = np.repeat(np.arange(len(lens)), lens)
    return np.stack([c, rng.integers(0, n_tiles, len(c)),
                     rng.integers(0, n_tiles, len(c))], axis=1).astype(np.int32)


def masks(rng, n_tiles, tile):
    depths = tile // 8
    return (rng.integers(1, 1 << depths, n_tiles).astype(np.int32),
            rng.integers(1, 1 << depths, n_tiles).astype(np.int32))


def c_ptr_of(stack, n_c):
    return np.searchsorted(stack[:, 0], np.arange(n_c + 1)).astype(np.int64)


def work_of(stack, chunks):
    return entry_depths(chunks[0], chunks[1], stack[:, 1], stack[:, 2])


STACKS = {
    # (run lengths, SMs)
    "few_long": ([900, 700, 40, 1200], 8),
    "empty_and_single": ([0, 500, 1, 0, 3, 800, 0], 4),
    "one_run": ([2000], 1),
    "many_mixed": (list(np.random.default_rng(5).integers(0, 60, 300)) + [3000, 2500], 16),
    "card": ([713, 3650, 1800, 2400] * 36, 132),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_segments_cover_every_run_once_in_entry_order(name):
    lens, sms = STACKS[name]
    rng = np.random.default_rng(len(lens))
    stack = runs_stack(rng, lens)
    chunks = masks(rng, 16, 128)
    c_ptr = c_ptr_of(stack, len(lens))
    plan = plan_run_segments(c_ptr, work_of(stack, chunks), sms)
    assert plan is not None
    seg_ptr, seg_out, red_c, red_ptr = plan
    n_c = len(lens)
    assert seg_ptr[0] == 0 and seg_ptr[-1] == len(stack) and np.all(np.diff(seg_ptr) >= 0)
    # each run's segments are consecutive, the first writes its C tile
    first = seg_out >= 0
    np.testing.assert_array_equal(seg_out[first], np.arange(n_c))
    np.testing.assert_array_equal(seg_ptr[:-1][first], c_ptr[:-1])
    run_of = np.cumsum(first) - 1
    assert np.all(seg_ptr[:-1] >= c_ptr[run_of]) and np.all(seg_ptr[1:] <= c_ptr[run_of + 1])
    # workspace tiles numbered in segment order, each split run's in a row
    np.testing.assert_array_equal(-1 - seg_out[~first], np.arange(int((~first).sum())))
    extra = np.bincount(run_of[~first], minlength=n_c)
    np.testing.assert_array_equal(red_c, np.flatnonzero(extra))
    np.testing.assert_array_equal(np.diff(red_ptr), extra[red_c])
    assert np.all(np.diff(seg_ptr)[~first] > 0)  # a cut leaves no empty segment
    assert np.all(np.diff(seg_ptr)[np.isin(run_of, red_c)] > 0)


@pytest.mark.parametrize("shape", ["balanced", "water_like"])
def test_no_run_split_where_runs_are_short(monkeypatch, shape):
    """A balanced stack (every run the same work) and the water products'
    shape (many short runs, the longest far under W / 4·S) give one segment
    a run: the table is the runs themselves."""
    rng = np.random.default_rng(1)
    if shape == "balanced":
        lens, sms = [40] * 528, 132
        chunks = (np.full(16, 0xFFFF, np.int32), np.full(16, 0xFFFF, np.int32))
    else:
        lens, sms = list(rng.integers(1, 8, 20000)), 132
        chunks = masks(rng, 16, 128)
    stack = runs_stack(rng, lens)
    assert plan_run_segments(c_ptr_of(stack, len(lens)), work_of(stack, chunks), sms) is None
    monkeypatch.setattr(f64_stack, "device_sm_count", lambda device: sms)
    ds = f64_device_stack(stack, len(lens), "cpu", chunks, 128)
    np.testing.assert_array_equal(ds.segments.seg_ptr_host, ds.c_ptr_host)
    np.testing.assert_array_equal(ds.segments.seg_out_host, np.arange(len(lens)))
    assert ds.segments.n_ws == 0 and torch.equal(ds.segments.seg_ptr, ds.c_ptr)
    assert ds.split_runs == 0 and ds.run_segments == len(lens)


@pytest.mark.parametrize("sms", [2, 8, 33])
def test_long_runs_split_to_within_one_entry_of_w_star(sms):
    """Runs longer than w* = W / (4·S) are cut into ⌈w/w*⌉ segments whose
    issued work lies within one entry of the run's even share, which is at
    most w*; the other runs stay whole."""
    rng = np.random.default_rng(sms)
    lens = [3000, 1500, 20, 7, 2600, 0, 90]
    stack = runs_stack(rng, lens)
    chunks = masks(rng, 16, 128)
    work = work_of(stack, chunks)
    c_ptr = c_ptr_of(stack, len(lens))
    seg_ptr, seg_out, red_c, _ = plan_run_segments(c_ptr, work, sms)
    cw = np.concatenate(([0], np.cumsum(work)))
    total, top = int(cw[-1]), int(work.max())
    w_star = total / (SEGMENTS_PER_SM * sms)
    seg_w = cw[seg_ptr[1:]] - cw[seg_ptr[:-1]]
    run_of = np.cumsum(seg_out >= 0) - 1
    for c in range(len(lens)):
        w_c = int(cw[c_ptr[c + 1]] - cw[c_ptr[c]])
        mine = seg_w[run_of == c]
        if w_c <= w_star:
            assert len(mine) == 1 and c not in red_c
            continue
        n = int(np.ceil(w_c / w_star))
        assert len(mine) == n and c in red_c
        share = w_c / n
        assert share <= w_star
        assert np.all(np.abs(mine - share) <= top + 1)
        assert mine.max() <= w_star + top + 1


@pytest.mark.parametrize("sms", [1, 2, 8, 132])
@pytest.mark.parametrize("seed", [0, 1])
def test_workspace_stays_within_four_tiles_an_sm(monkeypatch, sms, seed):
    """The planner's workspace, and the stack's where the cut pays: on one
    SM no cut shortens the launch, so the stack keeps one segment a run; on
    2, 8 and 132 the 20,000-entry run, launched last, is cut."""
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(0, 400, 50)) + list(rng.integers(2000, 4000, 6)) + [20000]
    stack = runs_stack(rng, lens)
    chunks = masks(rng, 16, 128)
    _, _, _, red_ptr = plan_run_segments(c_ptr_of(stack, len(lens)), work_of(stack, chunks), sms)
    assert 0 < red_ptr[-1] < SEGMENTS_PER_SM * sms
    monkeypatch.setattr(f64_stack, "device_sm_count", lambda device: sms)
    ds = f64_device_stack(stack, len(lens), "cpu", chunks, 128)
    assert ds.segments.n_ws < SEGMENTS_PER_SM * sms
    assert ds.split_runs == ds.segments.n_split and (ds.split_runs > 0) == (sms > 1)
    assert ds.run_segments == ds.segments.n_seg == len(lens) + ds.segments.n_ws


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("shape", ["banded", "few_long"])
def test_a_cut_only_where_it_pays(monkeypatch, shape, tile):
    """On 132 SMs the planner cuts the runs of a small banded product (196
    runs of one to three full-depth entries: W / 4·S is about one entry),
    but the cut would not shorten the launch's list schedule by S1's cost,
    so the launch keeps one segment a run; a few long runs (the K product's
    shape) are cut."""
    rng = np.random.default_rng(tile)
    full = np.full(16, (1 << (tile // 8)) - 1, np.int32)
    if shape == "banded":
        lens = list(np.tile([1, 2, 3, 3, 3, 2, 1], 28))
        chunks, pays = (full, full), False
    else:
        lens = [3000, 1500, 20, 7, 2600, 0, 90] * 20
        chunks, pays = masks(rng, 16, tile), True
    stack = runs_stack(rng, lens)
    c_ptr, work = c_ptr_of(stack, len(lens)), work_of(stack, chunks)
    plan = plan_run_segments(c_ptr, work, 132)
    assert plan is not None
    assert f64_stack.split_pays(c_ptr, work, plan, tile, 132) == pays
    monkeypatch.setattr(f64_stack, "device_sm_count", lambda device: 132)
    ds = f64_device_stack(stack, len(lens), "cpu", chunks, tile)
    assert (ds.split_runs > 0) == pays
    assert ds.run_segments == (plan[1].size if pays else len(lens))


def zeroed_stores(rng, n_tiles, tile, chunks):
    """Random float64 tile stores, zero where the K masks are clear (the
    store invariant the kernel's skipped depths rely on)."""
    depths = tile // 8

    def keep(m):
        return torch.from_numpy(((m[:, None] >> np.arange(depths)) & 1).repeat(8, axis=1) > 0)

    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    a = torch.randn(n_tiles, tile, tile, dtype=torch.float64, generator=gen)
    b = torch.randn(n_tiles, tile, tile, dtype=torch.float64, generator=gen)
    return (a.masked_fill(~keep(chunks[0])[:, None, :], 0),
            b.masked_fill(~keep(chunks[1])[:, :, None], 0))


def segmented_plain(a, b, ds):
    """What a segmented launch computes, from plain parts: each segment's
    run sum, then S1 (its plain version on the CPU) adds the workspace
    segments into their runs' first ones."""
    seg = ds.segments
    parts = run_sums_plain(a, b, seg.seg_ptr_host, ds.a_idx.long(), ds.b_idx.long(),
                           torch.float64)
    first = torch.as_tensor(seg.seg_out_host >= 0)
    return segment_sum_f64(parts[first], parts[~first].contiguous(), seg)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("tile", [64, 128])
def test_segmented_plain_product_equals_unsegmented(monkeypatch, tile, masked):
    """A segmented product from plain parts (segment partials, then the
    fix-up's ordered sums) against the float64 plain version, which sums
    every run whole: 1e-12, the split runs differing by rounding alone, the
    others bitwise. Unmasked, every depth is set and the plan weighs each
    entry the same."""
    rng = np.random.default_rng(tile)
    lens = [400, 3, 0, 250, 1, 90]
    stack = runs_stack(rng, lens, n_tiles=12)
    full = np.full(12, (1 << (tile // 8)) - 1, np.int32)
    chunks = masks(rng, 12, tile) if masked else (full, full)
    a, b = zeroed_stores(rng, 12, tile, chunks)
    monkeypatch.setattr(f64_stack, "device_sm_count", lambda device: 3)
    ds = f64_device_stack(stack, len(lens), "cpu", chunks, tile)
    assert ds.split_runs >= 2
    got = segmented_plain(a, b, ds)
    ref = tile_stack_matmul_f64_plain(a, b, ds)
    assert torch.equal(ref, tile_stack_matmul_f64(a, b, ds))  # the CPU runs the plain version
    assert float((got - ref).abs().max() / ref.abs().max()) <= RTOL_F64
    kept = np.setdiff1d(np.arange(len(lens)), ds.segments.red_c_host)
    assert torch.equal(got[kept], ref[kept])
    assert not bool(got[2].any())  # the empty run: a zero tile
    assert torch.equal(got, segmented_plain(a, b, ds))


def test_segment_sum_adds_in_segment_order():
    """S1's plain version: c[red_c[r]] += ws[w] for its tiles in order,
    in place, other tiles untouched."""
    seg = f64_stack.RunSegments(*(torch.zeros(0, dtype=torch.int32) for _ in range(4)),
                                np.zeros(1, np.int64), np.zeros(0, np.int64),
                                np.array([1, 3]), np.array([0, 2, 3]))
    c = torch.arange(4 * 4, dtype=torch.float64).reshape(4, 2, 2)
    ws = torch.tensor([1e16, 1.0, 5.0], dtype=torch.float64)[:, None, None].expand(3, 2, 2)
    want = c.clone()
    want[1] = (want[1] + 1e16) + 1.0
    want[3] += 5.0
    out = segment_sum_f64(c, ws.contiguous(), seg)
    assert out is c and torch.equal(c, want)


def tall_pair(tile, seed=0):
    """A·B with a long contracted dimension and a small C (RI-HFX's K
    product in small): blocks of 13 and 5 rows as water's atoms, 184 rows
    by about 60 tiles for A and its mirror for B, half the blocks present,
    so each of C's few runs is long and most of its depths empty."""
    rng = np.random.default_rng(seed)
    short = np.tile(np.array([13, 5, 5], np.int32), 8)
    long_ = np.tile(np.array([13, 5, 5], np.int32), 60 * tile // 23)
    out = []
    for k, (rs, cs) in enumerate(((short, long_), (long_, short))):
        i, j = np.nonzero(rng.random((len(rs), len(cs))) < 0.5)
        idx, _ = build_index(i.astype(np.int32), j.astype(np.int32), rs, cs)
        flat = rng.standard_normal(idx.nelems)
        out.append(dtt.BCSRMatrix(name="AB"[k], index=idx, data=torch.from_numpy(
            store_layout(idx, tile).store_from_flat(flat))))
    return out


@pytest.mark.parametrize("tile", [64, 128])
def test_executor_counts_its_plans_segments(monkeypatch, tile):
    """``build_multiply_executor`` over a stack of few long runs, with the
    planner given 16 SMs: the plan holds its segments, each call adds its
    ``split_runs`` and ``run_segments``, ``print_statistics`` shows them,
    and its segments' plain product equals the one planned without a cut
    to 1e-12."""
    a, b = tall_pair(tile)
    monkeypatch.setattr(f64_stack, "device_sm_count", lambda device: 16)
    get_plan_cache().clear()
    fn, _, _ = dtt.build_multiply_executor("N", "N", a, b, driver="stack")
    ds = fn.plan.stack
    assert fn.plan.route == "f64_stack" and ds.segments is not None and ds.split_runs > 0
    assert fn.plan.segment_counts == (ds.split_runs, ds.segments.n_seg)
    reset_stats()
    fn(a.data, b.data)
    fn(a.data, b.data)
    st = get_stats()
    assert (st.split_runs, st.run_segments) == (2 * ds.split_runs, 2 * ds.segments.n_seg)
    assert f"run segments (split)     {st.run_segments} ({st.split_runs})" in print_statistics()
    monkeypatch.setattr(f64_stack, "device_sm_count", lambda device: 0)
    get_plan_cache().clear()
    fn0, _, _ = dtt.build_multiply_executor("N", "N", a, b, driver="stack")
    assert fn0.plan.stack.segments.n_seg == ds.n_c and fn0.plan.segment_counts == (0, ds.n_c)
    a_st, b_st = fn.plan.op_stores(a.data, b.data)
    got = segmented_plain(a_st, b_st, ds)
    ref = tile_stack_matmul_f64_plain(a_st, b_st, fn0.plan.stack)
    assert float((got - ref).abs().max() / ref.abs().max()) <= RTOL_F64
    get_plan_cache().clear()


def test_no_segments_on_the_cpu_by_default():
    """On the CPU the planner has no SMs to balance: a masked stack keeps one
    segment a run, and the executors count its runs as its segments."""
    rng = np.random.default_rng(3)
    stack = runs_stack(rng, [3000, 5])
    ds = f64_device_stack(stack, 2, "cpu", masks(rng, 16, 128), 128)
    assert ds.segments.n_ws == 0 and (ds.split_runs, ds.run_segments) == (0, 2)
    assert device_stack(stack, 2, "cpu").run_segments == 0  # no masks: not planned
