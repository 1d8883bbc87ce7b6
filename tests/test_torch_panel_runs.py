"""Port parity, K3 (the run-fused panel kernel): ``plan_panel_runs`` array
for array against the JAX package's planner, and the port's plain version —
what ``tile_stack_matmul_panel_runs`` runs for CPU tensors — against the JAX
Pallas run-fused kernel in interpret mode and the XLA twin of the stack
product, on the same numpy stores and stacks.

Tolerances, relative to the largest reference entry: float32 at "highest"
1e-5 (IEEE float32 on both sides; the plan's tiers fix the order of the
tile products, but a fused run is one long-K dot on the JAX side and
``runlen`` tile products here), bf16 inputs 1e-5 (products of bf16 values
are exact in float32).

The arrays the CUDA kernel reads are pinned by a plain-Python walk of its
pair function (the three-tier expansion), which must list exactly
``panel_runs_owned_stack``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.mm.kernels import _HAVE_PALLAS, tile_stack_matmul_xla
from dbcsr_tpu.mm.panel import plan_panel_runs as jax_plan_runs
from dbcsr_tpu.mm.panel import tile_stack_matmul_panel_runs as jax_panel_runs

from dbcsr_tpu_torch.mm.kernels import device_stack, tile_stack_matmul_plain
from dbcsr_tpu_torch.mm.panel import (
    PanelRunPlan,
    device_panel_run_plan,
    panel_runs_owned_stack,
    plan_panel_runs,
    tile_stack_matmul_panel_runs,
    tile_stack_matmul_panel_runs_plain,
)

torch.set_num_threads(1)

T = 8
RTOL = 1e-5
pallas = pytest.mark.skipif(not _HAVE_PALLAS, reason="no pallas")


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def banded_case(rng, mt=24, w=2):
    """As tests/test_panel_kernel.py: banded tile pattern times itself, plus
    the column-major permutation of its B store."""
    coords = np.array(
        [(r, c) for r in range(mt) for c in range(mt) if abs(r - c) <= w],
        dtype=np.int64,
    )
    n = len(coords)
    slot = {(r, c): i for i, (r, c) in enumerate(coords)}
    trip = []
    for (r, k), sa in slot.items():
        for c in range(max(0, k - w, r - w), min(mt, k + w + 1, r + w + 1)):
            trip.append((slot[(r, c)], sa, slot[(k, c)]))
    trip.sort()
    stack = np.asarray(trip, dtype=np.int32)
    a = rng.standard_normal((n, T, T)).astype(np.float32)
    b = rng.standard_normal((n, T, T)).astype(np.float32)
    cm = np.argsort(coords[:, 1] * mt + coords[:, 0]).astype(np.int32)
    return a, b, stack, n, cm


def random_case(rng, n_tiles=40, n_c=30, s=150):
    a = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    b = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    c_col = np.sort(rng.integers(0, n_c, s)).astype(np.int32)
    stack = np.stack(
        [c_col, rng.integers(0, n_tiles, s).astype(np.int32),
         rng.integers(0, n_tiles, s).astype(np.int32)], axis=1
    )
    stack[:n_c, 0] = np.arange(n_c, dtype=np.int32)
    return a, b, stack[np.argsort(stack[:, 0], kind="stable")]


def assert_same_plan(pj, pt):
    if pj is None or pt is None:
        assert pj is None and pt is None
        return
    for f in PanelRunPlan.__dataclass_fields__:
        vj, vt = getattr(pj, f), getattr(pt, f)
        if isinstance(vt, np.ndarray):
            np.testing.assert_array_equal(vj, vt, err_msg=f)
            assert vj.dtype == vt.dtype, f
        else:
            assert vj == vt, f
    assert pj.traffic_ratio == pt.traffic_ratio and pj.issue_ratio == pt.issue_ratio


@pytest.mark.parametrize("runlen", [2, 3, 4])
@pytest.mark.parametrize("c_win,cap,chunk", [(8, 32, 4), (16, 48, 8), (5, 32, 3)])
def test_plan_matches_banded(rng, runlen, c_win, cap, chunk):
    _, _, stack, n, cm = banded_case(rng)
    kw = dict(b_cm_perm=cm, c_win=c_win, a_cap=cap, b_cap=cap, chunk=chunk,
              runlen=runlen, admit_ratio=0.9)
    pt = plan_panel_runs(stack, n, n, n, **kw)
    assert pt is not None and pt.n_quads > 0 and pt.issue_ratio < 0.8
    assert_same_plan(jax_plan_runs(stack, n, n, n, **kw), pt)


@pytest.mark.parametrize("kw", [
    dict(runlen=4, c_win=8, a_cap=48, b_cap=48, chunk=4),
    dict(runlen=2, c_win=4, a_cap=64, b_cap=64, chunk=8, admit_ratio=0.85),
    dict(runlen=1), dict(runlen=4, c_win=4, a_cap=8, b_cap=8),
])
def test_plan_matches_random_and_rejections(rng, kw):
    _, _, stack = random_case(rng)
    assert_same_plan(jax_plan_runs(stack, 30, 40, 40, **kw),
                     plan_panel_runs(stack, 30, 40, 40, **kw))


def test_tiers_of_the_banded_plan(rng):
    """runlen 4 on runs of 5 (band half-width 2) fills all three tiers where
    the band is cut at the grid's edge; runlen 2 leaves the pair tier empty
    (its dummy one-element array stays)."""
    _, _, stack, n, cm = banded_case(rng)
    kw = dict(b_cm_perm=cm, c_win=16, a_cap=48, b_cap=48, chunk=4)
    p4 = plan_panel_runs(stack, n, n, n, runlen=4, **kw)
    assert min(p4.n_quads, p4.n_pairs, p4.n_singles) > 0
    assert p4.n_quads * 4 + p4.n_pairs * 2 + p4.n_singles == p4.obq[-1] * 4 + p4.obp[-1] * 2 + p4.obs[-1]
    p2 = plan_panel_runs(stack, n, n, n, runlen=2, **kw)
    assert p2.n_pairs == 0 and p2.pent.shape == (1,) and p2.obp[-1] == 0
    assert p2.n_quads > 0 and p2.n_singles > 0
    # the clamped last group: n = 114 slots in windows of 16
    assert n % 16 and p4.gstart[-1] == n - 16


@pytest.mark.parametrize("runlen", [2, 3, 4])
def test_owned_stack_is_the_stack(rng, runlen):
    """Expanding the plan (each slot once, from the group that owns it)
    gives back every stack entry, per C slot, re-sorted by A slot."""
    _, _, stack, n, cm = banded_case(rng)
    plan = plan_panel_runs(stack, n, n, n, b_cm_perm=cm, c_win=16, a_cap=48,
                           b_cap=48, chunk=4, runlen=runlen)
    c_ptr, ai, bi = panel_runs_owned_stack(plan)
    np.testing.assert_array_equal(np.diff(c_ptr), np.bincount(stack[:, 0], minlength=n))
    for c in range(n):
        want = sorted(map(tuple, stack[stack[:, 0] == c][:, 1:]))
        assert sorted(zip(ai[c_ptr[c]:c_ptr[c + 1]], bi[c_ptr[c]:c_ptr[c + 1]])) == want


@pallas
@pytest.mark.parametrize("runlen", [2, 3, 4])
def test_plain_matches_interpret_banded_clamped_last_group(rng, runlen):
    a, b, stack, n, cm = banded_case(rng)
    kw = dict(b_cm_perm=cm, c_win=16, a_cap=48, b_cap=48, chunk=4, runlen=runlen)
    pj, pt = jax_plan_runs(stack, n, n, n, **kw), plan_panel_runs(stack, n, n, n, **kw)
    ref = jax_panel_runs(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=n,
                         plan=pj, interpret=True, precision="highest")
    got = tile_stack_matmul_panel_runs(torch.from_numpy(a), torch.from_numpy(b),
                                       device_panel_run_plan(pt, "cpu"))
    assert got.shape == (n, T, T) and got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("runlen", [2, 4])
def test_plain_matches_xla_twin_and_flat_plain(rng, runlen):
    a, b, stack, n, cm = banded_case(rng)
    plan = plan_panel_runs(stack, n, n, n, b_cm_perm=cm, c_win=8, a_cap=32,
                           b_cap=32, chunk=4, runlen=runlen, admit_ratio=0.9)
    ref = tile_stack_matmul_xla(jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack),
                                n_c_tiles=n, precision="highest")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = tile_stack_matmul_panel_runs_plain(at, bt, plan)
    assert rel_err(got, ref) <= RTOL
    flat = tile_stack_matmul_plain(at, bt, device_stack(stack, n, "cpu"))
    assert rel_err(got, flat) <= RTOL


@pallas
def test_random_pattern_without_cm_perm_and_bf16(rng):
    """No column-major locality: nearly everything lands in the singles
    tier, the B store is read in its own order (``cm_perm`` None)."""
    a, b, stack = random_case(rng)
    kw = dict(b_cm_perm=None, c_win=8, a_cap=48, b_cap=48, chunk=4, runlen=4)
    pj, pt = jax_plan_runs(stack, 30, 40, 40, **kw), plan_panel_runs(stack, 30, 40, 40, **kw)
    assert pt.cm_perm is None and pt.n_singles > pt.n_quads
    ref = jax_panel_runs(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=30,
                         plan=pj, interpret=True, precision="highest")
    dp = device_panel_run_plan(pt, "cpu")
    got = tile_stack_matmul_panel_runs(torch.from_numpy(a), torch.from_numpy(b), dp)
    assert rel_err(got, ref) <= RTOL
    ref16 = jax_panel_runs(jnp.asarray(a).astype(jnp.bfloat16),
                           jnp.asarray(b).astype(jnp.bfloat16), stack, n_c_tiles=30,
                           plan=pj, interpret=True, out_dtype=jnp.float32)
    got16 = tile_stack_matmul_panel_runs(
        torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16),
        dp, out_dtype=torch.float32)
    assert got16.dtype == torch.float32
    assert rel_err(got16, ref16) <= RTOL


def test_empty_slot_is_zero(rng):
    a, b, stack = random_case(rng, n_tiles=20, n_c=9, s=40)
    stack = stack[stack[:, 0] != 4]
    plan = plan_panel_runs(stack, 9, 20, 20, c_win=4, a_cap=32, b_cap=32,
                           chunk=4, runlen=2)
    got = tile_stack_matmul_panel_runs_plain(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert not got[4].any()
    flat = tile_stack_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   device_stack(stack, 9, "cpu"))
    assert rel_err(got, flat) <= RTOL


def test_packing_span_limit():
    """``a_local << 16`` needs spans below 2^15: a wider A span raises (the
    per-entry planner's check, which the JAX run planner lacks) instead of
    wrapping the packed entries."""
    big = 1 << 16
    stack = np.array([[0, 0, 0], [0, big + 1, 1]], dtype=np.int32)
    with pytest.raises(ValueError, match="packing"):
        plan_panel_runs(stack, 1, big + 2, 2, c_win=1, a_cap=big + 8, b_cap=4,
                        chunk=1, runlen=2)


def test_device_plan_bounds(rng):
    _, _, stack, n, cm = banded_case(rng)
    plan = plan_panel_runs(stack, n, n, n, b_cm_perm=cm, c_win=8, a_cap=32,
                           b_cap=32, chunk=4, runlen=4)
    dp = device_panel_run_plan(plan, "cpu")
    assert dp.a_end <= n and dp.b_end == n and dp.cm_perm.dtype == torch.int32
    assert all(t.dtype == torch.int32 and t.is_contiguous()
               for t in (dp.gstart, dp.a_lo, dp.b_lo, dp.obq, dp.qent, dp.obp,
                         dp.pent, dp.obs, dp.sent))


def panel_run_job_walk(plan):
    """``PanelRunJob`` of ``csrc/panel_runs_matmul.cu`` in plain Python: the
    cell → slot map with the clamped last group's early return, the run
    ``v in [0, n)`` and the pair function's tier expansion. Returns
    {C slot: [(a, b), ...]} and the number of cells that returned early."""
    cw, R = plan.c_win, plan.runlen
    obq, obp, obs = plan.obq, plan.obp, plan.obs
    out, returned = {}, 0
    for cell in range(plan.n_groups * cw):
        g = cell // cw
        slot = int(plan.gstart[g]) + cell % cw
        if slot < g * cw:
            returned += 1
            continue
        n = int((obq[cell + 1] - obq[cell]) * R + (obp[cell + 1] - obp[cell]) * 2
                + obs[cell + 1] - obs[cell])
        pairs = []
        for v in range(n):
            q0 = int(obq[cell])
            nq = int(obq[cell + 1] - q0) * R
            if v < nq:
                packed, r = int(plan.qent[q0 + v // R]), v % R
            else:
                p0 = int(obp[cell])
                npair = int(obp[cell + 1] - p0) * 2
                w = v - nq
                if w < npair:
                    packed, r = int(plan.pent[p0 + (w >> 1)]), w & 1
                else:
                    packed, r = int(plan.sent[int(obs[cell]) + w - npair]), 0
            sb = int(plan.b_lo[g]) + (packed & 0xFFFF) + r
            pairs.append((int(plan.a_lo[g]) + (packed >> 16) + r,
                          sb if plan.cm_perm is None else int(plan.cm_perm[sb])))
        assert slot not in out  # every C slot has one owner
        out[slot] = pairs
    return out, returned


@pytest.mark.parametrize("with_cm", [True, False])
@pytest.mark.parametrize("runlen", [2, 3, 4])
def test_job_walk_lists_the_owned_stack(rng, runlen, with_cm):
    """All three tiers (the pair tier empty at runlen 2), B through the
    column-major permutation and without one, the clamped last group."""
    _, _, stack, n, cm = banded_case(rng)
    plan = plan_panel_runs(stack, n, n, n, b_cm_perm=cm if with_cm else None,
                           c_win=16, a_cap=64, b_cap=64, chunk=4, runlen=runlen)
    assert plan.gstart[-1] % 16  # clamped
    if with_cm:
        assert plan.n_quads > 0 and plan.n_singles > 0
        assert (plan.n_pairs > 0) == (runlen > 2)
    walk, returned = panel_run_job_walk(plan)
    assert returned == plan.n_groups * 16 - n and sorted(walk) == list(range(n))
    c_ptr, ai, bi = panel_runs_owned_stack(plan)
    assert c_ptr[-1] == len(stack)
    for c in range(n):
        got = list(zip(ai[c_ptr[c]:c_ptr[c + 1]].tolist(), bi[c_ptr[c]:c_ptr[c + 1]].tolist()))
        assert got == walk[c]


def test_job_walk_random_pattern_and_empty_slot(rng):
    """Mostly singles, no permutation, and a C slot without entries (its
    cell walks an empty run: a zero tile)."""
    _, _, stack = random_case(rng)
    stack = stack[stack[:, 0] != 7]
    plan = plan_panel_runs(stack, 30, 40, 40, b_cm_perm=None, c_win=8, a_cap=48,
                           b_cap=48, chunk=4, runlen=3)
    walk, returned = panel_run_job_walk(plan)
    assert walk[7] == [] and returned == plan.n_groups * 8 - 30
    c_ptr, ai, bi = panel_runs_owned_stack(plan)
    for c in range(30):
        assert list(zip(ai[c_ptr[c]:c_ptr[c + 1]].tolist(),
                        bi[c_ptr[c]:c_ptr[c + 1]].tolist())) == walk[c]
        want = sorted(map(tuple, stack[stack[:, 0] == c][:, 1:].tolist()))
        assert sorted(walk[c]) == want
