"""Port parity, K2 (the panel kernel): ``plan_panel_stack`` field for field
against the JAX package's planner, and the port's plain version — what
``tile_stack_matmul_panel`` runs for CPU tensors — against the JAX Pallas
panel kernel in interpret mode, on the same numpy stores and stacks.

Tolerance 1e-5 relative to the largest reference entry (float32 inputs at
"highest", or bf16 slabs with float32 output): products are exact or IEEE
float32 on both sides, only the order of the float32 sums differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.mm.kernels import _HAVE_PALLAS
from dbcsr_tpu.mm.panel import plan_panel_stack as jax_plan_panel
from dbcsr_tpu.mm.panel import tile_stack_matmul_panel as jax_panel

from dbcsr_tpu_torch.mm.kernels import device_stack, tile_stack_matmul_plain
from dbcsr_tpu_torch.mm.panel import (
    PanelPlan,
    device_panel_plan,
    panel_owned_stack,
    plan_panel_stack,
    tile_stack_matmul_panel,
    tile_stack_matmul_panel_plain,
)

torch.set_num_threads(1)

T = 8
RTOL = 1e-5
pallas = pytest.mark.skipif(not _HAVE_PALLAS, reason="no pallas")


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def random_case(rng, n_tiles=40, n_c=30, s=200):
    """As tests/test_panel_kernel.py: uniform-random stack, every slot hit."""
    a = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    b = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    c_col = np.sort(rng.integers(0, n_c, s)).astype(np.int32)
    stack = np.stack(
        [c_col, rng.integers(0, n_tiles, s).astype(np.int32),
         rng.integers(0, n_tiles, s).astype(np.int32)], axis=1
    )
    stack[:n_c, 0] = np.arange(n_c, dtype=np.int32)
    stack = stack[np.argsort(stack[:, 0], kind="stable")]
    return a, b, stack


def banded_case(rng, mt=24, w=2):
    """As tests/test_panel_kernel.py: banded tile pattern times itself."""
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
    return a, b, stack, n


def assert_same_plan(pj, pt):
    if pj is None or pt is None:
        assert pj is None and pt is None
        return
    for f in PanelPlan.__dataclass_fields__:
        vj, vt = getattr(pj, f), getattr(pt, f)
        if isinstance(vt, np.ndarray):
            np.testing.assert_array_equal(vj, vt, err_msg=f)
            assert vj.dtype == vt.dtype, f
        else:
            assert vj == vt, f
    assert pj.traffic_ratio == pt.traffic_ratio


@pytest.mark.parametrize("c_win,cap,chunk,admit", [
    (4, 48, 4, None), (8, 64, 8, None), (16, 64, 4, None), (4, 64, 4, 0.85),
])
def test_plan_matches_random(rng, c_win, cap, chunk, admit):
    a, b, stack = random_case(rng)
    kw = dict(c_win=c_win, a_cap=cap, b_cap=cap, chunk=chunk, admit_ratio=admit)
    assert_same_plan(jax_plan_panel(stack, 30, 40, 40, **kw),
                     plan_panel_stack(stack, 30, 40, 40, **kw))


@pytest.mark.parametrize("c_win,cap,chunk", [(8, 32, 4), (16, 48, 8), (5, 32, 3)])
def test_plan_matches_banded(rng, c_win, cap, chunk):
    _, _, stack, n = banded_case(rng)
    kw = dict(c_win=c_win, a_cap=cap, b_cap=cap, chunk=chunk, admit_ratio=0.9)
    pj, pt = jax_plan_panel(stack, n, n, n, **kw), plan_panel_stack(stack, n, n, n, **kw)
    assert pt is not None and pt.traffic_ratio < 0.9
    assert_same_plan(pj, pt)


def test_plan_rejections_match(rng):
    _, _, stack = random_case(rng, n_tiles=400, n_c=12, s=60)
    for kw in (dict(c_win=4, a_cap=64, b_cap=64),
               dict(c_win=4, a_cap=512, b_cap=512, admit_ratio=0.85)):
        assert jax_plan_panel(stack, 12, 400, 400, **kw) is None
        assert plan_panel_stack(stack, 12, 400, 400, **kw) is None


@pallas
@pytest.mark.parametrize("c_win,cap,chunk", [(4, 48, 4), (16, 64, 4)])
def test_plain_matches_interpret_random(rng, c_win, cap, chunk):
    a, b, stack = random_case(rng)
    plan = plan_panel_stack(stack, 30, 40, 40, c_win=c_win, a_cap=cap,
                            b_cap=cap, chunk=chunk)
    jplan = jax_plan_panel(stack, 30, 40, 40, c_win=c_win, a_cap=cap,
                           b_cap=cap, chunk=chunk)
    ref = jax_panel(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=30,
                    plan=jplan, interpret=True, precision="highest")
    got = tile_stack_matmul_panel(torch.from_numpy(a), torch.from_numpy(b),
                                  device_panel_plan(plan, "cpu"))
    assert got.shape == (30, T, T) and got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL


@pallas
def test_plain_matches_interpret_banded_clamped_last_group(rng):
    """n_c = 114 slots in windows of 16: the last group is clamped to slot
    98 and re-covers slots 98-111 of its predecessor; every slot must still
    hold its sum exactly once."""
    a, b, stack, n = banded_case(rng)
    plan = plan_panel_stack(stack, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    assert n % 16 and plan.gstart[-1] == n - 16 and plan.gstart[-1] % 16
    assert plan.entries.size > len(stack)  # the overlap slots are planned twice
    ref = jax_panel(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=n,
                    plan=jax_plan_panel(stack, n, n, n, c_win=16, a_cap=48,
                                        b_cap=48, chunk=4),
                    interpret=True, precision="highest")
    got = tile_stack_matmul_panel(torch.from_numpy(a), torch.from_numpy(b),
                                  device_panel_plan(plan, "cpu"))
    assert rel_err(got, ref) <= RTOL
    # each slot is taken once, from the group that first reaches it
    c_ptr, ai, bi = panel_owned_stack(plan)
    np.testing.assert_array_equal(np.diff(c_ptr), np.bincount(stack[:, 0], minlength=n))
    np.testing.assert_array_equal(ai, stack[:, 1])
    np.testing.assert_array_equal(bi, stack[:, 2])


@pallas
def test_plain_matches_interpret_empty_slots(rng):
    a, b, stack = random_case(rng, n_tiles=20, n_c=9, s=40)
    stack = stack[stack[:, 0] != 4]  # slot 4 stays in [0, n_c) but empty
    kw = dict(c_win=4, a_cap=32, b_cap=32, chunk=4)
    plan = plan_panel_stack(stack, 9, 20, 20, **kw)
    ref = jax_panel(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=9,
                    interpret=True, precision="highest", **kw)
    got = tile_stack_matmul_panel(torch.from_numpy(a), torch.from_numpy(b),
                                  device_panel_plan(plan, "cpu"))
    assert rel_err(got, ref) <= RTOL
    assert not got[4].any()


@pallas
def test_bf16_slabs_f32_output(rng):
    a, b, stack = random_case(rng, s=120)
    kw = dict(c_win=8, a_cap=48, b_cap=48, chunk=4)
    ref = jax_panel(jnp.asarray(a).astype(jnp.bfloat16),
                    jnp.asarray(b).astype(jnp.bfloat16), stack, n_c_tiles=30,
                    interpret=True, out_dtype=jnp.float32, **kw)
    plan = plan_panel_stack(stack, 30, 40, 40, **kw)
    got = tile_stack_matmul_panel(
        torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16),
        device_panel_plan(plan, "cpu"), out_dtype=torch.float32,
    )
    assert got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL


def test_panel_plain_equals_flat_plain_bitwise(rng):
    """The panel plan keeps stack order inside every slot, so K2 sums in
    exactly K1's order: the plain versions agree bitwise (as the kernels
    do on the card)."""
    a, b, stack, n = banded_case(rng, mt=30)
    plan = plan_panel_stack(stack, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(
        tile_stack_matmul_panel_plain(at, bt, plan),
        tile_stack_matmul_plain(at, bt, device_stack(stack, n, "cpu")),
    )


def test_packing_limits_are_checked():
    """A group span past the int32 packing (a_local < 2^15, b_local <
    2^16) must raise instead of corrupting entries."""
    big = 1 << 16
    stack = np.array([[0, 0, 0], [0, 1, big + 1]], dtype=np.int32)
    with pytest.raises(ValueError, match="packing"):
        plan_panel_stack(stack, 1, 2, big + 2, c_win=1, a_cap=4,
                         b_cap=big + 8, chunk=1)


def test_device_plan_bounds(rng):
    _, _, stack, n = banded_case(rng)
    plan = plan_panel_stack(stack, n, n, n, c_win=8, a_cap=32, b_cap=32, chunk=4)
    dp = device_panel_plan(plan, "cpu")
    assert dp.a_end <= n and dp.b_end <= n
    assert all(t.dtype == torch.int32 and t.is_contiguous()
               for t in (dp.gstart, dp.a_lo, dp.b_lo, dp.obounds, dp.entries))
