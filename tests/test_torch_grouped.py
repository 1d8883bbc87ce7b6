"""Port parity, K4 (the grouped kernel): ``_plan_groups`` array for array
against the JAX package's, and the port's plain version — what
``tile_stack_matmul_grouped`` runs for CPU tensors — against the JAX Pallas
grouped kernel in interpret mode and the XLA twin of the stack product, on
the same numpy stores and stacks.

Tolerances, relative to the largest reference entry: float32 at "highest"
1e-5 (IEEE float32 on both sides; the partial sums of a split run and each
tile product's own k-sum are taken in another order), bf16 inputs 1e-5
(products of bf16 values are exact in float32), float64 1e-12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.mm.kernels import _HAVE_PALLAS, tile_stack_matmul_xla
from dbcsr_tpu.mm.kernels import _plan_groups as jax_plan_groups
from dbcsr_tpu.mm.kernels import tile_stack_matmul_grouped as jax_grouped

from dbcsr_tpu_torch.mm.kernels import (
    _plan_groups,
    device_group_plan,
    device_stack,
    tile_stack_matmul_grouped,
    tile_stack_matmul_grouped_plain,
    tile_stack_matmul_plain,
)

torch.set_num_threads(1)

T = 8
RTOL = 1e-5
pallas = pytest.mark.skipif(not _HAVE_PALLAS, reason="no pallas")
#: (group, cache): the JAX test's three, whose small caches force split C
#: runs, and the engine's defaults
KNOBS = [(4, 16), (8, 8), (2, 4), (8, 128)]


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def case(rng, n_tiles=20, n_c=11, s=120, dtype=np.float32):
    """As tests/test_kernels_interpret.py: a uniform-random c-sorted stack."""
    a = rng.standard_normal((n_tiles, T, T)).astype(dtype)
    b = rng.standard_normal((n_tiles, T, T)).astype(dtype)
    stack = np.stack(
        [np.sort(rng.integers(0, n_c, s)), rng.integers(0, n_tiles, s),
         rng.integers(0, n_tiles, s)], axis=1,
    ).astype(np.int32)
    return a, b, stack


@pytest.mark.parametrize("group,cache", KNOBS)
def test_plan_matches(rng, group, cache):
    _, _, stack = case(rng)
    pj = jax_plan_groups(stack, 11, group, cache)
    pt = _plan_groups(stack, 11, group, cache)
    for vj, vt in zip(pj[:5], pt[:5]):
        np.testing.assert_array_equal(vj, vt)
        assert vj.dtype == vt.dtype
    assert pj[5] == pt[5]


def test_plan_empty_and_multiple_of_group(rng):
    for stack, n_c in ((np.zeros((0, 3), np.int32), 3),
                       (np.stack([np.arange(8), np.arange(8), np.arange(8)], 1).astype(np.int32), 8)):
        pj, pt = jax_plan_groups(stack, n_c, 4, 8), _plan_groups(stack, n_c, 4, 8)
        for vj, vt in zip(pj[:5], pt[:5]):
            np.testing.assert_array_equal(vj, vt)
        assert pj[5] == pt[5]
    # one entry per C slot, n_c a multiple of the group: no join is needed
    plan = device_group_plan(stack, 8, 8, "cpu", group=4, cache=8)
    assert plan.join is None and plan.split_runs == 0


@pallas
@pytest.mark.parametrize("group,cache", KNOBS)
def test_plain_matches_interpret(rng, group, cache):
    a, b, stack = case(rng)
    ref = jax_grouped(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=11,
                      group=group, cache=cache, ring=4, interpret=True,
                      precision="highest")
    plan = device_group_plan(stack, 11, 20, "cpu", group=group, cache=cache)
    got = tile_stack_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert got.shape == (11, T, T) and got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL
    if cache < 16:
        assert plan.split_runs > 0  # the case must exercise the join


@pytest.mark.parametrize("group,cache", KNOBS)
def test_plain_matches_xla_twin_and_flat_plain(rng, group, cache):
    a, b, stack = case(rng)
    ref = tile_stack_matmul_xla(jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack),
                                n_c_tiles=11, precision="highest")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    plan = device_group_plan(stack, 11, 20, "cpu", group=group, cache=cache)
    got = tile_stack_matmul_grouped_plain(at, bt, plan)
    assert rel_err(got, ref) <= RTOL
    flat = tile_stack_matmul_plain(at, bt, device_stack(stack, 11, "cpu"))
    if plan.split_runs == 0:
        # no run was split: every C tile is summed in stack order, as K1's
        assert torch.equal(got, flat)
    else:
        assert rel_err(got, flat) <= RTOL


@pallas
def test_bf16_inputs_f32_output(rng):
    a, b, stack = case(rng)
    ref = jax_grouped(jnp.asarray(a).astype(jnp.bfloat16),
                      jnp.asarray(b).astype(jnp.bfloat16), stack, n_c_tiles=11,
                      group=4, cache=8, interpret=True, out_dtype=jnp.float32)
    plan = device_group_plan(stack, 11, 20, "cpu", group=4, cache=8)
    got = tile_stack_matmul_grouped(
        torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16),
        plan, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL


def test_float64(rng):
    a, b, stack = case(rng, dtype=np.float64)
    ref = np.zeros((11, T, T))
    for c, i, j in stack:
        ref[c] += a[i] @ b[j]
    plan = device_group_plan(stack, 11, 20, "cpu", group=2, cache=4)
    got = tile_stack_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert got.dtype == torch.float64 and plan.split_runs > 0
    assert rel_err(got, ref) <= 1e-12


def test_padding_rows_and_empty_slots_are_zero(rng):
    a, b, stack = case(rng, n_c=9, s=40)
    stack = stack[stack[:, 0] != 4]  # slot 4 stays in [0, n_c) but empty
    plan = device_group_plan(stack, 9, 20, "cpu", group=4, cache=8)
    assert (plan.seg_host == 9).any()  # padding rows exist
    got = tile_stack_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert got.shape == (9, T, T) and not got[4].any()
    flat = tile_stack_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   device_stack(stack, 9, "cpu"))
    assert rel_err(got, flat) <= RTOL


def test_empty_stack_gives_zero_tiles():
    plan = device_group_plan(np.zeros((0, 3), np.int32), 5, 4, "cpu")
    x = torch.ones((4, T, T))
    got = tile_stack_matmul_grouped(x, x, plan)
    assert got.shape == (5, T, T) and not got.any()


@pytest.mark.parametrize("kw,n_b", [
    (dict(), 1 << 20), (dict(group=9), 20), (dict(cache=257), 20),
])
def test_limits_raise_as_in_jax(rng, kw, n_b):
    """The packing's caps: b tiles < 2^20 (checked on the count alone, no
    store of that size is made), group <= 8, cache <= 256."""
    a, b, stack = case(rng)
    with pytest.raises(ValueError, match="grouped kernel limits exceeded"):
        device_group_plan(stack, 11, n_b, "cpu", **kw)
    if n_b == 20:
        with pytest.raises(ValueError, match="grouped kernel limits exceeded"):
            jax_grouped(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=11, **kw)
    # one below the cap plans
    assert device_group_plan(stack, 11, (1 << 20) - 1, "cpu").n_groups > 0


def test_device_plan_arrays_and_row_bounds(rng):
    _, _, stack = case(rng)
    plan = device_group_plan(stack, 11, 20, "cpu", group=4, cache=8)
    assert all(t.dtype == torch.int32 and t.is_contiguous()
               for t in (plan.lbounds, plan.abounds, plan.aload, plan.entries))
    # the rows' entry ranges tile the stack in order; each row holds one c
    lb, a_slot, b_slot = plan.entry_slots()
    assert lb[0] == 0 and lb[-1] == len(stack) and (np.diff(lb) >= 0).all()
    np.testing.assert_array_equal(a_slot, stack[:, 1])
    np.testing.assert_array_equal(b_slot, stack[:, 2])
    for q in range(len(lb) - 1):
        if lb[q + 1] > lb[q]:
            assert (stack[lb[q]:lb[q + 1], 0] == plan.seg_host[q]).all()
        else:
            assert plan.seg_host[q] == 11 or lb[q + 1] == lb[q]


def _way_case(rng, way):
    """Stacks for each way K4's rows reach the C store: ``padding`` (11 C
    slots in groups of 4: the kernel writes the store, a padding row writes
    nothing), ``unproduced`` (slot 4 has no entry and must come out zero),
    ``split`` (a cache of 4 A tiles cuts C runs across groups: padded rows,
    then the ordered segment sum)."""
    a, b, stack = case(rng)
    if way == "unproduced":
        stack = stack[stack[:, 0] != 4]
    group, cache = (2, 4) if way == "split" else (4, 128)
    return a, b, stack, group, cache


WAYS = ["padding", "unproduced", "split"]


@pytest.mark.parametrize("way", WAYS)
def test_row_to_slot_map_matches_jax_seg(rng, way):
    """The row -> C slot map the CUDA kernel writes through is ``_plan_groups``'
    ``seg`` of the JAX package, exactly: the C slot for a real row, -1 where
    seg marks a padding row; when a run is split the kernel writes padded
    rows (the identity) and the ordered segment sum is planned over seg."""
    _, _, stack, group, cache = _way_case(rng, way)
    seg = jax_plan_groups(stack, 11, group, cache)[4]
    plan = device_group_plan(stack, 11, 20, "cpu", group=group, cache=cache)
    np.testing.assert_array_equal(plan.seg_host, seg)
    out_slot = plan.out_slot.numpy()
    assert plan.out_slot.dtype == torch.int32 and len(out_slot) == len(seg)
    produced = seg[seg < 11]
    if way == "split":
        assert plan.join is not None and plan.split_runs > 0
        np.testing.assert_array_equal(out_slot, np.arange(len(seg)))
        assert len(plan.zero_slots) == 0
    else:
        assert plan.join is None and plan.split_runs == 0
        np.testing.assert_array_equal(out_slot, np.where(seg < 11, seg, -1))
        assert (out_slot == -1).any()  # padding rows exist in both cases
        np.testing.assert_array_equal(
            plan.zero_slots.numpy(), np.setdiff1d(np.arange(11), produced))
        assert (len(plan.zero_slots) > 0) == (way == "unproduced")


@pallas
@pytest.mark.parametrize("way", WAYS)
def test_each_way_matches_interpret_f32(rng, way):
    a, b, stack, group, cache = _way_case(rng, way)
    ref = jax_grouped(jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=11,
                      group=group, cache=cache, ring=4, interpret=True,
                      precision="highest")
    plan = device_group_plan(stack, 11, 20, "cpu", group=group, cache=cache)
    got = tile_stack_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert got.shape == (11, T, T) and got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL
    if way == "unproduced":
        assert not got[4].any() and not np.asarray(ref)[4].any()


@pytest.mark.parametrize("way", WAYS)
def test_each_way_matches_xla_twin_f64(rng, way):
    a, b, stack, group, cache = _way_case(rng, way)
    a, b = a.astype(np.float64), b.astype(np.float64)
    ref = tile_stack_matmul_xla(jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack),
                                n_c_tiles=11, precision="highest")
    assert np.asarray(ref).dtype == np.float64
    plan = device_group_plan(stack, 11, 20, "cpu", group=group, cache=cache)
    got = tile_stack_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b), plan)
    assert got.dtype == torch.float64 and got.shape == (11, T, T)
    assert rel_err(got, ref) <= 1e-12
