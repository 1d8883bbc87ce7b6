"""Port parity, K5 (the band driver): ``plan_band`` array for array against
the JAX package's planner, and the port's plain version — what
``band_matmul`` runs for CPU tensors — against the JAX Pallas band kernel in
interpret mode and its XLA twin, on the same numpy stores. Then the arrays
the CUDA kernel reads: ``band_owned_stack`` (the band's flat stack in the
kernel's order) against a plain-Python walk of the kernel's pair function,
and the ordered run sums over it against the band product of both packages.

Tolerances, relative to the largest reference entry: float32 at "highest"
1e-5 (IEEE float32 products on both sides; the sums over d1 run in the same
order but each tile product's own k-sum does not), bf16 inputs 1e-5 too
(the products of bf16 values are exact in float32 on both sides), float64
1e-12 (against the XLA twin; the Pallas kernel takes no float64). The run
sums over the owned stack against the wide-matmul plain version: 1e-5 in
float32 (the same products; the wide matmul may sum its K = Wa·T terms in
another order), 1e-13 in float64.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.mm.band import _HAVE_PALLAS, _band_matmul_xla, band_matmul_pallas
from dbcsr_tpu.mm.band import plan_band as jax_plan_band
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores as jax_tile_plan

from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.mm.band import (
    BandPlan,
    band_matmul,
    band_matmul_plain,
    band_owned_stack,
    band_run_cells,
    device_band_plan,
    plan_band,
)
from dbcsr_tpu_torch.mm.kernels import (
    device_stack,
    run_sums_plain,
    tile_stack_matmul_plain,
)

torch.set_num_threads(1)

T = 8
RTOL = 1e-5
pallas = pytest.mark.skipif(not _HAVE_PALLAS, reason="no pallas")


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def band_coords(nrows, ncols, lo, hi, rng=None, fill=1.0):
    """Row-major tile coords with lo <= col - row <= hi inside the grid, a
    share ``fill`` of them kept (the extreme diagonals always present)."""
    out = []
    for r in range(nrows):
        for c in range(ncols):
            if lo <= c - r <= hi and (
                fill >= 1.0 or c - r in (lo, hi) or rng.random() < fill
            ):
                out.append((r, c))
    return np.asarray(out, dtype=np.int64)


#: (Mt, Kt, Nt, A diagonals, B diagonals, fill): square symmetric band,
#: negative off_a only, rectangular grids where k = m + off_a + d1 runs off
#: both ends, a band with holes, and one whose holes sit on A's and B's
#: extreme diagonals (fill < 0: every third tile of those diagonals is
#: dropped), so that C tiles lose the first and the last cell of their runs
CASES = {
    "square": (10, 10, 10, (-2, 2), (-2, 2), 1.0),
    "neg_off_a": (9, 9, 9, (-3, -1), (0, 2), 1.0),
    "pos_off_a": (9, 9, 9, (2, 3), (-1, 1), 1.0),
    "wide_k": (6, 11, 8, (-1, 4), (-4, 1), 1.0),
    "tall_k": (11, 5, 9, (-5, 1), (0, 3), 1.0),
    "holes": (14, 14, 14, (-2, 3), (-3, 2), 0.6),
    "hole_ends": (15, 15, 15, (-2, 2), (-1, 2), -1.0),
}


def case(name, rng, dtype=np.float32):
    mt, kt, nt, (alo, ahi), (blo, bhi), fill = CASES[name]
    if fill < 0:
        ac, bc = (
            np.asarray([(r, c) for r, c in band_coords(nr, ncol, lo, hi)
                        if c - r not in (lo, hi) or r % 3 != 1], dtype=np.int64)
            for nr, ncol, lo, hi in ((mt, kt, alo, ahi), (kt, nt, blo, bhi)))
    else:
        ac = band_coords(mt, kt, alo, ahi, rng, fill)
        bc = band_coords(kt, nt, blo, bhi, rng, fill)
    tp = jax_tile_plan(ac, (mt, kt), bc, (kt, nt))
    a = rng.standard_normal((len(ac), T, T)).astype(dtype)
    b = rng.standard_normal((len(bc), T, T)).astype(dtype)
    return ac, bc, (mt, kt, nt), tp, a, b


def plans(ac, bc, grid, tp, **kw):
    mt, kt, nt = grid
    args = (ac, (mt, kt), bc, (kt, nt), tp.c_tile_keys)
    return jax_plan_band(*args, tile=T, **kw), plan_band(*args, tile=T, **kw)


def assert_same_plan(pj, pt):
    if pj is None or pt is None:
        assert pj is None and pt is None
        return
    for f in BandPlan.__dataclass_fields__:
        vj, vt = getattr(pj, f), getattr(pt, f)
        if isinstance(vt, np.ndarray):
            np.testing.assert_array_equal(vj, vt, err_msg=f)
            assert vj.dtype == vt.dtype, f
        else:
            assert vj == vt, f


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches(rng, name):
    ac, bc, grid, tp, _, _ = case(name, rng)
    pj, pt = plans(ac, bc, grid, tp)
    assert pt is not None
    assert_same_plan(pj, pt)
    assert pt.hw_flops == 2.0 * pt.wa * pt.wb * grid[0] * T**3


@pytest.mark.parametrize("kw", [
    dict(max_products=8), dict(n_stack=10, flop_factor=0.75),
    dict(n_stack=10_000, flop_factor=0.75), dict(n_stack=200, flop_factor=6.0 * 0.125),
])
def test_plan_admission_matches(rng, kw):
    ac, bc, grid, tp, _, _ = case("square", rng)
    assert_same_plan(*plans(ac, bc, grid, tp, **kw))


def test_plan_empty_operand_is_none():
    empty = np.zeros((0, 2), np.int64)
    some = band_coords(4, 4, 0, 0)
    for a, b in ((empty, some), (some, empty)):
        args = (a, (4, 4), b, (4, 4), np.zeros(0, np.int64))
        assert jax_plan_band(*args, tile=T) is None and plan_band(*args, tile=T) is None


@pallas
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_interpret(rng, name):
    ac, bc, grid, tp, a, b = case(name, rng)
    pj, pt = plans(ac, bc, grid, tp)
    ref = band_matmul_pallas(jnp.asarray(a), jnp.asarray(b), pj, tile=T,
                             precision="highest", interpret=True)
    got = band_matmul(torch.from_numpy(a), torch.from_numpy(b),
                      device_band_plan(pt, "cpu"), tile=T)
    assert got.shape == (tp.n_c_tiles, T, T) and got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_xla_twin_and_flat_stack(rng, name):
    """The XLA twin, and the flat stack product over the same tile plan (the
    band result is in product-key order, which is the stack's C order)."""
    ac, bc, grid, tp, a, b = case(name, rng)
    pj, pt = plans(ac, bc, grid, tp)
    ref = _band_matmul_xla(jnp.asarray(a), jnp.asarray(b), pj, tile=T,
                           precision="highest")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = band_matmul_plain(at, bt, pt)
    assert rel_err(got, ref) <= RTOL
    flat = tile_stack_matmul_plain(at, bt, device_stack(tp.stack, tp.n_c_tiles, "cpu"))
    assert rel_err(got, flat) <= RTOL


@pytest.mark.parametrize("name", ["square", "wide_k", "holes"])
def test_float64(rng, name):
    ac, bc, grid, tp, a, b = case(name, rng, np.float64)
    pj, pt = plans(ac, bc, grid, tp)
    ref = _band_matmul_xla(jnp.asarray(a), jnp.asarray(b), pj, tile=T,
                           precision="highest")
    got = band_matmul(torch.from_numpy(a), torch.from_numpy(b), pt, tile=T)
    assert got.dtype == torch.float64
    assert rel_err(got, ref) <= 1e-12


@pallas
def test_default_precision_feeds_bf16(rng):
    """At "default" with ``stack_bf16_inputs`` both packages round the
    stores to bf16 and accumulate in float32; the result keeps the stores'
    dtype. With the knob off the float32 stores go in as they are."""
    ac, bc, grid, tp, a, b = case("square", rng)
    pj, pt = plans(ac, bc, grid, tp)
    ref = band_matmul_pallas(jnp.asarray(a), jnp.asarray(b), pj, tile=T,
                             precision="default", interpret=True)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = band_matmul(at, bt, pt, tile=T, precision="default")
    assert got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL
    exact = band_matmul(at, bt, pt, tile=T)
    assert 1e-4 < rel_err(got, exact) < 2e-2
    with config_override(stack_bf16_inputs=False):
        assert torch.equal(band_matmul(at, bt, pt, tile=T, precision="default"), exact)


def test_bitwise_deterministic_and_tile_check(rng):
    ac, bc, grid, tp, a, b = case("holes", rng)
    _, pt = plans(ac, bc, grid, tp)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(band_matmul(at, bt, pt), band_matmul(at, bt, pt))
    with pytest.raises(ValueError, match="tile"):
        band_matmul(at, bt, pt, tile=2 * T)


def test_device_plan_arrays(rng):
    ac, bc, grid, tp, a, b = case("wide_k", rng)
    _, pt = plans(ac, bc, grid, tp)
    dp = device_band_plan(pt, "cpu")
    assert dp.a_end == len(ac) and dp.b_end == len(bc)
    assert all(t.dtype == torch.int32 and t.is_contiguous()
               for t in (dp.a_pack, dp.b_pack, dp.c_unpack))
    assert pt.off_a < 0 and grid[0] != grid[1] != grid[2]


def band_job_walk(plan):
    """``BandJob`` of ``csrc/band_matmul.cu`` in plain Python: for output
    tile ``i`` the run, the pair function's index arithmetic, and the
    cursor's skip of a pair with a negative slot. Returns the (a, b) lists
    per C tile and, per tile, which cells of its run were skipped."""
    a_pack, b_pack = plan.a_pack, plan.b_pack
    wa, wb, mt, kt, off_a = plan.wa, plan.wb, plan.mt, plan.kt, plan.off_a
    pairs, skipped = [], []
    for pos in plan.c_unpack:
        dc, m = int(pos) // mt, int(pos) % mt
        d_lo, d_hi = max(dc - (wb - 1), 0), min(dc, wa - 1)
        out, skip = [], []
        for d1 in range(d_lo, d_hi + 1):
            k = m + off_a + d1
            ij = (-1, -1) if k < 0 or k >= kt else (
                int(a_pack[d1 * mt + m]), int(b_pack[(dc - d1) * kt + k]))
            skip.append(ij[0] < 0 or ij[1] < 0)
            if not skip[-1]:
                out.append(ij)
        pairs.append(out)
        skipped.append(skip)
    return pairs, skipped


@pytest.mark.parametrize("name", list(CASES))
def test_job_walk_lists_the_owned_stack(rng, name):
    """The kernel's walk, the vectorised owned stack and the tile plan's
    stack are the same products per C tile, the first two in the same
    order (``d1`` ascending)."""
    ac, bc, grid, tp, _, _ = case(name, rng)
    _, pt = plans(ac, bc, grid, tp)
    pairs, skipped = band_job_walk(pt)
    c_ptr, ai, bi = band_owned_stack(pt)
    assert c_ptr[0] == 0 and c_ptr[-1] == len(ai) == len(bi) == len(tp.stack)
    run, a_cell, b_cell = band_run_cells(pt)
    for c, (want, skip) in enumerate(zip(pairs, skipped)):
        got = list(zip(ai[c_ptr[c]:c_ptr[c + 1]].tolist(), bi[c_ptr[c]:c_ptr[c + 1]].tolist()))
        assert got == want
        st = tp.stack[tp.stack[:, 0] == c]
        assert sorted(got) == sorted(map(tuple, st[:, 1:].tolist()))
        absent = ((a_cell[c] < 0) | (b_cell[c] < 0))[run[c]]
        assert absent.tolist() == skip


def test_hole_ends_case_skips_first_and_last_cells(rng):
    """The case built for it: some runs lose their first cell, some their
    last, some two cells in a row — the cursor's skip in every position."""
    ac, bc, grid, tp, _, _ = case("hole_ends", rng)
    _, pt = plans(ac, bc, grid, tp)
    _, skipped = band_job_walk(pt)
    inner = [s for s in skipped if len(s) >= 3 and not all(s)]
    assert any(s[0] and not s[1] for s in inner)
    assert any(s[-1] and not s[-2] for s in inner)
    assert any(a and b for s in inner for a, b in zip(s, s[1:]))


@pytest.mark.parametrize("name", list(CASES))
def test_owned_stack_sums_match_plain_and_jax(rng, name):
    ac, bc, grid, tp, a, b = case(name, rng)
    pj, pt = plans(ac, bc, grid, tp)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    c_ptr, ai, bi = band_owned_stack(pt)
    got = run_sums_plain(at, bt, c_ptr, torch.from_numpy(ai), torch.from_numpy(bi),
                         torch.float32)
    assert got.shape == (tp.n_c_tiles, T, T)
    assert rel_err(got, band_matmul_plain(at, bt, pt)) <= RTOL
    ref = _band_matmul_xla(jnp.asarray(a), jnp.asarray(b), pj, tile=T, precision="highest")
    assert rel_err(got, ref) <= RTOL
    if _HAVE_PALLAS:
        ref = band_matmul_pallas(jnp.asarray(a), jnp.asarray(b), pj, tile=T,
                                 precision="highest", interpret=True)
        assert rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("name", ["square", "wide_k", "holes", "hole_ends"])
def test_owned_stack_sums_float64(rng, name):
    ac, bc, grid, tp, a, b = case(name, rng, np.float64)
    pj, pt = plans(ac, bc, grid, tp)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    c_ptr, ai, bi = band_owned_stack(pt)
    got = run_sums_plain(at, bt, c_ptr, torch.from_numpy(ai), torch.from_numpy(bi),
                         torch.float64)
    assert got.dtype == torch.float64
    assert rel_err(got, band_matmul_plain(at, bt, pt)) <= 1e-13
    ref = _band_matmul_xla(jnp.asarray(a), jnp.asarray(b), pj, tile=T, precision="highest")
    assert rel_err(got, ref) <= 1e-12


def test_owned_stack_of_a_tile_with_no_present_cell(rng):
    """C positions inside the band that no product reaches (every cell of
    their runs absent or out of range): empty runs in the owned stack, zero
    tiles in the plain version."""
    ac, bc, grid, tp, a, b = case("hole_ends", rng)
    mt, kt, nt = grid
    (alo, ahi), (blo, bhi) = CASES["hole_ends"][3:5]
    band = [r * nt + c for r in range(mt) for c in range(nt)
            if alo + blo <= c - r <= ahi + bhi]
    keys = np.asarray(sorted(band), dtype=np.int64)
    empty = np.flatnonzero(~np.isin(keys, tp.c_tile_keys))
    assert len(empty) >= 5 and len(keys) == len(empty) + tp.n_c_tiles
    pt = plan_band(ac, (mt, kt), bc, (kt, nt), keys, tile=T)
    c_ptr, ai, bi = band_owned_stack(pt)
    lens = np.diff(c_ptr)
    assert not lens[empty].any() and lens.sum() == len(tp.stack)
    run, a_cell, b_cell = band_run_cells(pt)
    assert run[empty].any(axis=1).all()  # the kernel does walk cells there
    assert not ((a_cell[empty] >= 0) & (b_cell[empty] >= 0)).any()
    pairs, skipped = band_job_walk(pt)
    assert all(not pairs[i] and all(skipped[i]) for i in empty)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = band_matmul_plain(at, bt, pt)
    assert not got[empty].any()
    sums = run_sums_plain(at, bt, c_ptr, torch.from_numpy(ai), torch.from_numpy(bi),
                          torch.float32)
    assert not sums[empty].any() and rel_err(sums, got) <= RTOL
