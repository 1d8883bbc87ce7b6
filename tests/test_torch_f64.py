"""Port parity, the float64 stack product (the port of K6): the port's
plain version — what ``tile_stack_matmul_f64`` runs for CPU tensors —
against the JAX package's float64 routes on the same numpy stores and
stacks, and the float64 route of ``multiply`` as a whole.

Tolerances:
- against native float64 (``tile_stack_matmul_xla`` in float64, or the
  JAX multiply with ``f64_method="native"``): 1e-12 relative to the largest
  reference entry — both sum the same float64 products in another order;
- against the bf16-slice emulations (the default ``f64_method="auto"``
  route on the CPU, ``ops/f64_emu``, and K6 itself in interpret mode): the
  bound pinned in ``tests/test_ozaki_panel.py``, |error| <= 1e-13 ·
  max|A row| · max|B col| · K per C element (K = run length · T), taken
  here over the entries of each C tile's own run.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dbcsr_tpu as djax
from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.mm.kernels import tile_stack_matmul_xla
from dbcsr_tpu.mm.ozaki_panel import (
    MAX_ENTRIES_PER_SLOT,
    plan_ozaki_panel,
    tile_stack_matmul_ozaki_panel,
)
from dbcsr_tpu.ops.f64_emu import tile_stack_matmul_ozaki

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.mm.f64_stack import (
    tile_stack_matmul_f64,
    tile_stack_matmul_f64_plain,
)
from dbcsr_tpu_torch.mm.kernels import device_stack
from dbcsr_tpu_torch.testing import matrix_from_arrays

torch.set_num_threads(1)

RTOL = 1e-12
OZAKI_BOUND = 1e-13


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def stack_case(rng, kind, n_tiles=10):
    """c-sorted stacks: runs of random length with empty runs between,
    all runs of length 1, or runs of 12 (beyond K6's 8 entries per slot)."""
    if kind == "empty_runs":
        n_c = 12
        c = np.sort(rng.choice([0, 2, 3, 7, 8, 11], 30))  # C tiles 1, 4-6, 9, 10 empty
    elif kind == "singles":
        n_c = 16
        c = np.arange(n_c)
    else:  # long runs
        n_c = 3
        c = np.repeat(np.arange(n_c), MAX_ENTRIES_PER_SLOT + 4)
    stack = np.stack(
        [c, rng.integers(0, n_tiles, len(c)), rng.integers(0, n_tiles, len(c))], axis=1
    ).astype(np.int32)
    return stack, n_c


def stores(rng, tile, n_tiles=10):
    return (rng.standard_normal((n_tiles, tile, tile)),
            rng.standard_normal((n_tiles, tile, tile)))


def ozaki_bound(a, b, stack, n_c, tile):
    """Per C element: max|A row| · max|B col| · K over the run's entries."""
    rowmax = np.zeros((n_c, tile))
    colmax = np.zeros((n_c, tile))
    k = np.zeros(n_c)
    for c, ia, ib in stack:
        rowmax[c] = np.maximum(rowmax[c], np.abs(a[ia]).max(axis=1))
        colmax[c] = np.maximum(colmax[c], np.abs(b[ib]).max(axis=0))
        k[c] += tile
    return rowmax[:, :, None] * colmax[:, None, :] * k[:, None, None]


def port(a, b, stack, n_c):
    return tile_stack_matmul_f64(
        torch.from_numpy(a), torch.from_numpy(b), device_stack(stack, n_c, "cpu")
    ).numpy()


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["empty_runs", "singles", "long"])
def test_matches_native_f64_twin(kind, tile):
    rng = np.random.default_rng(tile)
    stack, n_c = stack_case(rng, kind)
    a, b = stores(rng, tile)
    ref = np.asarray(tile_stack_matmul_xla(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack), n_c_tiles=n_c,
        precision="highest",
    ))
    got = port(a, b, stack, n_c)
    assert got.dtype == np.float64 and got.shape == ref.shape
    assert rel_err(got, ref) <= RTOL
    if kind == "empty_runs":
        empty = np.setdiff1d(np.arange(n_c), stack[:, 0])
        assert len(empty) and not got[empty].any()


@pytest.mark.parametrize("kind", ["empty_runs", "singles", "long"])
def test_matches_ozaki_twin(kind):
    """The JAX package's default float64 stack route on the CPU (8 × 7-bit
    bf16 slices, ``ops/f64_emu.py:194``), long runs included."""
    rng = np.random.default_rng(7)
    tile = 32
    stack, n_c = stack_case(rng, kind)
    a, b = stores(rng, tile)
    ref = np.asarray(tile_stack_matmul_ozaki(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack), n_c_tiles=n_c,
    ))
    got = port(a, b, stack, n_c)
    bound = ozaki_bound(a, b, stack, n_c, tile)
    assert np.all(np.abs(got - ref) <= OZAKI_BOUND * bound)


def test_matches_k6_interpret():
    """K6 itself (interpret mode) on a small admissible case: T = 128, a
    banded 3×3 tile grid, at most 3 entries per C slot."""
    rng = np.random.default_rng(11)
    tile, nt = 128, 3
    coords = [(i, k) for i in range(nt) for k in range(nt) if abs(i - k) <= 1]
    slot = {c: s for s, c in enumerate(coords)}
    c_keys = sorted({(i, j) for (i, k) in coords for (k2, j) in coords if k2 == k})
    c_slot = {c: s for s, c in enumerate(c_keys)}
    stack = np.array(sorted(
        (c_slot[(i, j)], slot[(i, k)], slot[(k, j)])
        for (i, k) in coords for (k2, j) in coords if k2 == k
    ), dtype=np.int32)
    n_c = len(c_keys)
    assert np.bincount(stack[:, 0]).max() <= MAX_ENTRIES_PER_SLOT
    a, b = stores(rng, tile, len(coords))
    co = np.array(coords)
    assert plan_ozaki_panel(stack, n_c, len(coords), len(coords)) is not None
    ref = np.asarray(tile_stack_matmul_ozaki_panel(
        jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=n_c,
        a_rows=co[:, 0], b_cols=co[:, 1], c_coords=np.array(c_keys),
        interpret=True,
    ))
    got = port(a, b, stack, n_c)
    # K6 scales by GLOBAL row/column maxima (its documented model)
    rowmax = np.zeros((nt, tile))
    colmax = np.zeros((nt, tile))
    for s_, (r, c) in enumerate(coords):
        rowmax[r] = np.maximum(rowmax[r], np.abs(a[s_]).max(axis=1))
        colmax[c] = np.maximum(colmax[c], np.abs(b[s_]).max(axis=0))
    cc = np.array(c_keys)
    k = np.bincount(stack[:, 0], minlength=n_c) * tile
    bound = rowmax[cc[:, 0]][:, :, None] * colmax[cc[:, 1]][:, None, :] * k[:, None, None]
    assert np.all(np.abs(got - ref) <= OZAKI_BOUND * bound)


def test_plain_and_wrapper_checks():
    rng = np.random.default_rng(3)
    stack, n_c = stack_case(rng, "singles")
    a, b = stores(rng, 16)
    ds = device_stack(stack, n_c, "cpu")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(tile_stack_matmul_f64(at, bt, ds),
                       tile_stack_matmul_f64_plain(at, bt, ds))
    with pytest.raises(TypeError):
        tile_stack_matmul_f64_plain(at.float(), bt.float(), ds)
    with pytest.raises(ValueError):
        tile_stack_matmul_f64(at, bt[:, :8, :8], ds)


def matrix_pair(seed, tile, *, n=800, band=2, occ=0.6):
    """The same float64 matrix in both packages: a banded block pattern
    (sparse at every tile edge) built in the JAX package from a seed and
    carried into the port by ``matrix_from_arrays``."""
    rng = np.random.default_rng(seed)
    rbs = djax.random_block_sizes(n, [3, 5, 7], np.random.default_rng(0))
    nb = len(rbs)
    i = np.repeat(np.arange(nb), 2 * band + 1)
    j = i + np.tile(np.arange(-band, band + 1), nb)
    keep = (j >= 0) & (j < nb) & (rng.random(len(j)) < occ)
    blocks = [rng.standard_normal((rbs[r], rbs[c])) for r, c in zip(i[keep], j[keep])]
    with jax_override(tile_size=tile):
        mj = djax.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs,
                                         dtype=np.float64)
    mt = matrix_from_arrays(rbs, rbs, mj.index.blk_rows, mj.index.col_idx,
                            np.asarray(mj.data), device="cpu", sym=mj.sym)
    return mj, mt


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
@pytest.mark.parametrize("driver", ["auto", "stack", "panel"])
def test_multiply_f64_route(driver, tile):
    """Every sparse float64 product takes the float64 stack route, under
    every sparse driver, and matches the JAX package's native float64
    multiply (1e-12) and its default route (the slice emulation), for every
    transpose pair, with alpha/beta and an existing C."""
    aj, at = matrix_pair(1, tile)
    bj, bt = matrix_pair(2, tile)
    cj, ct = matrix_pair(3, tile)
    with torch_override(tile_size=tile, mm_driver=driver):
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, bt)
        assert fn.plan.route == "f64_stack" and fn.plan.in_dtype == torch.float64
        for (ta, tb), use_c in zip((("N", "N"), ("T", "N"), ("N", "T"), ("C", "T")),
                                   (False, True, False, True)):
            alpha, beta = (0.5, -2.0) if use_c else (1.0, 0.0)
            rt = dtt.multiply(ta, tb, alpha, at, bt, beta, ct if use_c else None)
            for method, tol in (("native", RTOL), ("auto", 1e-13)):
                with jax_override(tile_size=tile, f64_method=method):
                    rj = djax.multiply(ta, tb, alpha, aj, bj, beta,
                                       cj if use_c else None)
                np.testing.assert_array_equal(rj.index.col_idx, rt.index.col_idx)
                np.testing.assert_array_equal(rj.index.row_ptr, rt.index.row_ptr)
                assert rel_err(rt.to_dense().numpy(), np.asarray(rj.to_dense())) <= tol


@pytest.mark.parametrize("method", ["auto", "native", "ozaki"])
def test_f64_method_is_accepted_and_dense_stays_torch(method):
    """Every f64_method value runs native float64; the dense class is a
    float64 matmul, not the stack kernel."""
    aj, at = matrix_pair(4, 16, n=60, band=12, occ=0.9)
    with torch_override(tile_size=16, f64_method=method):
        fn, _, _ = dtt.build_multiply_executor("N", "N", at, at)
        rt = dtt.multiply("N", "N", 1.0, at, at)
    assert fn.plan.route == "dense"
    with jax_override(tile_size=16, f64_method="native"):
        rj = djax.multiply("N", "N", 1.0, aj, aj)
    assert rel_err(rt.to_dense().numpy(), np.asarray(rj.to_dense())) <= RTOL
    with torch_override(tile_size=16, f64_method="nonsense"):
        with pytest.raises(dtt.DbcsrError, match="f64_method"):
            dtt.multiply("N", "N", 1.0, at, at)
