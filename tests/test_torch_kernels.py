"""Port parity, K1 (the flat stack kernel): the port's plain version — what
``tile_stack_matmul`` runs for CPU tensors — against the JAX package's
Pallas kernel in interpret mode and its XLA twin, on the same numpy stores
and stacks; plus the tile stack plan, array for array.

Tolerances (relative to the largest reference entry):
- float64: 1e-12 — both sides sum the same float64 products, in another
  order;
- float32 (precision "highest") and bf16 inputs with float32 output: 1e-5 —
  products are exact or IEEE float32 on both sides and the sums run in
  another order (per-run sequential here, the kernel's dot order there)
  over at most 40·T terms.
"""
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbcsr_tpu.core.config import config_override as jax_override
from dbcsr_tpu.mm.kernels import (
    _HAVE_PALLAS,
    tile_stack_matmul_pallas,
    tile_stack_matmul_xla,
)
from dbcsr_tpu.mm.tileplan import plan_tile_stacks_stores as jax_plan

from dbcsr_tpu_torch.core.config import config_override as torch_override
from dbcsr_tpu_torch.mm.kernels import (
    device_stack,
    tile_stack_matmul,
    tile_stack_matmul_plain,
)
from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores as torch_plan

torch.set_num_threads(1)

T = 8
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def stack_case(rng, kind, n_tiles=12):
    """c-sorted stacks: runs of random length, all runs of length 1, or a
    few long runs."""
    if kind == "random":
        n_c, s = 9, 60
        c = np.sort(rng.integers(0, n_c, s))
        c[:n_c] = np.arange(n_c)
        c = np.sort(c)
    elif kind == "singles":
        n_c = s = 40
        c = np.arange(n_c)
    else:  # long runs
        n_c, run = 3, 40
        c = np.repeat(np.arange(n_c), run)
        s = len(c)
    stack = np.stack(
        [c, rng.integers(0, n_tiles, s), rng.integers(0, n_tiles, s)], axis=1
    ).astype(np.int32)
    return stack, n_c


def stores(rng, dtype, n_tiles=12):
    a = rng.standard_normal((n_tiles, T, T)).astype(dtype)
    b = rng.standard_normal((n_tiles, T, T)).astype(dtype)
    return a, b


@pytest.mark.parametrize("kind", ["random", "singles", "long"])
def test_f64_matches_xla_twin(rng, kind):
    stack, n_c = stack_case(rng, kind)
    a, b = stores(rng, np.float64)
    ref = tile_stack_matmul_xla(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack), n_c_tiles=n_c,
        precision="highest",
    )
    got = tile_stack_matmul(
        torch.from_numpy(a), torch.from_numpy(b), device_stack(stack, n_c, "cpu")
    )
    assert got.dtype == torch.float64
    assert rel_err(got, ref) <= RTOL[np.float64]


@pytest.mark.skipif(not _HAVE_PALLAS, reason="no pallas")
@pytest.mark.parametrize("kind", ["random", "singles", "long"])
def test_f32_matches_pallas_interpret_and_xla(rng, kind):
    stack, n_c = stack_case(rng, kind)
    a, b = stores(rng, np.float32)
    got = tile_stack_matmul(
        torch.from_numpy(a), torch.from_numpy(b), device_stack(stack, n_c, "cpu")
    )
    pallas = tile_stack_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), stack, n_c_tiles=n_c, interpret=True,
        precision="highest",
    )
    xla = tile_stack_matmul_xla(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(stack), n_c_tiles=n_c,
        precision="highest",
    )
    assert got.dtype == torch.float32
    assert rel_err(got, pallas) <= RTOL[np.float32]
    assert rel_err(got, xla) <= RTOL[np.float32]


@pytest.mark.skipif(not _HAVE_PALLAS, reason="no pallas")
def test_bf16_inputs_f32_output_match_pallas_interpret(rng):
    stack, n_c = stack_case(rng, "random")
    a, b = stores(rng, np.float32)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    b16 = torch.from_numpy(b).to(torch.bfloat16)
    got = tile_stack_matmul(a16, b16, device_stack(stack, n_c, "cpu"),
                            out_dtype=torch.float32)
    ref = tile_stack_matmul_pallas(
        jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
        stack, n_c_tiles=n_c, interpret=True, out_dtype=jnp.float32,
    )
    assert got.dtype == torch.float32
    assert rel_err(got, ref) <= RTOL[np.float32]
    # default output dtype follows the inputs
    assert tile_stack_matmul(a16, b16, device_stack(stack, n_c, "cpu")).dtype == torch.bfloat16


def test_plain_is_deterministic_and_run_ordered(rng):
    stack, n_c = stack_case(rng, "long")
    a, b = stores(rng, np.float32)
    ds = device_stack(stack, n_c, "cpu")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    one = tile_stack_matmul_plain(at, bt, ds)
    assert torch.equal(one, tile_stack_matmul_plain(at, bt, ds))
    # each run is summed left to right in stack order
    prods = torch.bmm(at[stack[:, 1]], bt[stack[:, 2]])
    for c in range(n_c):
        acc = torch.zeros(T, T)
        for e in np.flatnonzero(stack[:, 0] == c):
            acc = acc + prods[e]
        assert torch.equal(one[c], acc)


def test_plain_chunking_does_not_change_results(rng, monkeypatch):
    from dbcsr_tpu_torch.mm import kernels

    stack, n_c = stack_case(rng, "random")
    a, b = stores(rng, np.float64)
    ds = device_stack(stack, n_c, "cpu")
    whole = tile_stack_matmul_plain(torch.from_numpy(a), torch.from_numpy(b), ds)
    monkeypatch.setattr(kernels, "PLAIN_CHUNK", 5)
    chunked = tile_stack_matmul_plain(torch.from_numpy(a), torch.from_numpy(b), ds)
    assert torch.equal(whole, chunked)


def test_device_stack_validates():
    good = np.array([[0, 0, 0], [1, 1, 1]], np.int32)
    ds = device_stack(good, 2, "cpu")
    assert ds.c_ptr.tolist() == [0, 1, 2] and (ds.a_end, ds.b_end) == (2, 2)
    with pytest.raises(ValueError):
        device_stack(good[::-1], 2, "cpu")  # not sorted by c
    with pytest.raises(ValueError):
        device_stack(good, 1, "cpu")  # c beyond n_c_tiles
    empty = device_stack(np.zeros((0, 3), np.int32), 3, "cpu")
    out = tile_stack_matmul(torch.ones(1, T, T), torch.ones(1, T, T), empty)
    assert out.shape == (3, T, T) and not out.any()


def _coords(rng, nr, nc, occ):
    m = rng.random((nr, nc)) < occ
    r, c = np.nonzero(m)
    return np.stack([r, c], axis=1).astype(np.int32)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("occ", [0.15, 0.6])
def test_tile_plan_matches(rng, native, occ):
    mt, kt, nt = 9, 11, 7
    a_coords = _coords(rng, mt, kt, occ)
    b_coords = _coords(rng, kt, nt, occ)
    with ExitStack() as es:
        es.enter_context(jax_override(use_native_planner=native))
        es.enter_context(torch_override(use_native_planner=native))
        pj = jax_plan(a_coords, (mt, kt), b_coords, (kt, nt))
        pt = torch_plan(a_coords, (mt, kt), b_coords, (kt, nt))
    np.testing.assert_array_equal(pj.stack, pt.stack)
    np.testing.assert_array_equal(pj.c_tile_keys, pt.c_tile_keys)
    assert pj.n_c_tiles == pt.n_c_tiles and pj.tile_grid == pt.tile_grid
