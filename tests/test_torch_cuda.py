"""The port's kernels on the card: K1 and K2 against their plain versions,
the executors' routes, and the wrappers' refusals.

Every test needs a CUDA GPU and skips without one. This file imports no
jax (the GPU machine has none), so run it there without the suite's
conftest, which imports jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance 1e-5 relative to the largest reference entry: kernel and plain
version both accumulate in float32 (bf16 inputs are widened, so products
are exact), in different orders, over at most 40·T terms.
"""
import numpy as np
import pytest
import torch

import dbcsr_tpu_torch as dtt
from dbcsr_tpu_torch.core.config import config_override
from dbcsr_tpu_torch.mm.kernels import (
    device_stack,
    tile_stack_matmul,
    tile_stack_matmul_plain,
)
from dbcsr_tpu_torch.mm.panel import (
    device_panel_plan,
    plan_panel_stack,
    tile_stack_matmul_panel,
    tile_stack_matmul_panel_plain,
)

RTOL = 1e-5
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    # decided at run time, never at import (every xdist worker collects the
    # same tests)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dtt.init_lib()
    return torch.device("cuda", 0)


def rel_err(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def random_stack(rng, n_c=9, s=60, n_tiles=12):
    c = np.sort(np.concatenate([np.arange(n_c), rng.integers(0, n_c, s - n_c)]))
    return np.stack(
        [c, rng.integers(0, n_tiles, s), rng.integers(0, n_tiles, s)], axis=1
    ).astype(np.int32), n_c


def banded_stack(mt=24, w=2):
    coords = [(r, c) for r in range(mt) for c in range(mt) if abs(r - c) <= w]
    slot = {rc: i for i, rc in enumerate(coords)}
    trip = sorted(
        (slot[(r, c)], sa, slot[(k, c)])
        for (r, k), sa in slot.items()
        for c in range(max(0, k - w, r - w), min(mt, k + w + 1, r + w + 1))
    )
    return np.asarray(trip, dtype=np.int32), len(coords)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k1_matches_plain(dev, tile, dtype):
    stack, n_c = random_stack(np.random.default_rng(tile))
    ds = device_stack(stack, n_c, dev)
    a = torch.randn(12, tile, tile, device=dev).to(dtype)
    b = torch.randn(12, tile, tile, device=dev).to(dtype)
    got = tile_stack_matmul(a, b, ds, out_dtype=torch.float32)
    ref = tile_stack_matmul_plain(a, b, ds, out_dtype=torch.float32)
    assert rel_err(got, ref) <= RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k2_matches_plain_and_k1_bitwise(dev, tile, dtype):
    stack, n = banded_stack()
    plan = plan_panel_stack(stack, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    assert plan.gstart[-1] % 16  # clamped last group
    a = torch.randn(n, tile, tile, device=dev).to(dtype)
    b = torch.randn(n, tile, tile, device=dev).to(dtype)
    got = tile_stack_matmul_panel(a, b, device_panel_plan(plan, dev),
                                  out_dtype=torch.float32)
    ref = tile_stack_matmul_panel_plain(a, b, plan, out_dtype=torch.float32)
    assert rel_err(got, ref) <= RTOL
    flat = tile_stack_matmul(a, b, device_stack(stack, n, dev), out_dtype=torch.float32)
    assert torch.equal(got, flat)


def test_wrappers_reject_bad_input(dev):
    stack, n_c = random_stack(np.random.default_rng(0))
    ds = device_stack(stack, n_c, dev)
    a = torch.randn(12, 32, 32, device=dev)
    with pytest.raises(NotImplementedError, match="K6"):
        tile_stack_matmul(a.double(), a.double(), ds)
    with pytest.raises(TypeError):
        tile_stack_matmul(a.half(), a.half(), ds)
    a8 = torch.randn(12, 8, 8, device=dev)
    with pytest.raises(ValueError):
        tile_stack_matmul(a8, a8, ds)
    with pytest.raises(ValueError):
        tile_stack_matmul(a.transpose(1, 2), a, ds)  # not contiguous
    with pytest.raises(IndexError):
        tile_stack_matmul(a[:2], a[:2], ds)  # stack slots beyond the stores
    stack2, n = banded_stack()
    plan = plan_panel_stack(stack2, n, n, n, c_win=16, a_cap=48, b_cap=48, chunk=4)
    with pytest.raises(NotImplementedError, match="K6"):
        tile_stack_matmul_panel(a.double(), a.double(), device_panel_plan(plan, dev))


def test_executors_on_the_card(dev):
    """auto takes K2 on a banded pattern, stack takes K1; both match the
    same multiply on CPU tensors; float64 stacks raise naming K6."""
    rng = np.random.default_rng(1)
    rbs = dtt.random_block_sizes(300, [3, 5, 7], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n), 7)
    j = i + np.tile(np.arange(-3, 4), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.6)
    blocks = [rng.standard_normal((rbs[r], rbs[c])).astype(np.float32)
              for r, c in zip(i[keep], j[keep])]
    with config_override(tile_size=16, matmul_precision="highest"):
        a = dtt.BCSRMatrix.from_blocks(i[keep], j[keep], blocks, rbs, rbs, device="cpu")
        ag = a.with_data(a.data.to(dev))
        ref = dtt.multiply("N", "N", 1.0, a, a).to_dense()
        for driver, counter in (("auto", tile_stack_matmul_panel),
                                ("stack", tile_stack_matmul)):
            with config_override(mm_driver=driver):
                fn, _, _ = dtt.build_multiply_executor("N", "N", ag, ag)
                assert fn.plan.route == {"auto": "panel", "stack": "stack"}[driver]
                before = counter.launches
                out = dtt.multiply("N", "N", 1.0, ag, ag)
                assert counter.launches == before + 1
            assert rel_err(out.to_dense(), ref) <= RTOL
        a64 = ag.astype(torch.float64)
        with config_override(mm_driver="stack"):
            with pytest.raises(NotImplementedError, match="K6"):
                dtt.multiply("N", "N", 1.0, a64, a64)
