"""Parity harness and the built-in self-test API.

Parity harness: carry a JAX-package matrix or tensor into the port.
A test builds a matrix in ``dbcsr_tpu``, hands its parts over as numpy
arrays (``np.asarray(m.data)``, the index arrays, ``m.sym``) and gets the
port's ``BCSRMatrix`` with the same index, symmetry and a bit-identical
tile store — float64 stays float64 — so one numpy description reaches both
packages; results are then compared as numpy arrays. A tensor crosses the
same way, as its nd block sizes, its mapping and its folded matrix's block
coordinates and flat data (``tensor_from_arrays``). A distribution
crosses as its ``row_dist``/``col_dist`` vectors and the grid's shape
(``distribution_from_arrays``, over the caller's rank devices), a sharded
matrix as its index arrays and per-rank numpy shards
(``sharded_from_arrays``). This module does not import jax: the caller
does the ``np.asarray``.

Self-tests (port of ``dbcsr_tpu/testing.py``, the reference's
``dbcsr_run_tests`` / ``dbcsr_test_mm`` / ``dbcsr_test_binary_io``,
``src/ops/dbcsr_tests.F:62``): an embedding application checks the
installed library on its own device without the pytest suite. The oracle
is the reference's (``tests/dbcsr_test_multiply.F:523-700``): operands to
dense on the host, ``multiply`` against a dense GEMM with norm-scaled
residuals; ``test_dist`` runs Cannon, SUMMA, 2.5D and the sharded
executor over a grid of virtual ranks on the device against the same
oracle. ``validate_kernels`` holds every CUDA kernel family against its
plain PyTorch version on a CUDA device (on a CPU device the plain version
is the route, so there is nothing to hold). The JAX package's TPU lowering
and compile gates have no counterpart here: nvcc builds the kernels
(``run_tests`` builds them first on a CUDA device), and a failure raises.
"""
from __future__ import annotations

import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .block.bcsr import BCSRMatrix, SYM_NONE, _host_dtype, default_tile, torch_dtype
from .block.index import build_index
from .block.store import store_layout
from .core.errors import dbcsr_assert

__all__ = [
    "matrix_from_arrays",
    "tensor_from_arrays",
    "distribution_from_arrays",
    "sharded_from_arrays",
    "to_numpy",
    "to_dense_local",
    "impose_sparsity",
    "check_multiply",
    "test_mm",
    "test_binary_io",
    "test_tas",
    "test_tensor",
    "test_dist",
    "validate_kernels",
    "run_tests",
]


def matrix_from_arrays(
    row_block_sizes, col_block_sizes, rows, cols, data_np, *, device,
    name: str = "matrix", sym: str = SYM_NONE,
) -> BCSRMatrix:
    """The port's matrix with block sizes, block coordinates ``rows`` /
    ``cols`` (in the JAX matrix's canonical order: ``index.blk_rows``,
    ``index.col_idx``), tile store ``data_np`` [n_tiles, T, T] in its own
    dtype, and symmetry ``sym`` (symmetric storage holds the upper block
    triangle only, as the JAX package's builder requires)."""
    data_np = np.asarray(data_np)
    dbcsr_assert(data_np.ndim == 3, "data must be a [n_tiles, T, T] store")
    index, order = build_index(rows, cols, row_block_sizes, col_block_sizes)
    dbcsr_assert(
        np.array_equal(order, np.arange(len(order))),
        "block coordinates must be in canonical (row, col) order",
    )
    dbcsr_assert(
        sym == SYM_NONE or bool(np.all(index.blk_rows <= index.col_idx)),
        f"symmetric storage (sym={sym!r}) holds only blocks with row <= col",
    )
    lay = store_layout(index, int(data_np.shape[1]))
    dbcsr_assert(
        lay.n_tiles == data_np.shape[0],
        f"store has {data_np.shape[0]} tiles, the index needs {lay.n_tiles}",
    )
    return BCSRMatrix(
        name=name, index=index, sym=sym,
        data=torch.tensor(data_np, device=device),  # a copy: JAX arrays are read-only
    )


def tensor_from_arrays(
    block_sizes, map1, map2, rows, cols, flat, *, dtype, device, tile=None,
    name: str = "tensor",
):
    """The port's ``Tensor`` with nd ``block_sizes``, the mapping
    ``NDMapping(ndim, map1, map2)``, and a folded matrix whose block
    coordinates are ``rows`` / ``cols`` (the JAX tensor's
    ``matrix.index.blk_rows`` / ``col_idx``, canonical order) and whose flat
    block data is ``flat`` (its ``matrix.flat_host()``), in ``dtype`` with
    its tile store of edge ``tile`` on ``device``."""
    from .tensors.index import NDMapping, grouped_block_sizes
    from .tensors.tensor import Tensor

    bs = tuple(np.asarray(b, dtype=np.int32) for b in block_sizes)
    mapping = NDMapping(len(bs), tuple(map1), tuple(map2))
    rbs = grouped_block_sizes(list(bs), list(mapping.map1))
    cbs = grouped_block_sizes(list(bs), list(mapping.map2))
    index, _ = build_index(rows, cols, rbs, cbs)
    tdt = torch_dtype(dtype)
    store = store_layout(index, tile or default_tile()).store_from_flat(
        np.asarray(flat, dtype=_host_dtype(tdt)).reshape(-1)
    )
    m = matrix_from_arrays(rbs, cbs, rows, cols, store, device=device, name=name)
    return Tensor(name=name, block_sizes=bs, mapping=mapping, matrix=m.astype(tdt))


def distribution_from_arrays(row_dist, col_dist, grid_shape: Sequence[int], *,
                             devices):
    """The port's ``Distribution`` with the JAX one's ``row_dist`` /
    ``col_dist`` vectors over a grid of ``grid_shape`` (``(nprow, npcol)``
    or ``(nprow, npcol, nlayer)``, the JAX mesh's shape) whose ranks sit on
    ``devices`` (e.g. ``[torch.device("cpu")] * 8``)."""
    from .dist.distribution import Distribution
    from .dist.grid import ProcessGrid

    grid = ProcessGrid.make(*grid_shape, devices=devices)
    return Distribution(grid=grid, row_dist=np.asarray(row_dist, dtype=np.int32),
                        col_dist=np.asarray(col_dist, dtype=np.int32))


def sharded_from_arrays(row_block_sizes, col_block_sizes, rows, cols, shards_np,
                        dist, *, name: str = "matrix", sym: str = SYM_NONE):
    """The port's ``ShardedMatrix`` with the block index of ``rows`` /
    ``cols`` (canonical order) and per-rank numpy shards ``shards_np``
    ([ndev, n_max, T, T], the JAX sharded array as numpy), over the port's
    ``dist``; each shard lands on its rank's device. The shard layout must
    match the shards' shape."""
    from .dist.sharded import plane_devices, shard_layout
    from .dist.sharded_ops import ShardedMatrix

    shards_np = np.asarray(shards_np)
    index, order = build_index(rows, cols, row_block_sizes, col_block_sizes)
    dbcsr_assert(np.array_equal(order, np.arange(len(order))),
                 "block coordinates must be in canonical (row, col) order")
    tile = int(shards_np.shape[-1])
    sl = shard_layout(index, tile, dist)
    dbcsr_assert(shards_np.shape[:2] == (sl.ndev, sl.n_max), "shard layout mismatch")
    data = [torch.tensor(shards_np[d], device=dev)
            for d, dev in enumerate(plane_devices(dist.grid))]
    return ShardedMatrix(name=name, index=index, tile=tile, dist=dist, shard=sl,
                         data=data, sym=sym)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16 widened to float32)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


# ---------------------------------------------------------------------------
# built-in self-tests
# ---------------------------------------------------------------------------

def _kernel_validation_cases(device, tile: int, n_tiles: int, seed: int):
    """One case per CUDA kernel family: ``[(name, tolerance, run_kernel,
    run_plain), ...]`` thunks on small stacks and plans that reach each
    kernel's paths (revisited C tiles, a clamped panel group, all three
    run-fused tiers)."""
    from .mm.band import band_matmul, band_matmul_plain, device_band_plan, plan_band
    from .mm.c_stack import (
        tile_stack_matmul_c64,
        tile_stack_matmul_c128,
        tile_stack_matmul_c_plain,
    )
    from .mm.f64_stack import tile_stack_matmul_f64, tile_stack_matmul_f64_plain
    from .mm.kernels import (
        device_group_plan,
        device_stack,
        tile_stack_matmul,
        tile_stack_matmul_grouped,
        tile_stack_matmul_grouped_plain,
        tile_stack_matmul_plain,
    )
    from .mm.panel import (
        device_panel_plan,
        device_panel_run_plan,
        plan_panel_runs,
        plan_panel_stack,
        tile_stack_matmul_panel,
        tile_stack_matmul_panel_plain,
        tile_stack_matmul_panel_runs,
        tile_stack_matmul_panel_runs_plain,
    )
    from .mm.tileplan import plan_tile_stacks_stores

    f32 = torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def stores(n, dtype=f32):
        wide = dtype if dtype in (torch.float64, torch.complex64, torch.complex128) else f32
        return [torch.randn((n, tile, tile), generator=gen, device=device,
                            dtype=wide).to(dtype) for _ in range(2)]

    cases = []
    # flat stack with revisited C tiles (K1, K4 and the float64 kernel)
    dbcsr_assert(n_tiles >= 4, "validate_kernels needs n_tiles >= 4")
    stack = np.array([[0, 0, 0], [0, 1, 1], [1, 2, 2], [2, 0, 3], [2, 3, 0]],
                     dtype=np.int32)
    a, b = stores(n_tiles)
    ds = device_stack(stack, 3, device)
    cases.append(("flat (K1)", 1e-4,
                  lambda: tile_stack_matmul(a, b, ds, out_dtype=f32),
                  lambda: tile_stack_matmul_plain(a, b, ds, out_dtype=f32)))
    gp = device_group_plan(stack, 3, n_tiles, device, group=2, cache=4)
    cases.append(("grouped (K4)", 1e-4,
                  lambda: tile_stack_matmul_grouped(a, b, gp, out_dtype=f32),
                  lambda: tile_stack_matmul_grouped_plain(a, b, gp, out_dtype=f32)))
    a64, b64 = stores(n_tiles, torch.float64)
    cases.append(("float64 stack", 1e-12,
                  lambda: tile_stack_matmul_f64(a64, b64, ds),
                  lambda: tile_stack_matmul_f64_plain(a64, b64, ds)))

    # a square band of tiles, |r - c| <= w (K5, K2, K3)
    mt, w = 12, 2
    r, c = np.meshgrid(np.arange(mt), np.arange(mt), indexing="ij")
    near = np.abs(r - c) <= w
    coords = np.stack([r[near], c[near]], 1).astype(np.int64)
    n = len(coords)
    tp = plan_tile_stacks_stores(coords, (mt, mt), coords, (mt, mt))
    ab, bb = stores(n)
    bp = plan_band(coords, (mt, mt), coords, (mt, mt), tp.c_tile_keys, tile=tile)
    dbp = device_band_plan(bp, device)
    cases.append(("band (K5)", 1e-4,
                  lambda: band_matmul(ab, bb, dbp, out_dtype=f32),
                  lambda: band_matmul_plain(ab, bb, bp, out_dtype=f32)))
    pp = plan_panel_stack(tp.stack, tp.n_c_tiles, n, n, c_win=16, a_cap=48,
                          b_cap=48, chunk=4)
    dbcsr_assert(pp is not None and pp.gstart[-1] % 16 != 0,
                 "validate_kernels: the panel plan must clamp its last group")
    dpp = device_panel_plan(pp, device)
    cases.append(("panel (K2)", 1e-4,
                  lambda: tile_stack_matmul_panel(ab, bb, dpp, out_dtype=f32),
                  lambda: tile_stack_matmul_panel_plain(ab, bb, pp, out_dtype=f32)))
    a16, b16 = ab.to(torch.bfloat16), bb.to(torch.bfloat16)
    cases.append(("panel-bf16 (K2)", 2e-2,
                  lambda: tile_stack_matmul_panel(a16, b16, dpp, out_dtype=f32),
                  lambda: tile_stack_matmul_panel_plain(a16, b16, pp, out_dtype=f32)))
    cm = np.argsort(coords[:, 1] * mt + coords[:, 0]).astype(np.int32)
    rp = plan_panel_runs(tp.stack, tp.n_c_tiles, n, n, b_cm_perm=cm, c_win=8,
                         a_cap=32, b_cap=32, chunk=4, runlen=3)
    dbcsr_assert(rp is not None and rp.n_quads > 0 and rp.n_pairs > 0,
                 "validate_kernels: the run-fused plan must use its tiers")
    drp = device_panel_run_plan(rp, device)
    cases.append(("panel-runs (K3)", 1e-4,
                  lambda: tile_stack_matmul_panel_runs(ab, bb, drp, out_dtype=f32),
                  lambda: tile_stack_matmul_panel_runs_plain(ab, bb, rp, out_dtype=f32)))
    # the complex flat stacks (KC1, KC2) on the flat stack above
    c64a, c64b = stores(n_tiles, torch.complex64)
    cases.append(("complex64 stack (KC1)", 1e-4,
                  lambda: tile_stack_matmul_c64(c64a, c64b, ds),
                  lambda: tile_stack_matmul_c_plain(c64a, c64b, ds)))
    c128a, c128b = stores(n_tiles, torch.complex128)
    cases.append(("complex128 stack (KC2)", 1e-12,
                  lambda: tile_stack_matmul_c128(c128a, c128b, ds),
                  lambda: tile_stack_matmul_c_plain(c128a, c128b, ds)))
    return cases


def validate_kernels(device, *, tile: int = 128, n_tiles: int = 4, seed: int = 0,
                     verbose: bool = False) -> bool:
    """Numeric self-validation of every CUDA kernel family (K1-K5, the
    float64 stack kernel, K2 with bf16 inputs, the complex stack kernels
    KC1 and KC2: nine) against its plain PyTorch version on ``device`` (the
    reference validates every JIT kernel at first use, ``validate_kernel``,
    ``src/acc/libsmm_acc/libsmm_acc.cpp:55-89``). On a CPU device the plain version is the route, and it returns True.

    Tolerances, relative to the largest plain entry: bf16 inputs 2e-2,
    float32 and complex64 1e-4, float64 and complex128 1e-12."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    all_ok = True
    for name, tol, run_kernel, run_plain in _kernel_validation_cases(
        device, tile, n_tiles, seed
    ):
        got, ref = run_kernel(), run_plain()
        wide = torch.complex128 if ref.is_complex() else torch.float64
        got, ref = got.to(wide), ref.to(wide)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max()) or 1.0
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        if verbose or not ok:
            print(f"validate_kernels[{name}]: max err {err:.3e} "
                  f"(scale {scale:.3e}) {'OK' if ok else 'FAILED'}")
        all_ok = all_ok and ok
    return all_ok


def to_dense_local(m: BCSRMatrix) -> np.ndarray:
    """Dense copy on the host (``dbcsr_to_dense_local``,
    ``src/ops/dbcsr_test_methods.F:213``)."""
    return to_numpy(m.to_dense())


def impose_sparsity(dense: np.ndarray, like: BCSRMatrix) -> np.ndarray:
    """Zero ``dense`` outside the block pattern of ``like``
    (``dbcsr_impose_sparsity``, ``src/ops/dbcsr_test_methods.F:102``)."""
    out = np.zeros_like(dense)
    ro = like.index.row_offsets
    co = like.index.col_offsets
    rows = like.index.blk_rows
    cols = like.index.col_idx
    for b in range(like.nblks):
        i, j = int(rows[b]), int(cols[b])
        out[ro[i]:ro[i + 1], co[j]:co[j + 1]] = dense[ro[i]:ro[i + 1], co[j]:co[j + 1]]
        if like.sym != SYM_NONE and i != j:
            out[ro[j]:ro[j + 1], co[i]:co[i + 1]] = dense[ro[j]:ro[j + 1], co[i]:co[i + 1]]
    return out


def check_multiply(
    transa: str,
    transb: str,
    alpha,
    a: BCSRMatrix,
    b: BCSRMatrix,
    beta,
    c_in: Optional[BCSRMatrix],
    c_out: BCSRMatrix,
    *,
    retain_sparsity: bool = False,
    eps_factor: float = 100.0,
) -> bool:
    """Norm-scaled residual acceptance test (``dbcsr_check_multiply``,
    ``tests/dbcsr_test_multiply.F:616-640``): accept when
    ``|C_dense - C_sparse|_max <= eps_factor · ε_machine · scale`` with
    ``scale = max(|A|, |B|, |C|)`` 1-norm products. 'C' is the conjugate
    transpose (on real matrices, 'T')."""
    da = to_dense_local(a)
    db = to_dense_local(b)
    if transa.upper() in ("T", "C"):
        da = da.conj().T if transa.upper() == "C" else da.T
    if transb.upper() in ("T", "C"):
        db = db.conj().T if transb.upper() == "C" else db.T
    ref = alpha * (da @ db)
    if c_in is not None:
        ref = ref + beta * to_dense_local(c_in)
    if retain_sparsity and c_in is not None:
        ref = impose_sparsity(ref, c_in)
    got = to_dense_local(c_out)
    eps = np.finfo(got.dtype).eps
    scale = max(
        np.abs(da).sum(axis=0).max() * np.abs(db).sum(axis=0).max(),
        np.abs(ref).max(),
        1.0,
    )
    resid = np.abs(got - ref).max()
    return bool(resid <= eps_factor * eps * scale)


def test_mm(
    device,
    *,
    nblkrows: int = 60,
    nblkcols: int = 50,
    nblkks: int = 55,
    block_sizes: Sequence[int] = (2, 3, 5),
    occupancy: float = 0.3,
    dtype=np.float64,
    seed: int = 0,
    verbose: bool = False,
) -> bool:
    """Multiply self-test sweep (``dbcsr_test_mm``) on ``device``:
    transposes × alpha/beta on random matrices, dense-oracle checked; a
    complex ``dtype`` adds the conjugate transpose 'C' and complex
    coefficients. Returns True if all pass."""
    from .mm.engine import multiply
    from .ops.random import random_block_sizes, random_matrix

    rng = np.random.default_rng(seed)
    mbs = random_block_sizes(nblkrows, block_sizes, rng)
    kbs = random_block_sizes(nblkks, block_sizes, rng)
    nbs = random_block_sizes(nblkcols, block_sizes, rng)
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    flags = ("N", "T", "C") if cplx else ("N", "T")
    coefs = ((1.0, 0.0, False), ((2.0 - 1.0j, 0.5j, True) if cplx else (2.0, 0.5, True)))
    ok = True
    for transa in flags:
        for transb in flags:
            ta, tb = transa != "N", transb != "N"
            a = random_matrix(
                kbs if ta else mbs, mbs if ta else kbs,
                occupancy, rng, dtype=dtype, name="A", device=device,
            )
            b = random_matrix(
                nbs if tb else kbs, kbs if tb else nbs,
                occupancy, rng, dtype=dtype, name="B", device=device,
            )
            for alpha, beta, with_c in coefs:
                c_in = (random_matrix(mbs, nbs, occupancy, rng, dtype=dtype,
                                      name="C", device=device)
                        if with_c else None)
                c_out = multiply(transa, transb, alpha, a, b, beta, c_in)
                good = check_multiply(transa, transb, alpha, a, b, beta, c_in, c_out)
                if verbose or not good:
                    print(f"test_mm {transa}{transb} alpha={alpha} beta={beta} "
                          f"c={'Y' if with_c else 'N'}: {'OK' if good else 'FAILED'}")
                ok = ok and good
    return ok


def test_binary_io(device, *, seed: int = 0, verbose: bool = False) -> bool:
    """Checkpoint self-test (``dbcsr_test_binary_io``): write, read back
    onto ``device``, compare checksums."""
    from .ops.io import binary_read, binary_write, checksum
    from .ops.random import random_block_sizes, random_matrix

    rng = np.random.default_rng(seed)
    rbs = random_block_sizes(40, [2, 3, 5], rng)
    m = random_matrix(rbs, rbs, 0.3, rng, dtype=np.float64, name="io_test",
                      device=device)
    with tempfile.NamedTemporaryFile(suffix=".dbcsr") as f:
        binary_write(m, f.name)
        m2 = binary_read(f.name, device=device)
    good = (
        m2.nblks == m.nblks
        and m2.device == m.device
        and abs(checksum(m2) - checksum(m)) <= 1e-12 * max(checksum(m), 1.0)
    )
    if verbose or not good:
        print(f"test_binary_io: {'OK' if good else 'FAILED'}")
    return good


def test_tas(device, *, seed: int = 0, verbose: bool = False) -> bool:
    """TAS self-test: a tall multiply against a dense oracle (the
    reference's ``dbcsr_tas_unittest`` checksum recipe in miniature)."""
    from .ops.random import random_block_sizes, random_matrix
    from .tas import tas_multiply

    rng = np.random.default_rng(seed)
    mbs = random_block_sizes(300, [2, 3], rng)
    kbs = random_block_sizes(24, [3], rng)
    nbs = random_block_sizes(20, [2], rng)
    a = random_matrix(mbs, kbs, 0.3, rng, dtype=np.float64, name="A", device=device)
    b = random_matrix(kbs, nbs, 0.6, rng, dtype=np.float64, name="B", device=device)
    out = tas_multiply("N", "N", 1.0, a, b, nsplit=4).matrix
    ref = to_dense_local(a) @ to_dense_local(b)
    good = bool(np.abs(to_dense_local(out) - ref).max()
                <= 1e-10 * max(np.abs(ref).max(), 1.0))
    if verbose or not good:
        print(f"test_tas: {'OK' if good else 'FAILED'}")
    return good


def test_tensor(device, *, seed: int = 0, verbose: bool = False) -> bool:
    """Tensor self-test: a rank-3 contraction against an einsum oracle (the
    reference's ``dbcsr_t_contract_test``)."""
    from .tensors import NDMapping, TensorBuilder, contract

    rng = np.random.default_rng(seed)
    bs = [np.array([2, 3]), np.array([2, 2]), np.array([3, 1, 2])]
    bs_l = [np.array([4])]

    def build(sizes, occ, mapping=None):
        bld = TensorBuilder(sizes, mapping, dtype=np.float64, device=device)
        nbpd = [len(s) for s in sizes]
        for flat in np.flatnonzero(rng.random(int(np.prod(nbpd))) < occ):
            bi = np.unravel_index(flat, nbpd)
            shp = tuple(int(sizes[d][bi[d]]) for d in range(len(sizes)))
            bld.put_block(bi, rng.standard_normal(shp))
        return bld.finalize()

    a = build(bs, 0.7, NDMapping(3, (0, 1), (2,)))
    b = build([bs[2]] + bs_l, 0.8)
    out = contract(
        1.0, a, b,
        contract_1=(2,), notcontract_1=(0, 1),
        contract_2=(0,), notcontract_2=(1,),
    )
    ref = np.einsum("ijk,kl->ijl", to_numpy(a.to_dense()), to_numpy(b.to_dense()))
    good = bool(np.abs(to_numpy(out.to_dense()) - ref).max()
                <= 1e-10 * max(np.abs(ref).max(), 1.0))
    if verbose or not good:
        print(f"test_tensor: {'OK' if good else 'FAILED'}")
    return good


def test_dist(device, *, seed: int = 0, verbose: bool = False) -> bool:
    """Distributed self-test: ``multiply(dist=...)`` over grids of virtual
    ranks on ``device`` — Cannon 2×2 (tile-aligned and, through the
    element-granular plan, block-cyclic), 2.5D Cannon 2×2×2, SUMMA 2×3 and
    2.5D SUMMA 2×2×2 — in float64, ``beta·C`` included, and the sharded
    executor on 2×2, each against the dense oracle. After
    ``init_lib(distributed=True)`` the grids span the world's processes:
    every process takes part and every process checks."""
    from .core.config import config_override
    from .dist import (
        ProcessGrid,
        block_cyclic_dist,
        shard_matrix,
        sharded_multiply,
        tile_aligned_dist,
    )
    from .mm.engine import multiply
    from .ops.random import random_block_sizes, random_matrix

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    tile = 16
    good = True
    with config_override(tile_size=tile):
        mbs = random_block_sizes(90, [3, 5], rng)
        kbs = random_block_sizes(70, [4, 6], rng)
        nbs = random_block_sizes(80, [2, 7], rng)

        def mat(r, c, occ, name):
            return random_matrix(r, c, occ, rng, dtype=np.float64, name=name,
                                 device=device)

        a, b, c = mat(mbs, kbs, 0.3, "A"), mat(kbs, nbs, 0.3, "B"), mat(mbs, nbs, 0.2, "C")
        ref = 0.5 * to_dense_local(a) @ to_dense_local(b) - 2.0 * to_dense_local(c)
        scale = max(np.abs(ref).max(), 1.0)
        cases = [((2, 2, 1), "aligned", True), ((2, 2, 1), "cyclic", False),
                 ((2, 2, 2), "aligned", True), ((2, 3, 1), "aligned", True),
                 ((2, 2, 2), "summa", True)]
        for shape, kind, tiled in cases:
            grid = ProcessGrid.make(*shape, devices=[device] * 8)
            dist = (block_cyclic_dist(grid, len(mbs), len(nbs)) if kind == "cyclic"
                    else tile_aligned_dist(grid, mbs, nbs, tile))
            algo = "summa" if kind == "summa" else "auto"
            with config_override(use_tiled_cannon=tiled, mm_dist_algo=algo):
                out = multiply("N", "N", 0.5, a, b, -2.0, c, dist=dist)
            ok = bool(np.abs(to_dense_local(out) - ref).max() <= 1e-10 * scale)
            good = good and ok
            if verbose or not ok:
                print(f"test_dist: {'x'.join(map(str, shape))} {kind}: "
                      f"{'OK' if ok else 'FAILED'}")
        # the sharded form: a square matrix squared, at rest on its owners
        grid = ProcessGrid.make(2, 2, devices=[device] * 4)
        s = mat(mbs, mbs, 0.3, "S")
        ss = shard_matrix(s, tile_aligned_dist(grid, mbs, mbs, tile))
        out = sharded_multiply("N", "N", 1.0, ss, ss).to_local()
        ref = to_dense_local(s) @ to_dense_local(s)
        ok = bool(np.abs(to_dense_local(out) - ref).max()
                  <= 1e-10 * max(np.abs(ref).max(), 1.0))
        good = good and ok
        if verbose or not ok:
            print(f"test_dist: sharded 2x2: {'OK' if ok else 'FAILED'}")
    return good


def run_tests(device, *, verbose: bool = False) -> bool:
    """Run every built-in self-test on ``device`` (``dbcsr_run_tests``).
    On a CUDA device the kernels are built first; a build failure raises."""
    device = torch.device(device)
    if device.type == "cuda":
        from . import _build

        _build.build_kernels()
    ok = test_mm(device, verbose=verbose)
    ok = test_mm(device, nblkrows=20, nblkcols=16, nblkks=18, dtype=np.complex128,
                 verbose=verbose) and ok
    ok = test_binary_io(device, verbose=verbose) and ok
    ok = validate_kernels(device, verbose=verbose) and ok
    ok = test_tas(device, verbose=verbose) and ok
    ok = test_tensor(device, verbose=verbose) and ok
    ok = test_dist(device, verbose=verbose) and ok
    if verbose:
        print(f"run_tests: {'ALL OK' if ok else 'FAILURES'}")
    return ok
