#!/usr/bin/env python3
"""Bring-up smoke test of the PyTorch/CUDA port (dbcsr_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py            # every phase, one GPU
    python3 chip_smoke.py --quick    # phases 1, 2, 3, 5 and 8 (no large run)

Phases (any failure exits non-zero before the final line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels from ``dbcsr_tpu_torch/csrc`` with nvcc into the
   git-ignored build directory (ptxas register report printed); then the
   card's own peaks from register-only loops (FFMA, and the FP64 ``mma``
   shapes m16n8k8 and m8n8k4), so that a share of the data-sheet bound can
   be read against what this card reaches;
3. each kernel (K1 flat stack, K2 panel) against its plain PyTorch version
   on the card: f32 and bf16→f32, T=128 and T=32, a stack with one long run
   per C tile and a banded panel plan with a clamped last group; the
   blocked routine (T=128/64) under K1 and K2 on runs of 48, runs of 1, a
   ragged stack with empty C tiles and the banded plan, each against its
   plain version, bitwise against the other and against itself, and with
   tile slots past 2³¹ elements of offset; the
   float64 stack kernel (the port of K6) at T=128/64/32 on runs of 48, runs
   of 1, a ragged stack, a banded stack and far slots, against its plain
   version and a host float64
   recomputation of sampled C tiles; K5 (band), K4 (grouped) and K3
   (run-fused panel) at T=128/64/32/16 with f32, bf16 and (K4, K5) f64
   inputs, against their plain versions and a host float64 recomputation,
   two launches bitwise equal, on small plans that hit their traps (negative
   ``off_a`` on rectangular grids; for K4 each way its rows reach the C
   store: split C runs joined by the ordered segment sum, the kernel writing
   the store past padding rows, and C slots that no row produces, which must
   be zero in a store on NaN-filled memory; ``runlen`` 2 and 4 with all
   three tiers, the clamped last group); KC1 and KC2 (the complex64 and
   complex128 flat-stack kernels) at T=128/64/32/16 on runs of 48, runs of
   1, ragged runs, runs with empty C tiles first, last and in a row, a
   banded stack and (T=128) slots past 2³¹ elements, against their plain
   version and a host complex128 recomputation, two launches bitwise equal;
   then K5 and K3 as Jobs of the
   pipelined routines (T=128/64): K5 on bands with holes planned over every
   band position of C, so that runs lose their first cell, their last,
   several in a row and every cell (a zero tile), in float32, bf16 and
   float64 (the FP64 ``mma`` routine), against its plain version, a host
   float64 recomputation and, bitwise, the flat kernel of its type on
   ``band_owned_stack``; K3 at ``runlen`` 2, 3 and 4, with and without
   ``cm_perm``, and with cells longer than its window of expanded pairs,
   against its plain version and, bitwise, K1 on ``panel_runs_owned_stack``;
4. the main path at a real size: the banded linear-scaling SCF pattern of
   ``bench.py`` (blocks of 5/13/23, band of ±12 blocks at 50% fill, T=128)
   at 400,000 rows through ``build_multiply_executor`` — ``auto`` must run
   K2 and not K1, ``mm_driver="stack"`` must run K1 — at
   ``matmul_precision`` "highest" and "default", each result checked
   against the plain version on the card and against a float64 host
   recomputation of 64 sampled C tiles;
5. a one-shot ``multiply('N', 'T', alpha, A, B, beta, C)`` through the dense
   path at the H2O perf shape (``tests/inputs/H2O.perf``: 2208³, 23-blocks,
   80% of blocks stored), checked against a float64 dense product;
6. CUDA-event medians of the executors, the kernels alone and their plain
   versions at the phase-4 shape, as GFLOP/s beside the card and its limit,
   each kernel's TFLOP/s and share of its bound, and the steady-state rates
   of K1, K2 and the float64 kernel on synthetic stacks (runs of 32 and of 1
   over tiles that stay in L2), which split a kernel's time into its inner
   loop and its cost per C tile;
7. the double-precision filtered SCF path at the phase-4 shape in float64,
   with ``bench.py``'s off-diagonal decay exp(-1.5·|bi-bj|) and
   ``filter_eps`` = 1e-5: ``build_filtered_executor`` steps over three data
   variants (the float64 kernel must run, K1/K2 must not), each step against
   the same step through the kernel's plain version, ``compact()`` against
   the one-shot ``multiply(filter_eps=...)``, and CUDA-event medians of the
   step, its superset product, the kernel alone and its plain version;
   then every kernel that takes the step's stack, on it: the float64 stack
   kernel, K4 (``driver="grouped"``) and K5 (``driver="band"``), all on the
   FP64 tensor cores, must be bitwise equal to each other and twice to
   themselves, and each must agree with its plain version and with a host
   float64 recomputation of 64 sampled C tiles; then the same once in
   float32, where the step runs K2 and K1, K2, K4 and K5 must be bitwise
   equal. K5's times are printed beside what the design it replaced read;
8. the McWeeny purification loop of ``tests/test_purification.py`` on the
   card (T=16, ``mm_driver="stack"``, so every product takes the float64
   kernel) with that test's assertions, against the same loop on CPU
   tensors;
9. the further drivers at the phase-4 shape (float32, "highest") through
   ``build_multiply_executor``: ``driver="band"`` (K5), ``driver="grouped"``
   (K4) and ``panel_runlen=4`` under ``driver="panel"`` (K3), each against
   its plain version, a float64 host recomputation of sampled tiles and
   phase 4's panel result, with CUDA-event medians and the plan figures (K4
   must write the C store itself there: no join, no padded copy of C), and
   K5 and K3 once more with bf16 inputs ("default");
   then the RCM reordering on clustered-but-scrambled patterns: bench.py's
   ``clustered`` chain (blocks 5/13/23, coupling exp(-d/4) out to 15 blocks,
   numbering scrambled) at 60,000 rows with ``reorder`` "off" and "auto" and
   at the block level (``locality_block_permutation`` + ``permute_blocks``:
   the product of the permuted matrices is the permuted product), and a
   scrambled band of 128-blocks (the tile pattern is the block pattern) at
   512,000 rows, where ``reorder="auto"`` must take the panel route and
   agree with the flat kernel's result under ``reorder="off"``: ±2 blocks
   with every knob at its default, ±3 blocks under ``panel_cache=64``.

10. the library yardstick: ``torch.sparse.mm`` (CSR × CSR, cuSPARSE
    SpGEMM), the one PyTorch call that computes the same product, beside
    the executor at 40,000 and 400,000 rows of the banded SCF shape, with
    phase 4's float32 operands, phase 7's float64 operands and phase 13's
    complex ones, and at 40,000 rows each kernel that computes the product
    (K1-K5 in float32) timed alone; where cuSPARSE refuses the product for
    want of resources, ``library_ms`` is null; any other error fails the
    run.
11. the block-sparse tensor contraction through the TAS and tensor layers:
    shape R, an RI-type 3-center contraction C(μ,ν,Q) = Σ_P A(μ,ν,P)·B(P,Q)
    over a chain of 450 atoms (``ri_pattern``), in float32 (the panel route,
    K2) and float64 (the float64 stack kernel): R1 ``BatchedContract`` in
    steady state beside the folded 2-D executor and its kernel, R2 one-shot
    ``contract`` with ``nsplit`` 1 and 4, R4 the refold of A to (P | μν),
    R3 the k-long contraction C(P,Q) = Σ_{μν} A(μ,ν,P)·A(μ,ν,Q) with
    ``nsplit`` 4; every leg against the others, R1 and R3 against a float64
    host recomputation of 256 sampled blocks; the native planner must lay
    out every fold space. Then shape T, bench.py's tensor shape with its
    tall axis × 45 (the dense route), against a float64 matmul of the
    folded dense operands. Runs after phase 8, before phase 10.
12. the host API around the multiply, on phase 4's banded SCF operands at
    400,000 rows in float32 and float64, after phase 11 and before phase
    10: (a) ``multiply(limits=...)`` with beta 0.5 and C = the full product,
    W1 over the middle half of the block rows and columns (k full) against
    the full product inside the window and ``beta·C`` bitwise outside it, W2
    over rows, columns and k against the plain version of its window
    product and a float64 host recomputation of 256 sampled blocks; (b)
    ``retile``: a bitwise round trip, and the executors at T = 64 (``auto``
    and ``stack``, which both take K1 there, and ``panel`` with a cache of
    96 for K2; float64) and T = 32 (``stack``, both types) against T = 128,
    each kernel timed beside its bound at that T; (c) a float64 binary
    checkpoint written and read back onto the card, bitwise; (d) ``to_csr``
    and ``from_csr`` of float32 A, bitwise; (e) every ``tests/inputs/*.perf``
    recipe through ``perf.run_perf``, its checksum against a host float64
    recomputation (the files' TPU references are printed, not gated); (f)
    ``testing.run_tests`` and ``validate_kernels`` on the card; (g)
    ``device_memory_stats`` against ``torch.cuda.max_memory_allocated``.
    Every leg holds the launch counters to the kernel its route names (none
    for the checkpoint, the CSR exchange and the dense path).
13. complex matrices, after phase 12 and before phase 10: (a) the banded
    SCF operands at 400,000 rows in complex64 and complex128 through
    ``build_multiply_executor`` under ``auto`` (route ``c_stack``; KC1 /
    KC2 the only launches of the main-path run), two calls bitwise equal,
    against the plain version, a host complex128 recomputation of 64
    sampled tiles and the TPU's schedule of four real products through K1 /
    the float64 kernel on split planes, with CUDA-event medians of each and
    the kernel's bound (8·T³ real flops a tile product); (b) a Hermitian A
    (``sym="H"``), ``transa="C"``, alpha 0.5+0.25j and beta 1j on a complex
    C, one-shot and executor, against a host recomputation of 256 sampled
    blocks; (c) the complex128 filtered step (phase 7's decay and eps),
    ``compact()`` equal to the one-shot ``multiply(filter_eps=...)``; (d)
    shape R in complex128 through ``BatchedContract``; (e) the H2O recipe as
    data type 7 through ``perf.run_perf`` (dense route), its checksum against
    a host complex128 recomputation.
14. the distributed multiply over virtual ranks of this card, after phase
    13 and before phase 10: (a) ``build_distributed_executor`` with a
    ``tile_aligned_dist``, Cannon on a 2×2 grid at the phase-4 shape in
    float32 (K1 ticks) and float64 (the float64 kernel's ticks), and the
    one-shot ``multiply(dist=...)`` with its message statistics; (b) the
    8-rank dryrun at T = 128 in float32: 2.5D Cannon 2×2×2, SUMMA 2×4 and
    2.5D SUMMA 2×2×2; (c) a block-cyclic distribution through the
    element-granular Cannon plan at 40,000 rows with ``filter_eps=1e-9``
    against the local one-shot, and Cannon 2×2 in complex128 (KC2 ticks);
    (d) the sharded at-rest form in float64 (``shard_matrix``,
    ``build_sharded_multiply``, ``sharded_filter``/``sharded_trace``/
    ``sharded_frobenius`` against the local ops, a sharded checkpoint round
    trip, bitwise); (e) shape R through ``tas_multiply_parallel``
    (``long_dim="auto"``, 4 groups) in float32 and float64 and ``contract``
    over a ``TensorPGrid``. Every leg: its dtype's stack kernel the only
    launch, once per non-empty (rank, tick) stack (group), two calls bitwise
    equal, against the local product and (a-c) a host float64
    recomputation of 64 sampled tiles, CUDA-event medians of the executor
    and its parts (packing, ticks, unpacking) beside the local executor.
15. the C API (``dbcsr_tpu_torch/capi/``, built with gcc), after phase 14
    and before phase 10: (a) a C library loaded into this process with
    ctypes builds phase 7's float64 operands (no decay) at 400,000 rows
    from host blocks through ``c_dbcsr_create_new``,
    ``c_dbcsr_reserve_blocks``, ``c_dbcsr_put_block2d_d`` and
    ``c_dbcsr_finalize``, then runs ``c_dbcsr_multiply_d('N', 'N', 1, A, B,
    0, C)`` once cold and ten times warm, each timed with CUDA events in
    turns with the Python one-shot ``multiply`` (with the same C and with an
    empty one): the float64 kernel the only launch, once a call; C read back
    through ``c_dbcsr_get_data_d`` bitwise equal to the Python product;
    ``c_dbcsr_checksum``, ``c_dbcsr_trace_d`` and 64 sampled blocks against
    a host float64 recomputation; (b) ``examples/example_6_c_api.c``,
    unchanged, as a program of its own with ``DBCSR_CAPI_DEVICE=cuda:0``;
    (c) the typed sweep of ``tests/test_capi_v2.py`` (``MATRIX_PROGRAM``) in
    this process under ``mm_driver="panel"``: its d, s, z and c products
    launch the float64 kernel, K2, KC2 and KC1 once each.
16. the tuned ``auto``, after phase 15 and before phase 10 (phases 3-15 and
    10 run with the card's parameter table held off, so they keep their
    untuned routes): (a) the committed table for this card
    (``dbcsr_tpu_torch/params/``) must load; (b) ``autotune.sweep`` at the
    banded_fine class (12,000 rows), one row each of ``stack``, ``panel``
    (``panel_runlen`` 0 and 3), ``grouped`` and ``band`` at default knobs,
    GFLOP/s per row, every timed call launching its route's kernel (K1-K5)
    once; then each kernel alone against its plain version, timed beside its
    bound and ``torch.sparse.mm`` on the same operands; (c) at the phase-4
    shape, ``auto`` at default provenance must take the table's driver for
    the nearest class, its product bitwise the explicit driver's with the
    same knobs and within 1e-4 of the plain version, its CUDA-event median
    beside the untuned auto's (K2); (d) shape R's float32 fold at default
    provenance: its route and nearest class, against the plain version.
17. the multi-process form, after phase 16 and before phase 10: workers of
    this file, spawned with ``torch.multiprocessing`` (the kernels built
    above, one library for all), each brought up with
    ``init_lib(distributed=True, backend="gloo", device="cuda:0",
    coordinator_address="file://...")``: (a) two processes, Cannon 2×2 at
    the phase-4 shape in float32 (K1) and float64 (the float64 kernel),
    each process's C bitwise phase 14's single-process executor (digest,
    64 sampled tiles, their host float64 recomputation), later calls bitwise,
    one plan on both, each process's launches its ranks' ticks, CUDA-event
    medians of the executor and its parts, the bytes moved a call; first
    each asks for ``backend="nccl"``, which must refuse two processes on one
    card; (b) four processes at 12,000 rows: 2.5D Cannon 2×2×2 and SUMMA 2×4
    in float32, Cannon 2×2 in complex128 (KC2), the sharded float64 form
    (multiply, filter, trace, Frobenius norm, a checkpoint each process
    writes its shards of), ``tas_multiply_parallel`` (4 groups) and
    ``contract`` over a ``TensorPGrid``, each bitwise the same code run on
    this process's virtual ranks; (c) with two cards, (a) again over NCCL,
    one process a card, else a line saying it was not run. A failed worker,
    or one past its deadline, kills the others and fails the run.
18. the examples and the planner-scale tools, after phase 17 and before
    phase 10, with the card's tuned table loaded: (a) ``examples/torch/``
    1, 2, 3, 5, 8, 9 and 10, each through its ``main(["--device",
    "cuda"])`` in this process (each passes its own assertions), with its
    wall seconds, routes and launches; example 3's executor timed by CUDA
    events; example 9 once more with ``--nprocs 2`` over gloo, its C
    bitwise the single-process one; (b) ``tools/torch/large_scale_check.py``
    at 1,000,000 rows (band ±8 blocks, float32, T = 128) under the tuned
    ``auto`` and under ``mm_driver="stack"``: set-up, layout, first call,
    build and executor median beside phase 4's 400,000-row executors, host
    peak RSS and peak device memory; each leg's C store against its kernel's
    plain version and 64 sampled tiles against a host float64
    recomputation, the two legs against each other, each leg launching a
    hand-written kernel; then the tool as a program in a process of its own
    (its host peak RSS and peak device memory, its counts and route equal to
    the in-process auto leg's); (c) ``tools/torch/weak_scaling.py``: over every
    card, and over as many processes with nccl, where there are two cards
    or more; else four virtual ranks on the one card (``shared_device``:
    orchestration only) and a line saying the multi-card leg was not run.

Phase 9 runs after phase 6 (it reuses phase 4's matrices and panel result).
The kernel summary is one JSON line (eight kernels: the six ports of the
TPU's kernels and KC1, KC2, each with its launches in phases 17 and 18; then
K1-K5 once more at phase 16's sweep rows;
``bound_ms`` is computed from this run's tile
and product counts against NVIDIA's H100 SXM data-sheet peaks), then the
``nvidia-smi`` line, then the final line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: relative error bound (max |kernel - reference| / max |reference|) for
#: every comparison of a stack kernel: both sides accumulate in float32
#: (bf16 inputs are widened, so products are exact) in different orders
#: over K = run length · T ≤ 6144 terms; the worst-case rounding bound
#: K·2⁻²⁴ is 3.7e-4, the typical error ~sqrt(K)·2⁻²⁴ ≈ 5e-6. A wrong tile,
#: entry or slot gives an error of order 1.
KERNEL_RTOL = 1e-4
#: dense path vs float64, K = 2208: IEEE float32 ("highest") and bf16 inputs
#: with float32 accumulation ("default", inputs rounded to 2⁻⁹ relative)
DENSE_RTOL = {"highest": 1e-5, "default": 2e-2}
#: rows of the banded SCF shape in phase 4: at 40,000 (bench.py's size) A is
#: 1,513 tiles (99 MB), too small for an 80 GB card; 400,000 gives A and B
#: 15,018 tiles (0.98 GB) each and C 1.76 GB
MAIN_ROWS = 400_000
#: float64 kernel against its plain version and a host float64
#: recomputation: float64 sums of the same products in another order, over
#: K ≤ 48·128 terms (worst case K·2⁻⁵³ ≈ 7e-13, typical far below); a wrong
#: tile or entry gives an error of order 1
F64_RTOL = 1e-12
#: phase 7: bench.py's filtered SCF settings (decay rate, eps) and the
#: number of A data variants the executor steps through
DECAY = 1.5
FILTER_EPS = 1e-5
N_VARIANTS = 3
#: phase 9: rows of the scrambled chain (bench.py's clustered leg stops at
#: 24,000). Scrambled, nearly every block lands in a tile of its own: 60,000
#: rows are ≈ 34,600 blocks in ≈ 32,000 tiles of 64 KiB (2.1 GB per operand)
#: on a 469² tile grid, whose tile-level product is dense (≈ 220,000 C tiles,
#: 14.4 GB out of the kernel)
SCRAMBLED_ROWS = 60_000
#: phase 9: block rows of the scrambled bands of 128-blocks, 512,000 rows:
#: ±2 blocks, 5 tiles a row, 20,000 tiles (1.3 GB) per operand; ±3 blocks, 7
#: tiles a row, 28,000 tiles (1.8 GB) per operand. The store
#: layout keeps an int64 element map on the host (8 bytes per stored
#: element: 3.7 GB per operand here, 6.8 GB for C), and past a 4096² tile
#: grid its numpy path's temporaries exhausted a 96 GiB host at 5,500 block
#: rows, so the grid stays at 4000²
TILE_BAND_BLOCKS = 4_000
#: phase 10: the smaller size of the library yardstick, bench.py's own
#: ``banded`` row count (cuSPARSE SpGEMM needs ~30 GB of work space there)
LIBRARY_ROWS = 40_000
#: phase 11: atoms of shape R, the RI-type 3-center contraction. At 450 A's
#: folded tile grid is 322,004 x 49 = 15.8 M cells, under the 2^24 = 16.8 M
#: past which the JAX package's native planner declines the store layout and
#: numpy's element-wise path takes over (the port's cap also grows with the
#: stored elements, ``native.native_grid_cap``); A 13,900 tiles (0.91 GB in
#: float32), C 32,424 planned tiles
TENSOR_ATOMS = 450
#: phase 11: the tall axis of shape T, bench.py's tensor shape (2,000
#: elements there) times 45: A 54,911 tiles (3.6 GB)
TENSOR_T_ROWS = 90_000
#: what K5 and K3 took at the phase-4 shape (K5 float64: the phase-7 stack)
#: under the design they ran before the pipelined routines — ``tile_run`` on
#: four sub-tile blocks a C tile at T = 128, a DFMA loop in float64 — as this
#: script read them on the card named; printed beside this run's times
OLD_ROUTINE_MS = {"K5 float32": 12.222, "K3 float32": 11.921, "K5 float64": 18.576}
OLD_ROUTINE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: NVIDIA H100 SXM data sheet, dense rates: HBM3 bytes/s; float32 outside
#: the tensor cores (IEEE float32 has no tensor-core route; the kernels widen
#: bf16 inputs to float32 too); float64 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def kernel_bound(n_a: int, n_b: int, n_c: int, n_products: int, tile: int,
                 in_bytes: int, out_bytes: int, peak: str) -> tuple:
    """The least time (ms) the card could take for a stack product: the
    larger of its compulsory bytes (each A and B tile read once, each C tile
    written once) over the HBM rate and the tile products this run's data
    needs (2·T³ flops each) over the peak rate; and which of the two."""
    t_bytes = (((n_a + n_b) * in_bytes + n_c * out_bytes) * tile * tile
               / HBM_BYTES_PER_S * 1e3)
    t_ops = 2.0 * n_products * tile**3 / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), taken in float64 over slices
    of the leading dimension so that two stores of several GB need no
    float64 copies of their own (complex stores: over their real and
    imaginary parts); (inf, inf) if ``got`` is not finite."""
    import torch

    if got.is_complex():
        got = torch.view_as_real(got.resolve_conj())
    if ref.is_complex():
        ref = torch.view_as_real(ref.resolve_conj())
    if got.shape != ref.shape:
        return float("inf"), float("inf")
    if got.dim() == 0 or got.numel() == 0:
        got, ref = got.reshape(1, -1), ref.reshape(1, -1)
    err = scale = 0.0
    step = max(1, (1 << 26) // max(got[0].numel(), 1))  # 64 Mi elements a slice
    for s in range(0, got.shape[0], step):
        g, r = got[s:s + step].double(), ref[s:s + step].double()
        if not bool(torch.isfinite(g).all()):
            return float("inf"), float("inf")
        if g.numel():
            err = max(err, float((g - r).abs().max()))
            scale = max(scale, float(r.abs().max()))
    return err, err / (scale or 1.0)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_PEAK_BYTES = 0


def peak_memory(dev) -> int:
    """Peak device memory (bytes) of the run so far, kept across a reset of
    torch's own peak counter."""
    import torch

    global _PEAK_BYTES
    _PEAK_BYTES = max(_PEAK_BYTES, torch.cuda.max_memory_allocated(dev))
    return _PEAK_BYTES


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` calls of the device time between CUDA events
    recorded around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 2: what this card reaches from registers alone
# ---------------------------------------------------------------------------

#: register-only loops: 64 independent FFMA chains a thread; 8 independent
#: FP64 ``mma`` accumulator tiles a warp, in Hopper's m16n8k8 shape and in
#: Ampere's m8n8k4. 8 blocks of 256 threads an SM; each result is written so
#: that nothing is optimised away. rates[0..2] receive TFLOP/s.
PEAK_RATES_CU = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) ffma_loop(float* out, int iters)
{
    float acc[32], a = threadIdx.x * 1e-6f, b = 1.0f + blockIdx.x * 1e-7f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = i;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = fmaf(a, b, acc[i]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = fmaf(b, acc[i], a);
    }
    float s = 0;
    for (int i = 0; i < 32; ++i) s += acc[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool Hopper>
__global__ void __launch_bounds__(256) dmma_loop(double* out, int iters)
{
    double d[8][4], a[4], b[2];
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) d[i][j] = 0;
    for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 1e-9 + i;
    for (int i = 0; i < 2; ++i) b[i] = 1e-9 * (i + 1);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            if (Hopper)
                asm volatile(
                    "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                    "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                    : "+d"(d[i][0]), "+d"(d[i][1]), "+d"(d[i][2]), "+d"(d[i][3])
                    : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
            else
                asm volatile(
                    "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
                    : "+d"(d[i][0]), "+d"(d[i][1]) : "d"(a[0]), "d"(b[0]));
        }
    }
    double s = 0;
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) s += d[i][j];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <typename F> static float timed(F launch)
{
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    launch();  // warm-up
    cudaEventRecord(e0);
    launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
    return ms;
}
extern "C" int peak_rates(int device, int sms, double* rates)
{
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    const int blocks = sms * 8, iters = 8192;
    void* buf = nullptr;
    err = (int)cudaMalloc(&buf, (size_t)blocks * 256 * sizeof(double));
    if (err) return err;
    const double warps = (double)blocks * 8;
    float ms = timed([&] { ffma_loop<<<blocks, 256>>>((float*)buf, iters); });
    rates[0] = 2.0 * 64 * iters * blocks * 256 / ms / 1e9;
    ms = timed([&] { dmma_loop<true><<<blocks, 256>>>((double*)buf, iters); });
    rates[1] = 2.0 * 16 * 8 * 8 * 8 * iters * warps / ms / 1e9;
    ms = timed([&] { dmma_loop<false><<<blocks, 256>>>((double*)buf, iters); });
    rates[2] = 2.0 * 8 * 8 * 4 * 8 * iters * warps / ms / 1e9;
    err = (int)cudaDeviceSynchronize();
    cudaFree(buf);
    return err ? err : (int)cudaGetLastError();
}
"""


def phase_calibration(dev) -> dict:
    """Builds ``PEAK_RATES_CU`` with the port's nvcc and flags into the build
    directory and runs it once: {"ffma", "dmma_m16n8k8", "dmma_m8n8k4"} in
    TFLOP/s. The data-sheet peaks stay the bound; these say how much of a
    shortfall is the card's and how much the kernel's."""
    import ctypes

    import torch

    from dbcsr_tpu_torch import _build

    src = os.path.join(_build.build_dir(), "peak_rates.cu")
    lib_path = os.path.join(_build.build_dir(), "libpeak_rates.so")
    with open(src, "w") as f:
        f.write(PEAK_RATES_CU)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvcc failed for the peak-rate loops:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.peak_rates.restype = ctypes.c_int
    lib.peak_rates.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    rates = (ctypes.c_double * 3)()
    sync(dev)
    rc = lib.peak_rates(dev.index, torch.cuda.get_device_properties(dev).multi_processor_count, rates)
    if rc != 0:
        fail(f"the peak-rate loops returned CUDA error {rc}")
    return {"ffma": rates[0], "dmma_m16n8k8": rates[1], "dmma_m8n8k4": rates[2]}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def banded_tile_stack(mt: int, w: int):
    """Stack of a banded tile pattern (|r-c| <= w) times itself, with A, B
    and C tile stores all in that pattern's row-major slot order."""
    coords = [(r, c) for r in range(mt) for c in range(max(0, r - w), min(mt, r + w + 1))]
    slot = {rc: i for i, rc in enumerate(coords)}
    trip = []
    for (r, k), sa in slot.items():
        for c in range(max(0, k - w, r - w), min(mt, k + w + 1, r + w + 1)):
            trip.append((slot[(r, c)], sa, slot[(k, c)]))
    trip.sort()
    return np.asarray(trip, dtype=np.int32), len(coords)


def long_run_stack(rng, n_c: int, run: int, n_a: int, n_b: int):
    """Every C tile gets one run of ``run`` random (a, b) entries."""
    c = np.repeat(np.arange(n_c, dtype=np.int32), run)
    return np.stack(
        [c, rng.integers(0, n_a, len(c)).astype(np.int32),
         rng.integers(0, n_b, len(c)).astype(np.int32)], axis=1,
    )


def ragged_stack(rng, n_c: int, n_a: int, n_b: int, max_run: int = 9):
    """Runs of random length 0..max_run: some C tiles have no entry (their
    product is a zero tile) and the runs straddle every pipeline depth."""
    runs = rng.integers(0, max_run + 1, n_c)
    runs[rng.integers(0, n_c, 3)] = 0
    c = np.repeat(np.arange(n_c, dtype=np.int32), runs)
    return np.stack(
        [c, rng.integers(0, n_a, len(c)).astype(np.int32),
         rng.integers(0, n_b, len(c)).astype(np.int32)], axis=1,
    )


#: tiles of 128² whose element offsets pass 2³¹: slot 131,072 and beyond
FAR_TILES = 131_072 + 128


def far_stack(rng, n_c: int, run: int):
    """Every entry reads slots in the last 128 tiles of a FAR_TILES store."""
    st = long_run_stack(rng, n_c, run, 128, 128)
    st[:, 1:] += FAR_TILES - 128
    return st


def far_store(gen, dev, dtype):
    """A [FAR_TILES, 128, 128] store with only its last 128 tiles filled (the
    far stacks read nothing else): 8.6 GB in float32, 17.2 GB in float64."""
    import torch

    a = torch.empty((FAR_TILES, 128, 128), device=dev, dtype=dtype)
    a[-128:] = torch.randn((128, 128, 128), generator=gen, device=dev,
                           dtype=torch.float64 if dtype == torch.float64 else torch.float32).to(dtype)
    return a


def phase_kernels_k2_blocked(dev) -> dict:
    """The blocked routine (T = 128 and 64) under K2 and under K1 where its
    design could go wrong: runs of 1 (the ring never fills), of 48 (it wraps
    many times), ragged runs with empty C tiles, the banded plan with a
    clamped last group, float32 and bf16 inputs, and tile offsets past 2³¹
    elements; each kernel against its plain version and a host float64
    recomputation, bitwise against the other on the same stack and bitwise
    against a second launch. Returns the worst absolute error of each."""
    import torch

    from dbcsr_tpu_torch.mm.kernels import (
        device_stack, tile_stack_matmul, tile_stack_matmul_plain,
    )
    from dbcsr_tpu_torch.mm.panel import (
        device_panel_plan, plan_panel_stack, tile_stack_matmul_panel,
        tile_stack_matmul_panel_plain,
    )

    rng = np.random.default_rng(4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = {"K1": 0.0, "K2": 0.0}
    f32 = torch.float32
    bstack, n_band = banded_tile_stack(mt=60, w=2)
    cases = [("runs of 48", long_run_stack(rng, 37, 48, 96, 96), 37, 96),
             ("runs of 1", long_run_stack(rng, 69, 1, 96, 96), 69, 96),
             ("ragged, empty tiles", ragged_stack(rng, 53, 96, 96), 53, 96),
             ("banded", bstack, n_band, n_band)]

    def check(label, tile, dtype, st, n_c, a, b, n_store):
        nonlocal worst
        plan = plan_panel_stack(st, n_c, n_store, n_store, c_win=16, a_cap=n_store,
                                b_cap=n_store, chunk=1)
        if plan is None or plan.gstart[-1] % plan.c_win == 0:
            fail(f"K2 case {label!r} must plan with a clamped last group")
        dp = device_panel_plan(plan, dev)
        got = tile_stack_matmul_panel(a, b, dp, out_dtype=f32)
        again = tile_stack_matmul_panel(a, b, dp, out_dtype=f32)
        ds = device_stack(st, n_c, dev)
        flat = tile_stack_matmul(a, b, ds, out_dtype=f32)
        flat_again = tile_stack_matmul(a, b, ds, out_dtype=f32)
        ref = tile_stack_matmul_panel_plain(a, b, plan, out_dtype=f32)
        ref1 = tile_stack_matmul_plain(a, b, ds, out_dtype=f32)
        sync(dev)
        err, rel = rel_err(got, ref)
        err1, rel1 = rel_err(flat, ref1)
        picks = np.sort(rng.choice(n_c, size=6, replace=False))
        host = torch.as_tensor(host_f64_tiles(a, b, st, picks))
        herr, hrel = rel_err(got[picks].cpu(), host)
        herr1, hrel1 = rel_err(flat[picks].cpu(), host)
        worst["K2"] = max(worst["K2"], err, herr)
        worst["K1"] = max(worst["K1"], err1, herr1)
        same = bool(torch.equal(got, again)) and bool(torch.equal(flat, flat_again))
        k1 = bool(torch.equal(got, flat))
        log(f"  K1|K2 T={tile:3d} {str(dtype)[6:]:8s} {label:20s} S={len(st):5d} max_abs_err="
            f"{err1:.3e}|{err:.3e} rel={rel1:.2e}|{rel:.2e}; vs host float64 rel="
            f"{hrel1:.2e}|{hrel:.2e} (bound {KERNEL_RTOL:.0e}); "
            f"K1 == K2 bitwise: {k1}; two launches of each bitwise equal: {same}")
        if not (max(rel, rel1, hrel, hrel1) <= KERNEL_RTOL and same and k1):
            fail(f"K1 or K2 disagrees ({label}, T={tile}, {dtype})")

    for tile in (128, 64):
        for dtype in (f32, torch.bfloat16):
            for label, st, n_c, n_store in cases:
                a = torch.randn((n_store, tile, tile), generator=gen, device=dev).to(dtype)
                b = torch.randn((n_store, tile, tile), generator=gen, device=dev).to(dtype)
                check(label, tile, dtype, st, n_c, a, b, n_store)
    for dtype in (f32, torch.bfloat16):
        a = far_store(gen, dev, dtype)
        check("slots past 2^31", 128, dtype, far_stack(rng, 21, 3), 21, a, a, FAR_TILES)
        del a
    torch.cuda.empty_cache()
    return worst


def phase_kernels(dev) -> dict:
    import torch

    from dbcsr_tpu_torch.mm.kernels import (
        device_stack, tile_stack_matmul, tile_stack_matmul_plain,
    )
    from dbcsr_tpu_torch.mm.panel import (
        device_panel_plan, plan_panel_stack, tile_stack_matmul_panel,
        tile_stack_matmul_panel_plain,
    )

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {"K1": 0.0, "K2": 0.0}
    for tile in (128, 32):
        for dtype in (torch.float32, torch.bfloat16):
            cases = []
            stack = long_run_stack(rng, n_c=32, run=48, n_a=96, n_b=96)
            cases.append(("long runs", stack, 32, 96, 96))
            bstack, n = banded_tile_stack(mt=60, w=2)
            cases.append(("banded", bstack, n, n, n))
            for label, st, n_c, n_a, n_b in cases:
                a = torch.randn((n_a, tile, tile), generator=gen, device=dev).to(dtype)
                b = torch.randn((n_b, tile, tile), generator=gen, device=dev).to(dtype)
                ds = device_stack(st, n_c, dev)
                got = tile_stack_matmul(a, b, ds, out_dtype=torch.float32)
                ref = tile_stack_matmul_plain(a, b, ds, out_dtype=torch.float32)
                sync(dev)
                err, rel = rel_err(got, ref)
                worst["K1"] = max(worst["K1"], err)
                log(f"  K1 T={tile} {str(dtype)[6:]:8s} {label:9s} S={len(st):5d} "
                    f"max_abs_err={err:.3e} rel={rel:.2e} (bound {KERNEL_RTOL:.0e})")
                if not rel <= KERNEL_RTOL:
                    fail(f"K1 disagrees with its plain version ({label}, T={tile}, {dtype})")
                if label != "banded":
                    continue
                plan = plan_panel_stack(st, n_c, n_a, n_b, c_win=16, a_cap=64,
                                        b_cap=64, chunk=4)
                if plan is None or plan.gstart[-1] % plan.c_win == 0:
                    fail("the banded case must give a panel plan with a clamped last group")
                dp = device_panel_plan(plan, dev)
                got2 = tile_stack_matmul_panel(a, b, dp, out_dtype=torch.float32)
                ref2 = tile_stack_matmul_panel_plain(a, b, plan, out_dtype=torch.float32)
                sync(dev)
                err2, rel2 = rel_err(got2, ref2)
                worst["K2"] = max(worst["K2"], err2)
                same = bool(torch.equal(got, got2))
                log(f"  K2 T={tile} {str(dtype)[6:]:8s} {label:9s} groups={plan.n_groups} "
                    f"(last clamped to slot {plan.gstart[-1]}) max_abs_err={err2:.3e} "
                    f"rel={rel2:.2e} (bound {KERNEL_RTOL:.0e}); K1 == K2 bitwise: {same}")
                if not rel2 <= KERNEL_RTOL:
                    fail(f"K2 disagrees with its plain version (T={tile}, {dtype})")
    return worst


def host_f64_tiles(a, b, stack: np.ndarray, c_slots, in_dtype=None) -> np.ndarray:
    """C tiles ``c_slots`` of the product of a c-sorted stack, recomputed on
    the host in float64 (complex128 for complex stores) from the stores on
    the card, each first rounded to the kernel's input dtype ``in_dtype``
    (so the bound is the kernel's accumulation alone)."""
    import torch

    wide = torch.complex128 if a.is_complex() else torch.float64
    lo = np.searchsorted(stack[:, 0], c_slots, side="left")
    hi = np.searchsorted(stack[:, 0], c_slots, side="right")
    out = []
    for e0, e1 in zip(lo, hi):
        ga, gb = (m[stack[e0:e1, j].astype(np.int64)].to(in_dtype or m.dtype)
                  .to(wide).cpu().numpy() for m, j in ((a, 1), (b, 2)))
        out.append(np.einsum("eik,ekj->ij", ga, gb))
    return np.stack(out)


def phase_kernels_f64(dev) -> float:
    """The float64 stack kernel against its plain version and a host
    float64 recomputation; returns the worst absolute error."""
    import torch

    from dbcsr_tpu_torch.mm.f64_stack import (
        tile_stack_matmul_f64, tile_stack_matmul_f64_plain,
    )
    from dbcsr_tpu_torch.mm.kernels import device_stack

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst = 0.0
    bstack, n_band = banded_tile_stack(mt=40, w=2)
    n_st = max(96, n_band)
    for tile in (128, 64, 32):
        a = torch.randn((n_st, tile, tile), generator=gen, device=dev, dtype=torch.float64)
        b = torch.randn((n_st, tile, tile), generator=gen, device=dev, dtype=torch.float64)
        cases = [("runs of 48", long_run_stack(rng, n_c=32, run=48, n_a=96, n_b=96), 32),
                 ("runs of 1", long_run_stack(rng, n_c=64, run=1, n_a=96, n_b=96), 64),
                 ("ragged", ragged_stack(rng, 53, 96, 96), 53),
                 ("banded", bstack, n_band)]
        if tile == 128:  # last: it swaps the stores for one of 17.2 GB
            cases.append(("far slots", far_stack(rng, 21, 3), 21))
        for label, st, n_c in cases:
            if label == "far slots":
                del a, b
                a = b = far_store(gen, dev, torch.float64)
            ds = device_stack(st, n_c, dev)
            got = tile_stack_matmul_f64(a, b, ds)
            again = tile_stack_matmul_f64(a, b, ds)
            ref = tile_stack_matmul_f64_plain(a, b, ds)
            sync(dev)
            if got.dtype != torch.float64 or tuple(got.shape) != (n_c, tile, tile):
                fail(f"f64 kernel output {tuple(got.shape)} {got.dtype}")
            err, rel = rel_err(got, ref)
            picks = np.sort(rng.choice(n_c, size=6, replace=False))
            herr, hrel = rel_err(got[picks].cpu(),
                                 torch.as_tensor(host_f64_tiles(a, b, st, picks)))
            worst = max(worst, err, herr)
            same = bool(torch.equal(got, again))
            log(f"  K6 T={tile} float64  {label:10s} S={len(st):5d} max_abs_err={err:.3e} "
                f"rel={rel:.2e}; vs host float64 (6 tiles) rel={hrel:.2e} "
                f"(bound {F64_RTOL:.0e}); two launches bitwise equal: {same}")
            if not (rel <= F64_RTOL and hrel <= F64_RTOL and same):
                fail(f"the float64 kernel disagrees ({label}, T={tile})")
        del a, b
        torch.cuda.empty_cache()
    return worst


def gappy_stack(rng, n_c: int, n_a: int, n_b: int, run: int = 4):
    """Runs of ``run`` entries, but the first C tile, the last and five in a
    row in the middle have none (their product is a zero tile)."""
    runs = np.full(n_c, run)
    runs[[0, n_c - 1]] = 0
    runs[n_c // 2: n_c // 2 + 5] = 0
    c = np.repeat(np.arange(n_c, dtype=np.int32), runs)
    return np.stack(
        [c, rng.integers(0, n_a, len(c)).astype(np.int32),
         rng.integers(0, n_b, len(c)).astype(np.int32)], axis=1,
    )


#: the complex stack kernels' bounds against their plain version and a host
#: complex128 recomputation: each complex sum is four real sums of the
#: float32 (complex64) or float64 (complex128) kernel's length and type, so
#: the float32 and float64 bounds carry over
C_RTOL = {"complex64": KERNEL_RTOL, "complex128": F64_RTOL}


def phase_kernels_complex(dev) -> dict:
    """KC1 (complex64) and KC2 (complex128) at T = 128, 64, 32 and 16 on
    runs of 48, runs of 1, ragged runs, runs with empty C tiles first, last
    and five in a row, a banded stack and (T = 128) tile offsets past 2³¹
    elements: each against its plain version and a host complex128
    recomputation of sampled C tiles, and bitwise against a second launch.
    Returns the worst absolute error of each kernel."""
    import torch

    from dbcsr_tpu_torch.mm.c_stack import (
        tile_stack_matmul_c64, tile_stack_matmul_c128, tile_stack_matmul_c_plain,
    )
    from dbcsr_tpu_torch.mm.kernels import device_stack

    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    worst = {"KC1": 0.0, "KC2": 0.0}
    bstack, n_band = banded_tile_stack(mt=40, w=2)
    n_st = max(96, n_band)
    for kname, dtype, kernel in (("KC1", torch.complex64, tile_stack_matmul_c64),
                                 ("KC2", torch.complex128, tile_stack_matmul_c128)):
        tname = str(dtype)[6:]
        for tile in (128, 64, 32, 16):
            a = torch.randn((n_st, tile, tile), generator=gen, device=dev, dtype=dtype)
            b = torch.randn((n_st, tile, tile), generator=gen, device=dev, dtype=dtype)
            cases = [("runs of 48", long_run_stack(rng, n_c=32, run=48, n_a=96, n_b=96), 32),
                     ("runs of 1", long_run_stack(rng, n_c=64, run=1, n_a=96, n_b=96), 64),
                     ("ragged", ragged_stack(rng, 53, 96, 96), 53),
                     ("empty runs", gappy_stack(rng, 40, 96, 96), 40),
                     ("banded", bstack, n_band)]
            if tile == 128:  # last: it swaps the stores for one past 2³¹ elements
                cases.append(("far slots", far_stack(rng, 21, 3), 21))
            for label, st, n_c in cases:
                if label == "far slots":
                    del a, b
                    a = torch.empty((FAR_TILES, 128, 128), device=dev, dtype=dtype)
                    a[-128:] = torch.randn((128, 128, 128), generator=gen, device=dev,
                                           dtype=dtype)
                    b = a
                ds = device_stack(st, n_c, dev)
                got = kernel(a, b, ds)
                again = kernel(a, b, ds)
                ref = tile_stack_matmul_c_plain(a, b, ds)
                sync(dev)
                if got.dtype != dtype or tuple(got.shape) != (n_c, tile, tile):
                    fail(f"{kname} output {tuple(got.shape)} {got.dtype}")
                err, rel = rel_err(torch.view_as_real(got), torch.view_as_real(ref))
                picks = np.sort(rng.choice(n_c, size=6, replace=False))
                hrel = rel_err(torch.view_as_real(got[picks].cpu()), torch.view_as_real(
                    torch.as_tensor(host_f64_tiles(a, b, st, picks))))[1]
                worst[kname] = max(worst[kname], err)
                same = bool(torch.equal(got, again))
                log(f"  {kname} T={tile} {tname:10s} {label:10s} S={len(st):5d} "
                    f"max_abs_err={err:.3e} rel={rel:.2e}; vs host complex128 (6 tiles) "
                    f"rel={hrel:.2e} (bound {C_RTOL[tname]:.0e}); two launches bitwise "
                    f"equal: {same}")
                if not (rel <= C_RTOL[tname] and hrel <= C_RTOL[tname] and same):
                    fail(f"{kname} disagrees ({label}, T={tile})")
            del a, b
            torch.cuda.empty_cache()
    return worst


def band_tile_coords(nrows: int, ncols: int, lo: int, hi: int, rng, fill: float):
    """Row-major tile coords with lo <= col - row <= hi inside the grid; the
    two extreme diagonals are full, the others hold a share ``fill``."""
    r, c = np.meshgrid(np.arange(nrows), np.arange(ncols), indexing="ij")
    d = c - r
    keep = (d >= lo) & (d <= hi) & ((d == lo) | (d == hi) | (rng.random(d.shape) < fill))
    return np.stack([r[keep], c[keep]], axis=1).astype(np.int64)


def check_new_kernel(name, label, tile, dtype, kernel, plain, stack, a, b, rng, worst):
    """One case of K3/K4/K5: the kernel twice (bitwise equal), against its
    plain version and against a host float64 recomputation of 6 sampled C
    tiles of the c-sorted ``stack`` it computes."""
    import torch

    f64 = dtype == torch.float64
    rtol = F64_RTOL if f64 else KERNEL_RTOL
    got, again, ref = kernel(), kernel(), plain()
    sync(a.device)
    n_c = got.shape[0]
    if got.dtype != (torch.float64 if f64 else torch.float32) or got.shape != ref.shape:
        fail(f"{name} output {tuple(got.shape)} {got.dtype} ({label}, T={tile})")
    err, rel = rel_err(got, ref)
    picks = np.sort(rng.choice(n_c, size=min(6, n_c), replace=False))
    herr, hrel = rel_err(got[picks].cpu(), torch.as_tensor(host_f64_tiles(a, b, stack, picks)))
    worst[name] = max(worst.get(name, 0.0), err, herr)
    same = bool(torch.equal(got, again))
    log(f"  {name} T={tile:3d} {str(dtype)[6:]:8s} {label:26s} max_abs_err={err:.3e} rel={rel:.2e}; "
        f"vs host float64 rel={hrel:.2e} (bound {rtol:.0e}); two launches bitwise equal: {same}")
    if not (rel <= rtol and hrel <= rtol and same):
        fail(f"{name} disagrees ({label}, T={tile}, {dtype})")


def phase_kernels_new(dev) -> dict:
    """K5 (band), K4 (grouped) and K3 (run-fused panel) against their plain
    versions and a host float64 recomputation, at every tile edge, on small
    plans that hit each kernel's traps; returns the worst absolute errors."""
    import torch

    from dbcsr_tpu_torch.mm.band import (
        band_matmul, band_matmul_plain, device_band_plan, plan_band,
    )
    from dbcsr_tpu_torch.mm.kernels import (
        device_group_plan, tile_stack_matmul_grouped, tile_stack_matmul_grouped_plain,
    )
    from dbcsr_tpu_torch.mm.panel import (
        device_panel_run_plan, plan_panel_runs, tile_stack_matmul_panel_runs,
        tile_stack_matmul_panel_runs_plain,
    )
    from dbcsr_tpu_torch.mm.tileplan import plan_tile_stacks_stores

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = {}

    def stores(n_a, n_b, tile, dtype):
        wide = torch.float64 if dtype == torch.float64 else torch.float32
        return tuple(
            torch.randn((n, tile, tile), generator=gen, device=dev, dtype=wide).to(dtype)
            for n in (n_a, n_b))

    # K5: (Mt, Kt, Nt, A diagonals, B diagonals, fill) — off_a < 0 on a
    # rectangular grid where k = m + off_a + d1 runs off both ends; off_a > 0;
    # a square band with holes
    band_cases = [("rect, off_a=-3", 12, 20, 15, (-3, 5), (-6, 2), 0.7),
                  ("rect tall, off_a=2", 21, 9, 14, (2, 4), (-5, -1), 1.0),
                  ("square with holes", 40, 40, 40, (-2, 2), (-2, 2), 0.5)]
    # K4, each way its rows reach the C store: group/cache small enough to
    # split C runs (padded rows, then the ordered segment sum); the engine's
    # defaults on 30 C tiles (the kernel writes the store, 2 padding rows
    # write nothing); ragged runs with empty C tiles (the kernel writes the
    # store, the slots no row produces must come out zero)
    stack_long = long_run_stack(rng, n_c=30, run=40, n_a=96, n_b=96)
    bstack, n_band = banded_tile_stack(mt=60, w=2)
    stack_ragged = ragged_stack(rng, 53, 96, 96)
    group_cases = [("runs of 40, group 4 cache 16", stack_long, 30, 96, 96, 4, 16, "split"),
                   ("runs of 40, group 8 cache 128", stack_long, 30, 96, 96, 8, 128, "padding"),
                   ("banded, group 8 cache 8", bstack, n_band, n_band, n_band, 8, 8, "split"),
                   ("ragged, group 8 cache 128", stack_ragged, 53, 96, 96, 8, 128, "unproduced")]
    on_poison = 0
    # K3: the banded stack with its column-major B numbering; n_c = 294 slots
    # in windows of 16 clamps the last group
    bc = np.asarray([(r, c) for r in range(60) for c in range(max(0, r - 2), min(60, r + 3))])
    cm = np.argsort(bc[:, 1] * 60 + bc[:, 0]).astype(np.int32)

    for tile in (128, 64, 32, 16):
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for label, mt, kt, nt, (alo, ahi), (blo, bhi), fill in band_cases:
                ac = band_tile_coords(mt, kt, alo, ahi, rng, fill)
                bcd = band_tile_coords(kt, nt, blo, bhi, rng, fill)
                tp = plan_tile_stacks_stores(ac, (mt, kt), bcd, (kt, nt))
                bp = plan_band(ac, (mt, kt), bcd, (kt, nt), tp.c_tile_keys, tile=tile)
                if bp is None or (label.startswith("rect,") and bp.off_a >= 0):
                    fail(f"band case {label!r} did not plan as intended")
                dp = device_band_plan(bp, dev)
                a, b = stores(len(ac), len(bcd), tile, dtype)
                check_new_kernel(
                    "K5", f"{label} Wa={bp.wa} Wb={bp.wb}", tile, dtype,
                    lambda: band_matmul(a, b, dp, out_dtype=None if dtype == torch.float64 else torch.float32),
                    lambda: band_matmul_plain(a, b, bp, out_dtype=None if dtype == torch.float64 else torch.float32),
                    tp.stack, a, b, rng, worst)
            for label, st, n_c, n_a, n_b, group, cache, way in group_cases:
                gp = device_group_plan(st, n_c, n_b, dev, group=group, cache=cache)
                n_rows = gp.n_groups * gp.group
                as_planned = {
                    "split": gp.split_runs > 0 and gp.join is not None,
                    "padding": gp.join is None and n_rows > n_c and not len(gp.zero_slots),
                    "unproduced": gp.join is None and len(gp.zero_slots) > 0,
                }[way]
                if not as_planned:
                    fail(f"grouped case {label!r} did not plan as {way}")
                a, b = stores(n_a, n_b, tile, dtype)
                out_dt = None if dtype == torch.float64 else torch.float32

                def k4():
                    # the kernel's output buffer comes from torch.empty: fill
                    # a buffer of its size with NaN and free it first, so that
                    # the allocator hands the kernel that memory and a tile
                    # it should have written or zeroed shows
                    nonlocal on_poison
                    n_out = n_c if gp.join is None else n_rows
                    poison = torch.full((n_out, tile, tile), float("nan"), device=dev,
                                        dtype=torch.float64 if dtype == torch.float64 else torch.float32)
                    ptr = poison.data_ptr()
                    del poison
                    out = tile_stack_matmul_grouped(a, b, gp, out_dtype=out_dt)
                    on_poison += gp.join is None and out.data_ptr() == ptr
                    return out

                check_new_kernel(
                    "K4", f"{label} [{way}]", tile, dtype, k4,
                    lambda: tile_stack_matmul_grouped_plain(a, b, gp, out_dtype=out_dt),
                    st, a, b, rng, worst)
                if way == "unproduced":
                    out = k4()
                    if bool(out[gp.zero_slots].any()):
                        fail(f"K4 left a C slot that no row produces non-zero (T={tile}, {dtype})")
            if dtype == torch.float64:
                continue  # K3 takes float32 and bfloat16, as K2
            for runlen in (2, 4):
                rp = plan_panel_runs(bstack, n_band, n_band, n_band, b_cm_perm=cm,
                                     c_win=16, a_cap=64, b_cap=64, chunk=4, runlen=runlen)
                if rp is None or rp.gstart[-1] % rp.c_win == 0:
                    fail("the banded case must give a run plan with a clamped last group")
                tiers = (rp.n_quads, rp.n_pairs, rp.n_singles)
                if runlen == 4 and min(tiers) == 0 or runlen == 2 and (rp.n_pairs or not rp.n_quads):
                    fail(f"run plan tiers {tiers} at runlen={runlen}")
                dp = device_panel_run_plan(rp, dev)
                a, b = stores(n_band, n_band, tile, dtype)
                check_new_kernel(
                    "K3", f"banded runlen={runlen} q/p/s={tiers[0]}/{tiers[1]}/{tiers[2]}",
                    tile, dtype,
                    lambda: tile_stack_matmul_panel_runs(a, b, dp, out_dtype=torch.float32),
                    lambda: tile_stack_matmul_panel_runs_plain(a, b, rp, out_dtype=torch.float32),
                    bstack, a, b, rng, worst)
    log(f"  K4: {on_poison} of its direct-write launches wrote a store on NaN-filled memory")
    if not on_poison:
        fail("K4's direct-write cases never ran on NaN-filled memory: the check is vacuous")
    return worst


def phase_kernels_jobs(dev) -> dict:
    """K5 and K3 in the pipelined routines (T = 128 and 64) where their Jobs
    could go wrong. K5: a band with holes planned over every band position of
    C, so that runs lose their first cell, their last, several in a row and,
    for some positions, every cell (a zero tile); negative ``off_a`` on a
    rectangular grid; float32, bf16 and float64. K3: ``runlen`` 2, 3 and 4
    with all three tiers, with and without ``cm_perm``, the clamped last
    group, and cells longer than the kernel's window of expanded pairs. Each
    against its plain version and a host float64 recomputation, twice
    (bitwise equal), and bitwise against the flat kernel of its type (K1; in
    float64 the float64 stack kernel) on its owned stack. Returns the worst
    absolute errors."""
    import torch

    from dbcsr_tpu_torch.mm.band import (
        band_matmul, band_matmul_plain, band_owned_stack, band_run_cells,
        device_band_plan, plan_band,
    )
    from dbcsr_tpu_torch.mm.f64_stack import tile_stack_matmul_f64
    from dbcsr_tpu_torch.mm.kernels import device_stack, stack_of_runs, tile_stack_matmul
    from dbcsr_tpu_torch.mm.panel import (
        device_panel_run_plan, panel_runs_owned_stack, plan_panel_runs,
        tile_stack_matmul_panel_runs, tile_stack_matmul_panel_runs_plain,
    )

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst = {}
    f32 = torch.float32

    def stores(n_a, n_b, tile, dtype):
        wide = torch.float64 if dtype == torch.float64 else f32
        return tuple(
            torch.randn((n, tile, tile), generator=gen, device=dev, dtype=wide).to(dtype)
            for n in (n_a, n_b))

    def flat_kernel(a, b, st, n_c):
        ds = device_stack(st, n_c, dev)
        if a.dtype == torch.float64:
            return tile_stack_matmul_f64(a, b, ds)
        return tile_stack_matmul(a, b, ds, out_dtype=f32)

    def holes(nr, nc, lo, hi, fill):
        """Band coords with every third tile of the extreme diagonals dropped
        and a share ``fill`` of the inner ones kept."""
        r, c = np.meshgrid(np.arange(nr), np.arange(nc), indexing="ij")
        d = c - r
        keep = (d >= lo) & (d <= hi) & np.where(
            (d == lo) | (d == hi), r % 3 != 1, rng.random(d.shape) < fill)
        return np.stack([r[keep], c[keep]], axis=1).astype(np.int64)

    # (label, Mt, Kt, Nt, A diagonals, B diagonals)
    band_cases = [("square, holes", 40, 40, 40, (-2, 2), (-1, 2)),
                  ("rect, off_a=-3, holes", 12, 20, 15, (-3, 5), (-6, 2))]
    for label, mt, kt, nt, (alo, ahi), (blo, bhi) in band_cases:
        ac, bcd = holes(mt, kt, alo, ahi, 0.6), holes(kt, nt, blo, bhi, 0.6)
        r, c = np.meshgrid(np.arange(mt), np.arange(nt), indexing="ij")
        keys = np.sort((r * nt + c)[(c - r >= alo + blo) & (c - r <= ahi + bhi)]).astype(np.int64)
        bp = plan_band(ac, (mt, kt), bcd, (kt, nt), keys, tile=128)
        if bp is None or (label.startswith("rect") and bp.off_a >= 0):
            fail(f"band case {label!r} did not plan as intended")
        run, a_cell, b_cell = band_run_cells(bp)
        absent = run & ((a_cell < 0) | (b_cell < 0))
        some = (run & ~absent).any(axis=1)
        first = np.array([absent[i, run[i]][0] for i in range(len(run))])
        last = np.array([absent[i, run[i]][-1] for i in range(len(run))])
        in_a_row = (absent[:, 1:] & absent[:, :-1]).any(axis=1)
        empty = np.flatnonzero(~some)
        counts = (int((some & first).sum()), int((some & last).sum()),
                  int((some & in_a_row).sum()), len(empty))
        log(f"  K5 {label}: Wa={bp.wa} Wb={bp.wb} off_a={bp.off_a}, {len(run)} C positions; runs "
            f"with an absent cell first / last / two in a row: {counts[0]} / {counts[1]} / "
            f"{counts[2]}; runs with no present cell: {counts[3]}")
        if min(counts) == 0:
            fail(f"band case {label!r} misses one of the absent-cell cases: {counts}")
        owned = stack_of_runs(*band_owned_stack(bp))
        dp = device_band_plan(bp, dev)
        for tile in (128, 64):
            for dtype in (f32, torch.bfloat16, torch.float64):
                a, b = stores(len(ac), len(bcd), tile, dtype)
                out_dt = torch.float64 if dtype == torch.float64 else f32

                def k5():
                    # as K4's check: the store may land on NaN-filled memory,
                    # so a zero tile that was never written shows
                    poison = torch.full((len(run), tile, tile), float("nan"), device=dev,
                                        dtype=out_dt)
                    del poison
                    return band_matmul(a, b, dp, out_dtype=out_dt)

                check_new_kernel("K5", label, tile, dtype, k5,
                                 lambda: band_matmul_plain(a, b, bp, out_dtype=out_dt),
                                 owned, a, b, rng, worst)
                got = k5()
                same = bool(torch.equal(got, flat_kernel(a, b, owned, len(run))))
                zero = not bool(got[empty].any())
                log(f"     == {'the float64 stack kernel' if dtype == torch.float64 else 'K1'} "
                    f"on band_owned_stack bitwise: {same}; the {len(empty)} runs with no "
                    f"present cell are zero tiles: {zero}")
                if not (same and zero):
                    fail(f"K5 ({label}, T={tile}, {dtype}): flat kernel bitwise {same}, zero tiles {zero}")

    # K3: the banded stack of phase_kernels_new (n_c = 294, clamped last group)
    bstack, n_band = banded_tile_stack(mt=60, w=2)
    bc = np.asarray([(r, c) for r in range(60) for c in range(max(0, r - 2), min(60, r + 3))])
    cm = np.argsort(bc[:, 1] * 60 + bc[:, 0]).astype(np.int32)
    long_cells = long_run_stack(rng, 21, 150, 96, 96)
    k3_cases = [(f"banded runlen={rl} {'cm_perm' if perm is not None else 'no cm_perm'}",
                 bstack, n_band, n_band, dict(b_cm_perm=perm, c_win=16, a_cap=64, b_cap=64,
                                              chunk=4, runlen=rl))
                for rl in (2, 3, 4) for perm in (cm, None)]
    k3_cases.append(("cells of 150 products, runlen=4", long_cells, 21, 96,
                     dict(c_win=16, a_cap=96, b_cap=96, chunk=1, runlen=4)))
    for label, st, n_c, n_store, kw in k3_cases:
        rp = plan_panel_runs(st, n_c, n_store, n_store, **kw)
        if rp is None or rp.gstart[-1] % rp.c_win == 0:
            fail(f"K3 case {label!r} must plan with a clamped last group")
        tiers = (rp.n_quads, rp.n_pairs, rp.n_singles)
        if kw.get("b_cm_perm") is not None and (
                not rp.n_quads or not rp.n_singles or (rp.n_pairs > 0) != (kw["runlen"] > 2)):
            fail(f"run plan tiers {tiers} ({label})")
        owned = stack_of_runs(*panel_runs_owned_stack(rp))
        dp = device_panel_run_plan(rp, dev)
        for tile in (128, 64):
            for dtype in (f32, torch.bfloat16):
                a, b = stores(n_store, n_store, tile, dtype)
                check_new_kernel(
                    "K3", f"{label} q/p/s={tiers[0]}/{tiers[1]}/{tiers[2]}", tile, dtype,
                    lambda: tile_stack_matmul_panel_runs(a, b, dp, out_dtype=f32),
                    lambda: tile_stack_matmul_panel_runs_plain(a, b, rp, out_dtype=f32),
                    owned, a, b, rng, worst)
                same = bool(torch.equal(tile_stack_matmul_panel_runs(a, b, dp, out_dtype=f32),
                                        flat_kernel(a, b, owned, n_c)))
                log(f"     == K1 on panel_runs_owned_stack bitwise: {same}")
                if not same:
                    fail(f"K3 and K1 differ on K3's owned stack ({label}, T={tile}, {dtype})")
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main path at 400,000 rows
# ---------------------------------------------------------------------------

def banded_scf_matrices(nrows: int, dev, seed: int = 0, *, dtype=None,
                        decay: float = 0.0, n_variants: int = 1):
    """The banded SCF shape of bench.py (blocks of 5/13/23, band of ±12
    blocks at 50% fill) with data made in store form on the device. With
    ``decay``, every element of block (bi, bj) is scaled by
    exp(-decay·|bi-bj|) as in bench.py's filtered configuration.
    Returns A, B = A·0.5 and ``n_variants`` A stores (the first is A's;
    the others are new draws over the same pattern). A complex ``dtype``
    draws complex normal data (real and imaginary parts of variance 1/2)."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import valid_mask

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    rbs = dt.random_block_sizes(nrows, [5, 13, 23], rng)
    n = len(rbs)
    i = np.repeat(np.arange(n, dtype=np.int64), 25)
    j = i + np.tile(np.arange(-12, 13, dtype=np.int64), n)
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.5)
    idx, _ = dt.build_index(i[keep], j[keep], rbs, rbs)
    lay = store_layout(idx, 128)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    real = dtype.to_real()  # the scale's type: real for complex data
    scale = valid_mask(idx, 128, dev).to(real)
    if decay:
        offs = np.concatenate(([0], np.cumsum(rbs.astype(np.int64))))
        blk_of = torch.as_tensor(
            np.searchsorted(offs, np.arange(offs[-1]), side="right") - 1, device=dev)
        ar = np.arange(128)
        er = np.minimum(lay.tile_coords[:, 0, None].astype(np.int64) * 128 + ar, offs[-1] - 1)
        ec = np.minimum(lay.tile_coords[:, 1, None].astype(np.int64) * 128 + ar, offs[-1] - 1)
        bi = blk_of[torch.as_tensor(er, device=dev)]
        bj = blk_of[torch.as_tensor(ec, device=dev)]
        scale = scale * torch.exp(-decay * (bi[:, :, None] - bj[:, None, :]).abs().to(real))
        del bi, bj
    stores = []
    for _ in range(n_variants):
        stores.append(torch.randn((lay.n_tiles, 128, 128), generator=gen, device=dev,
                                  dtype=dtype) * scale)
    a = dt.BCSRMatrix(name="A", index=idx, data=stores[0])
    b = dt.BCSRMatrix(name="B", index=idx, data=stores[0] * 0.5)
    return a, b, stores


def plain_of(plan, a_data, b_data):
    """The plain version of the executor's kernel on the same inputs."""
    import torch

    from dbcsr_tpu_torch.mm.band import band_matmul_plain
    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c_plain
    from dbcsr_tpu_torch.mm.f64_stack import tile_stack_matmul_f64_plain
    from dbcsr_tpu_torch.mm.kernels import (
        tile_stack_matmul_grouped_plain, tile_stack_matmul_plain,
    )
    from dbcsr_tpu_torch.mm.panel import (
        tile_stack_matmul_panel_plain, tile_stack_matmul_panel_runs_plain,
    )

    a_st, b_st = plan.op_stores(a_data, b_data)
    a_in, b_in = a_st.to(plan.in_dtype), b_st.to(plan.in_dtype)
    # the sums' type: float64 stores stay float64 (K4 and K5 take them)
    acc = torch.float64 if plan.in_dtype == torch.float64 else torch.float32
    if plan.route == "f64_stack":
        return tile_stack_matmul_f64_plain(a_in, b_in, plan.stack)
    if plan.route == "c_stack":
        return tile_stack_matmul_c_plain(a_in, b_in, plan.stack)
    if plan.route == "panel":
        return tile_stack_matmul_panel_plain(a_in, b_in, plan.panel.plan, out_dtype=acc)
    if plan.route == "panel_runs":
        return tile_stack_matmul_panel_runs_plain(a_in, b_in, plan.panel.plan, out_dtype=acc)
    if plan.route == "band":
        return band_matmul_plain(a_in, b_in, plan.band.plan, out_dtype=acc)
    if plan.route == "grouped":
        return tile_stack_matmul_grouped_plain(a_in, b_in, plan.grouped, out_dtype=acc)
    return tile_stack_matmul_plain(a_in, b_in, plan.stack, out_dtype=acc)


def sampled_f64_tiles(plan, c_index, a_data, b_data, n_samples=64, seed=1):
    """``n_samples`` C slots drawn from ``seed`` and a float64 host
    recomputation of their tiles from the kernel's own inputs (so the bound
    is the kernel's accumulation only)."""
    import torch

    from dbcsr_tpu_torch.block.store import store_layout

    tp = plan.tile_plan
    c_keys = store_layout(c_index, a_data.shape[1]).tile_keys()
    prod_of = plan.align_map(c_keys)  # C slot -> product tile of the plan
    present = np.flatnonzero(prod_of >= 0)
    picks = np.sort(np.random.default_rng(seed).choice(
        present, size=min(n_samples, len(present)), replace=False))
    a_st, b_st = plan.op_stores(a_data, b_data)  # as the plan's stack indexes them
    ref = host_f64_tiles(a_st, b_st, tp.stack, prod_of[picks], plan.in_dtype)
    return picks, torch.as_tensor(ref)


def sampled_f64_check(plan, out, c_index, a_data, b_data, n_samples=64, seed=1):
    """float64 host recomputation of sampled C tiles against ``out``'s."""
    picks, ref = sampled_f64_tiles(plan, c_index, a_data, b_data, n_samples, seed)
    return rel_err(out[picks].cpu(), ref)


def phase_main_path(dev, nrows: int):
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles
    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul
    from dbcsr_tpu_torch.mm.panel import tile_stack_matmul_panel
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    t0 = time.perf_counter()
    a, b, _ = banded_scf_matrices(nrows, dev)
    sync(dev)
    PHASE4["setup_s"] = time.perf_counter() - t0
    log(f"  banded SCF shape: {nrows} rows, {a.nblkrows} block rows, "
        f"{a.nblks} blocks, A/B {a.data.shape[0]} tiles of 128² "
        f"({a.data.numel() * 4 / 1e9:.2f} GB f32 each); set-up {time.perf_counter() - t0:.1f} s")

    execs = {}
    for prec in ("highest", "default"):
        for driver in ("auto", "stack"):
            get_plan_cache().clear()  # a cold build, as phase 18b's
            t0 = time.perf_counter()
            with dt.config_override(matmul_precision=prec, mm_driver=driver):
                fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b)
            tp = fn.plan.tile_plan
            PHASE4[(prec, driver)] = time.perf_counter() - t0
            log(f"  executor {driver:5s} @ {prec:7s}: route={fn.plan.route} "
                f"kernel inputs {str(fn.plan.in_dtype)[6:]}, S={len(tp.stack)}, "
                f"planned C tiles {tp.n_c_tiles} (C index "
                f"{store_layout(c_index, 128).n_tiles}), plan {time.perf_counter() - t0:.1f} s")
            execs[(prec, driver)] = (fn, c_index, eff)
    if execs[("highest", "auto")][0].plan.route != "panel":
        fail("auto did not choose the panel route on the banded SCF shape")
    pp = execs[("highest", "auto")][0].plan.panel.plan
    log(f"  panel plan: {pp.n_groups} groups of {pp.c_win}, traffic ratio "
        f"{pp.traffic_ratio:.3f}, caps a={pp.a_cap} b={pp.b_cap} chunk={pp.chunk}")

    # --- the main-path run: counters reset just before, read just after ---
    tile_stack_matmul.launches = 0
    tile_stack_matmul_panel.launches = 0
    outs = {}
    for key, (fn, _, _) in execs.items():
        k1, k2 = tile_stack_matmul.launches, tile_stack_matmul_panel.launches
        outs[key] = fn(a.data, b.data)
        d1 = tile_stack_matmul.launches - k1
        d2 = tile_stack_matmul_panel.launches - k2
        if key[1] == "auto" and not (d2 >= 1 and d1 == 0):
            fail(f"auto at {key[0]}: K2 launches {d2}, K1 launches {d1}")
        if key[1] == "stack" and not d1 >= 1:
            fail(f"mm_driver='stack' at {key[0]}: K1 launches {d1}")
    sync(dev)
    launches = {"K1": tile_stack_matmul.launches, "K2": tile_stack_matmul_panel.launches}
    log(f"  main-path launches: K1 {launches['K1']}, K2 {launches['K2']}")
    for prec in ("highest", "default"):
        # one routine, one FFMA chain per C element: the flat and the panel
        # route agree bit for bit where they take the same input type
        if execs[(prec, "auto")][0].plan.in_dtype != execs[(prec, "stack")][0].plan.in_dtype:
            if prec == "highest":
                fail("the flat and panel routes take different input types at 'highest'")
            continue
        same = bool(torch.equal(outs[(prec, "auto")], outs[(prec, "stack")]))
        log(f"  K1 == K2 bitwise at {nrows} rows @ {prec}: {same}")
        if not same:
            fail(f"K1 and K2 differ at {nrows} rows @ {prec}")

    errs = {}
    for key, (fn, c_index, _) in execs.items():
        out = outs[key]
        n_c = store_layout(c_index, 128).n_tiles
        if tuple(out.shape) != (n_c, 128, 128) or out.dtype != torch.float32:
            fail(f"{key}: output {tuple(out.shape)} {out.dtype}, expected ({n_c}, 128, 128) f32")
        # the product tiles, aligned to C's tiles as the executor aligns them
        ref = take_tiles(
            plain_of(fn.plan, a.data, b.data),
            fn.plan.align_map(store_layout(c_index, 128).tile_keys()), 128,
        )
        sync(dev)
        err, rel = rel_err(out, ref)
        serr, srel = sampled_f64_check(fn.plan, out, c_index, a.data, b.data)
        errs[key] = err
        log(f"  {key[1]:5s} @ {key[0]:7s}: vs plain max_abs_err={err:.3e} rel={rel:.2e}; "
            f"vs float64 (64 tiles) max_abs_err={serr:.3e} rel={srel:.2e} "
            f"(bound {KERNEL_RTOL:.0e})")
        if not (rel <= KERNEL_RTOL and srel <= KERNEL_RTOL):
            fail(f"main path {key} disagrees with its references")
        del ref
    return a, b, execs, launches, errs, outs[("highest", "auto")]


# ---------------------------------------------------------------------------
# phase 5: one-shot multiply through the dense path
# ---------------------------------------------------------------------------

def phase_dense(dev) -> None:
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul
    from dbcsr_tpu_torch.mm.panel import tile_stack_matmul_panel

    rng = np.random.default_rng(0)
    bs = np.full(2208 // 23, 23, dtype=np.int32)
    a = dt.random_matrix(bs, bs, 0.8, rng, device=dev, name="A")
    b = dt.random_matrix(bs, bs, 0.8, rng, device=dev, name="B")
    c = dt.random_matrix(bs, bs, 0.8, rng, device=dev, name="C")
    alpha, beta = 0.5, 2.0
    ref = (alpha * (a.to_dense().double() @ b.to_dense().double().T)
           + beta * c.to_dense().double())
    for prec in ("highest", "default"):
        k1, k2 = tile_stack_matmul.launches, tile_stack_matmul_panel.launches
        with dt.config_override(matmul_precision=prec):
            out = dt.multiply("N", "T", alpha, a, b, beta, c)
        got = out.to_dense()
        sync(dev)
        if tuple(got.shape) != (2208, 2208):
            fail(f"dense multiply shape {tuple(got.shape)}")
        if (tile_stack_matmul.launches, tile_stack_matmul_panel.launches) != (k1, k2):
            fail("the H2O shape should take the dense path, not a stack kernel")
        err, rel = rel_err(got, ref)
        log(f"  H2O 2208³ N,T @ {prec:7s}: vs float64 max_abs_err={err:.3e} "
            f"rel={rel:.2e} (bound {DENSE_RTOL[prec]:.0e})")
        if not rel <= DENSE_RTOL[prec]:
            fail(f"dense multiply at {prec} disagrees with float64")


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------

def kernel_of(plan):
    """The executor's stack kernel alone, on op stores already in the
    kernel's input dtype (no conversion, no alignment)."""
    import torch

    from dbcsr_tpu_torch.mm.band import band_matmul
    from dbcsr_tpu_torch.mm.c_stack import tile_stack_matmul_c
    from dbcsr_tpu_torch.mm.f64_stack import tile_stack_matmul_f64
    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul, tile_stack_matmul_grouped
    from dbcsr_tpu_torch.mm.panel import (
        tile_stack_matmul_panel, tile_stack_matmul_panel_runs,
    )

    # the sums' type: float64 stores stay float64 (K4 and K5 take them)
    acc = torch.float64 if plan.in_dtype == torch.float64 else torch.float32
    if plan.route == "f64_stack":
        return lambda x, y: tile_stack_matmul_f64(x, y, plan.stack)
    if plan.route == "c_stack":
        return lambda x, y: tile_stack_matmul_c(x, y, plan.stack)
    if plan.route == "panel":
        return lambda x, y: tile_stack_matmul_panel(x, y, plan.panel, out_dtype=acc)
    if plan.route == "panel_runs":
        return lambda x, y: tile_stack_matmul_panel_runs(x, y, plan.panel, out_dtype=acc)
    if plan.route == "band":
        return lambda x, y: band_matmul(x, y, plan.band, out_dtype=acc)
    if plan.route == "grouped":  # the kernel and the join of its padded rows
        return lambda x, y: tile_stack_matmul_grouped(x, y, plan.grouped, out_dtype=acc)
    return lambda x, y: tile_stack_matmul(x, y, plan.stack, out_dtype=acc)


def phase_times(a, b, execs, card: str) -> dict:
    rows = {}
    log(f"  card: {card}")
    log(f"  {'executor':16s} {'exec ms':>9s} {'kernel ms':>10s} {'plain ms':>9s} "
        f"{'eff GF/s':>9s} {'hw GF/s':>9s} {'plain hw GF/s':>13s}")
    for (prec, driver), (fn, _, eff) in execs.items():
        plan = fn.plan
        hw = plan.hw_flops
        a_in, b_in = a.data.to(plan.in_dtype), b.data.to(plan.in_dtype)
        kern = kernel_of(plan)

        def kernel():
            kern(a_in, b_in)
        # plain, kernel, executor, kernel, plain: compare within one call
        p1 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
        k1 = cuda_median_ms(kernel, reps=10)
        ex = cuda_median_ms(lambda: fn(a.data, b.data), reps=10)
        k2 = cuda_median_ms(kernel, reps=10)
        p2 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
        km, pm = float(np.median([k1, k2])), float(np.median([p1, p2]))
        rows[(prec, driver)] = {"route": plan.route, "exec_ms": ex, "kernel_ms": km,
                                "plain_ms": pm, "eff_flops": eff, "hw_flops": hw}
        log(f"  {driver + '@' + prec:16s} {ex:9.3f} {km:10.3f} {pm:9.3f} "
            f"{eff / ex / 1e6:9.1f} {hw / km / 1e6:9.1f} {hw / pm / 1e6:13.1f}"
            f"   [{plan.route}, kernel runs {k1:.3f}/{k2:.3f}, plain runs {p1:.3f}/{p2:.3f}]")
        log("  " + rate_line(f"{plan.route} kernel", km, plan_counts(a, b, plan), "float32"))
    return rows


def plan_counts(a, b, plan) -> tuple:
    """(A tiles, B tiles, planned C tiles, tile products) of an executor."""
    tp = plan.tile_plan
    return a.data.shape[0], b.data.shape[0], tp.n_c_tiles, len(tp.stack)


def rate_line(what: str, ms: float, counts: tuple, dtype: str) -> str:
    """A kernel's TFLOP/s of tile products done and its share of the bound."""
    size = 8 if dtype == "float64" else 4
    bound_ms, bound_by = kernel_bound(*counts, 128, size, size, dtype)
    return (f"{what}: {ms:.3f} ms = {2.0 * counts[3] * 128**3 / ms / 1e9:.1f} TFLOP/s, "
            f"bound {bound_ms:.3f} ms by {bound_by}: {bound_ms / ms:.1%} of it")


def phase_steady_state(dev) -> None:
    """K1, K2 and the float64 kernel on synthetic stacks whose 64 operand
    tiles stay in L2: runs of 32 (the inner loop's own rate: prologue and
    epilogue are 3% of a C tile) against runs of 1 (one tile product a C
    tile: what a C tile costs beyond its products)."""
    import torch

    from dbcsr_tpu_torch.mm.f64_stack import tile_stack_matmul_f64
    from dbcsr_tpu_torch.mm.kernels import device_stack, tile_stack_matmul
    from dbcsr_tpu_torch.mm.panel import (
        device_panel_plan, plan_panel_stack, tile_stack_matmul_panel,
    )

    rng = np.random.default_rng(6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x32 = torch.randn((64, 128, 128), device=dev)
    x64 = x32.double()
    for run, per_sm in ((32, 8), (1, 128)):
        n_c = sms * per_sm
        st = long_run_stack(rng, n_c, run, 64, 64)
        ds = device_stack(st, n_c, dev)
        dp = device_panel_plan(
            plan_panel_stack(st, n_c, 64, 64, c_win=16, a_cap=64, b_cap=64, chunk=1), dev)
        ms = {"K1": cuda_median_ms(lambda: tile_stack_matmul(x32, x32, ds), reps=5),
              "K2": cuda_median_ms(lambda: tile_stack_matmul_panel(x32, x32, dp), reps=5),
              "float64": cuda_median_ms(lambda: tile_stack_matmul_f64(x64, x64, ds), reps=5)}
        flop = 2.0 * len(st) * 128**3
        log(f"  {n_c} C tiles, runs of {run:2d} over 64 tiles: " + ", ".join(
            f"{k} {flop / t / 1e9:.1f} TFLOP/s ({t / n_c * sms * 1e3:.2f} us a C tile an SM)"
            for k, t in ms.items()))


# ---------------------------------------------------------------------------
# phase 7: the filtered SCF path (float64, then float32)
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    from dbcsr_tpu_torch.mm import reset_kernel_launches

    reset_kernel_launches()


def read_launches() -> dict:
    """Every kernel's launches since the last reset, by kernel (K1-K5, K6 =
    the float64 stack kernel, KC1, KC2)."""
    from dbcsr_tpu_torch.mm import kernel_launches

    return kernel_launches()


def phase_filtered(dev, a, b, variants, rtol: float, timing: bool = True) -> dict:
    """``build_filtered_executor`` over the data variants of A: float64
    steps must run the float64 kernel (K6's port), float32 steps K2. Each
    step is held against the same step through the kernel's plain version,
    the superset product against a host float64 recomputation of sampled
    tiles, and ``compact()`` against the one-shot filtered ``multiply``."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import apply_tile_gather, tile_gather

    f64 = a.dtype == torch.float64
    name = "float64" if f64 else "float32"
    t0 = time.perf_counter()
    ex = dt.build_filtered_executor("N", "N", a, b, FILTER_EPS)
    sync(dev)
    plan = ex.fn.plan
    n_sup = store_layout(ex.c_index, 128).n_tiles
    log(f"  {name}: filtered executor route={plan.route}, superset C "
        f"{ex.c_index.nblks} blocks in {n_sup} tiles ({n_sup * 128 * 128 * a.data.element_size() / 1e9:.2f} GB), "
        f"S={len(plan.tile_plan.stack)}, {plan.hw_flops / 1e9:.1f} GFLOP of tile products, "
        f"plan {time.perf_counter() - t0:.1f} s")
    if plan.route != ("f64_stack" if f64 else "panel"):
        fail(f"{name} filtered executor took route {plan.route}")
    gather = tile_gather(
        plan.align_map(store_layout(ex.c_index, 128).tile_keys()),
        len(plan.prod_keys), dev,
    )
    plain_ex = replace(ex, fn=lambda x, y: apply_tile_gather(plain_of(plan, x, y), gather))

    # --- this path's main-path run: counts set to 0 just before, read just after
    reset_launches()
    steps = [ex.step(v, b.data) for v in variants]
    sync(dev)
    launches = read_launches()
    log(f"  {name} main-path launches over {len(variants)} steps: {launches}")
    want = "K6" if f64 else "K2"
    if launches[want] != len(variants) or any(
            n for k, n in launches.items() if k != want):
        fail(f"{name} filtered steps: launches {launches}, expected {want} only")

    worst, shares = 0.0, []
    eps2 = np.float32(FILTER_EPS) ** 2
    for k, (v, (c, keep, nsq)) in enumerate(zip(variants, steps)):
        if (tuple(c.shape) != (n_sup, 128, 128) or c.dtype != a.dtype
                or tuple(keep.shape) != (ex.c_index.nblks,) or not bool(torch.isfinite(c).all())):
            fail(f"{name} step {k}: output {tuple(c.shape)} {c.dtype}, keep {tuple(keep.shape)}")
        pc, pkeep, _ = plain_ex.step(v, b.data)
        sync(dev)
        err, rel = rel_err(c, pc)
        worst = max(worst, err)
        differ = int((keep != pkeep).sum())
        share = float(keep.mean())
        shares.append(share)
        kept_nsq = nsq[keep > 0.5]
        log(f"  {name} step {k}: kept {int(keep.sum())} of {ex.c_index.nblks} blocks "
            f"(share {share:.4f}, {ex.kept_flops(keep) / ex.eff_flops:.4f} of the effective flops); "
            f"vs plain step: keep differs in {differ} blocks, max_abs_err={err:.3e} rel={rel:.2e} "
            f"(bound {rtol:.0e})")
        if differ or not rel <= rtol or not 0.0 < share < 1.0:
            fail(f"{name} step {k} disagrees with the plain step or filtered nothing")
        if kept_nsq.numel() and float(kept_nsq.min()) < eps2:
            fail(f"{name} step {k} kept a block below eps")
        del pc, pkeep
    sup = ex.fn(a.data, b.data)
    serr, srel = sampled_f64_check(plan, sup, ex.c_index, a.data, b.data)
    log(f"  {name} superset product vs float64 (64 tiles): max_abs_err={serr:.3e} "
        f"rel={srel:.2e} (bound {rtol:.0e})")
    if not srel <= rtol:
        fail(f"{name} superset product disagrees with float64")
    del sup

    # compact() of the last step against the one-shot filtered multiply
    c, keep, _ = steps[-1]
    a_last = a.with_data(variants[-1])
    one_s = []
    for _ in range(2):  # cold (plans the pattern), then warm
        t0 = time.perf_counter()
        one = dt.multiply("N", "N", 1.0, a_last, b, filter_eps=FILTER_EPS)
        sync(dev)
        one_s.append(time.perf_counter() - t0)
    comp = ex.compact(c, keep)
    same = (np.array_equal(one.index.row_ptr, comp.index.row_ptr)
            and np.array_equal(one.index.col_idx, comp.index.col_idx))
    cerr, crel = rel_err(comp.data, one.data) if same else (float("inf"),) * 2
    log(f"  {name} compact() vs one-shot multiply(filter_eps={FILTER_EPS:g}): same kept "
        f"blocks {same} ({comp.nblks} blocks), max_abs_err={cerr:.3e} rel={crel:.2e} "
        f"(bound {rtol:.0e}); one-shot {one_s[0]:.2f} s cold, {one_s[1]:.3f} s warm")
    if not (same and crel <= rtol):
        fail(f"{name} compact() disagrees with the one-shot filtered multiply")
    del steps, c, keep, comp, one

    tp = plan.tile_plan
    out = {"route": plan.route, "launches": launches[want], "max_abs_err": worst,
           "share": float(np.mean(shares)), "one_shot_s": one_s,
           "counts": (a.data.shape[0], b.data.shape[0], tp.n_c_tiles, len(tp.stack))}
    if not timing:
        return out
    kern = kernel_of(plan)
    a_in, b_in = a.data.to(plan.in_dtype), b.data.to(plan.in_dtype)
    # plain, kernel, step, superset product, kernel, plain: within one call
    p1 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
    k1 = cuda_median_ms(lambda: kern(a_in, b_in), reps=10)
    st = cuda_median_ms(lambda: ex.step(a.data, b.data), reps=10)
    fm = cuda_median_ms(lambda: ex.fn(a.data, b.data), reps=10)
    k2 = cuda_median_ms(lambda: kern(a_in, b_in), reps=10)
    p2 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
    km, pm = float(np.median([k1, k2])), float(np.median([p1, p2]))
    hw = plan.hw_flops
    log(f"  {name} times: step {st:.3f} ms = kernel {km:.3f} + alignment {fm - km:.3f} "
        f"+ norms and mask {st - fm:.3f}; plain kernel {pm:.3f} ms "
        f"[kernel runs {k1:.3f}/{k2:.3f}, plain runs {p1:.3f}/{p2:.3f}]")
    log(f"  {name} rates: kernel {hw / km / 1e6:.1f} GFLOP/s of tile products, plain "
        f"{hw / pm / 1e6:.1f}; step {ex.eff_flops / st / 1e6:.1f} GFLOP/s effective "
        f"({ex.eff_flops / 1e9:.1f} GFLOP of block products)")
    out.update(kernel_ms=km, plain_ms=pm, step_ms=st, fn_ms=fm)

    # Every kernel that takes this stack, on it, in the same run: the step's
    # own kernel, K4 through driver="grouped", K5 through driver="band" and,
    # in float32, K1 through driver="stack". They share one routine per type
    # (the blocked FFMA routine; the FP64 mma routine) and one run order, so
    # they must be bitwise equal to each other and twice to themselves. The
    # independent arithmetic is each kernel's plain version and a host
    # float64 recomputation of 64 sampled C tiles.
    def same_stack_kernel(driver):
        fn = dt.build_multiply_executor("N", "N", a, b, driver=driver)[0]
        if fn.plan.route != driver or len(fn.plan.tile_plan.stack) != len(tp.stack):
            fail(f"{name}: driver={driver!r} took route {fn.plan.route}")
        x, y = (v.to(fn.plan.in_dtype) for v in fn.plan.op_stores(a.data, b.data))
        k = kernel_of(fn.plan)
        return (lambda: k(x, y)), fn.plan

    peers = {("K6" if f64 else "K2"): ((lambda: kern(a_in, b_in)), plan),
             "K4": same_stack_kernel("grouped"), "K5": same_stack_kernel("band")}
    if not f64:
        peers["K1"] = same_stack_kernel("stack")
    picks = np.sort(np.random.default_rng(2).choice(tp.n_c_tiles, size=64, replace=False))
    host = torch.as_tensor(host_f64_tiles(*plan.op_stores(a.data, b.data), tp.stack, picks,
                                          plan.in_dtype))
    first = None
    for k, (run_k, plan_k) in peers.items():
        got = run_k()
        twice = bool(torch.equal(got, run_k()))
        first = got if first is None else first
        same = bool(torch.equal(got, first))
        hrel = rel_err(got[picks].cpu(), host)[1]
        ref = plain_of(plan_k, a.data, b.data)
        sync(dev)
        prel = rel_err(got, ref)[1]
        del got, ref
        n1 = cuda_median_ms(run_k, reps=10)
        n2 = cuda_median_ms(run_k, reps=10)
        nm = float(np.median([n1, n2]))
        log(f"  {name} {k} on the same stack: bitwise equal to {next(iter(peers))}: {same}; two "
            f"launches bitwise equal: {twice}; vs its plain version rel={prel:.2e}, vs host "
            f"float64 (64 tiles) rel={hrel:.2e} (bound {rtol:.0e}) [runs {n1:.3f}/{n2:.3f}]")
        log("  " + rate_line(f"{name} {k}", nm, out["counts"], name))
        if not (same and twice and prel <= rtol and hrel <= rtol):
            fail(f"{name}: {k} disagrees on the step's stack (bitwise with its peers: {same}, "
                 f"with itself: {twice}, plain rel {prel:.2e}, host rel {hrel:.2e})")
        out[f"{k}_ms"] = nm
    log(f"  {name} K5 {out['K5_ms']:.3f} ms; the sub-tile design it replaced read "
        f"{OLD_ROUTINE_MS['K5 ' + name]:.3f} ms on {OLD_ROUTINE_CARD}")
    return out


# ---------------------------------------------------------------------------
# phase 8: McWeeny purification on the card
# ---------------------------------------------------------------------------

def hamiltonian(dev, tile: int):
    """The symmetric banded float64 Hamiltonian of
    tests/test_purification.py (80 rows, blocks of 3 and 5, seed 42)."""
    import dbcsr_tpu_torch as dt

    rng = np.random.default_rng(42)
    sizes = dt.random_block_sizes(80, [3, 5], rng)
    n = len(sizes)
    bld = dt.BCSRBuilder(sizes, sizes, device=dev, name="H", dtype=np.float64,
                         sym="S", tile=tile)
    for i in range(n):
        for j in range(i, min(n, i + 3)):
            blk = 0.1 * rng.standard_normal((int(sizes[i]), int(sizes[j])))
            if i == j:
                blk = 0.5 * (blk + blk.T) + np.diag(np.linspace(-1, 1, int(sizes[i])))
            bld.put_block(i, j, blk)
    return bld.finalize()


def mcweeny(h, eps: float = 1e-9):
    """The loop of tests/test_purification.py: (projector, iterations,
    idempotency error, trace, electron count)."""
    import dbcsr_tpu_torch as dt

    evals = np.linalg.eigvalsh(dt.desymmetrize(h).to_dense().cpu().numpy())
    lo, hi = evals[0], evals[-1]
    mid = len(evals) // 2
    g = int(np.argmax(np.diff(evals[mid - 20: mid + 20])))
    mu = 0.5 * (evals[mid - 20 + g] + evals[mid - 20 + g + 1])
    s = max(hi - mu, mu - lo)
    p = dt.add_on_diag(dt.scale(dt.desymmetrize(h), -0.5 / s), 0.5 + 0.5 * mu / s)
    iters = 0
    for _ in range(40):
        iters += 1
        p2 = dt.multiply("N", "N", 1.0, p, p, filter_eps=eps)
        p3 = dt.multiply("N", "N", 1.0, p2, p, filter_eps=eps)
        p_next = dt.add(3.0, p2, -2.0, p3)
        delta = dt.norm_frobenius(dt.add(1.0, p_next, -1.0, p))
        p = dt.filter_blocks(p_next, eps)
        if delta < 1e-11:
            break
    p2 = dt.multiply("N", "N", 1.0, p, p)
    idem = dt.norm_frobenius(dt.add(1.0, p2, -1.0, p))
    return p, iters, idem, dt.trace(p), int((evals < mu).sum())


def phase_mcweeny(dev) -> int:
    import torch

    import dbcsr_tpu_torch as dt

    with dt.config_override(mm_driver="stack"):
        p_cpu, it_cpu, _, _, _ = mcweeny(hamiltonian(torch.device("cpu"), 16))
        h = hamiltonian(dev, 16)
        reset_launches()
        t0 = time.perf_counter()
        p, iters, idem, tr, ne = mcweeny(h)
        sync(dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
    same = (np.array_equal(p.index.row_ptr, p_cpu.index.row_ptr)
            and np.array_equal(p.index.col_idx, p_cpu.index.col_idx))
    err, rel = rel_err(p.to_dense().cpu(), p_cpu.to_dense()) if same else (float("inf"),) * 2
    log(f"  McWeeny (80 rows, T=16, stack driver): {iters} iterations in {seconds:.2f} s, "
        f"|P²-P|_F={idem:.2e} (bound 1e-8), trace {tr:.9f} vs {ne} electrons (bound 1e-6), "
        f"{p.nblks} blocks; launches {launches}")
    log(f"  vs the same loop on CPU tensors: {it_cpu} iterations, same pattern {same}, "
        f"max_abs_err={err:.3e} rel={rel:.2e} (bound 1e-10)")
    if not (idem < 1e-8 and abs(tr - ne) < 1e-6):
        fail("McWeeny on the card missed the reference test's assertions")
    if not (iters == it_cpu and same and rel <= 1e-10):
        fail("McWeeny on the card differs from the same loop on CPU tensors")
    if launches["K6"] == 0 or any(n for k, n in launches.items() if k != "K6"):
        fail(f"McWeeny products should run the float64 kernel only: {launches}")
    return launches["K6"]


# ---------------------------------------------------------------------------
# phase 9: the band, grouped and run-fused panel drivers; RCM reordering
# ---------------------------------------------------------------------------

def timed_plain_kernel_exec(fn, a, b, reps: int = 10) -> tuple:
    """CUDA-event medians (ms) of an executor, its kernel alone and the
    kernel's plain version, in the order plain, kernel, executor, kernel,
    plain, so that they are compared within one call."""
    plan = fn.plan
    a_st, b_st = plan.op_stores(a.data, b.data)
    a_in, b_in = a_st.to(plan.in_dtype), b_st.to(plan.in_dtype)
    kern = kernel_of(plan)
    p1 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
    k1 = cuda_median_ms(lambda: kern(a_in, b_in), reps=reps)
    ex = cuda_median_ms(lambda: fn(a.data, b.data), reps=reps)
    k2 = cuda_median_ms(lambda: kern(a_in, b_in), reps=reps)
    p2 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
    return ex, float(np.median([k1, k2])), float(np.median([p1, p2])), (k1, k2, p1, p2)


def phase_new_drivers(dev, a, b, panel_out) -> dict:
    """``driver="band"`` (K5), ``driver="grouped"`` (K4) and
    ``panel_runlen=4`` under ``driver="panel"`` (K3) at the phase-4 shape,
    float32 at "highest"; ``panel_out`` is phase 4's panel result."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles

    cases = {"K5": ("band", {}), "K4": ("grouped", {}), "K3": ("panel", {"panel_runlen": 4})}
    routes = {"K5": "band", "K4": "grouped", "K3": "panel_runs"}
    execs = {}
    for k, (driver, cfg) in cases.items():
        t0 = time.perf_counter()
        with dt.config_override(matmul_precision="highest", **cfg):
            fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b, driver=driver)
        secs = time.perf_counter() - t0
        plan = fn.plan
        if plan.route != routes[k]:
            fail(f"driver={driver!r} {cfg} took route {plan.route}, expected {routes[k]}")
        tp = plan.tile_plan
        if k == "K5":
            bp = plan.band.plan
            cells = bp.wa * bp.wb * bp.mt
            note = (f"Wa={bp.wa} Wb={bp.wb} off_a={bp.off_a} Mt={bp.mt}: {cells} padded "
                    f"diagonal cells, {len(tp.stack)} present ({cells / len(tp.stack):.2f}x), "
                    f"A band {int((bp.a_pack >= 0).sum())} of {len(bp.a_pack)} tiles present; "
                    f"hw_flops {plan.hw_flops / 1e9:.1f} GFLOP (padded), products done "
                    f"{2.0 * len(tp.stack) * 128**3 / 1e9:.1f} GFLOP")
        elif k == "K4":
            gp = plan.grouped
            note = (f"{gp.n_groups} groups of {gp.group} (cache {gp.cache}), "
                    f"{gp.n_groups * gp.group - gp.n_c} padding rows, {gp.split_runs} split C runs, "
                    f"{len(tp.stack)} entries load {gp.aload.numel()} A tiles "
                    f"(reuse {len(tp.stack) / max(gp.aload.numel(), 1):.2f}); "
                    f"rows reach C by: "
                    f"{'the kernel writing the store' if gp.join is None else type(gp.join).__name__}")
        else:
            rp = plan.panel.plan
            note = (f"{rp.n_groups} groups of {rp.c_win}, runlen {rp.runlen}: quads/pairs/singles "
                    f"{rp.n_quads}/{rp.n_pairs}/{rp.n_singles}, issue_ratio {rp.issue_ratio:.3f}, "
                    f"traffic ratio {rp.traffic_ratio:.3f}, caps a={rp.a_cap} b={rp.b_cap}")
        log(f"  {k} executor driver={driver} {cfg or ''}: route={plan.route}, plan {secs:.2f} s; {note}")
        execs[k] = (fn, c_index, eff)

    # --- this path's main-path run: counts set to 0 just before, read just after
    reset_launches()
    outs = {k: fn(a.data, b.data) for k, (fn, _, _) in execs.items()}
    sync(dev)
    launches = read_launches()
    log(f"  main-path launches: {launches}")
    if any(launches[k] != 1 for k in cases) or any(launches[k] for k in ("K1", "K2", "K6")):
        fail(f"each new driver must launch its own kernel once: {launches}")

    rows = {}
    for k, (fn, c_index, eff) in execs.items():
        out, plan = outs[k], fn.plan
        c_keys = store_layout(c_index, 128).tile_keys()
        if tuple(out.shape) != (len(c_keys), 128, 128) or out.dtype != torch.float32:
            fail(f"{k}: output {tuple(out.shape)} {out.dtype}")
        ref = take_tiles(plain_of(plan, a.data, b.data), plan.align_map(c_keys), 128)
        sync(dev)
        err, rel = rel_err(out, ref)
        del ref
        serr, srel = sampled_f64_check(plan, out, c_index, a.data, b.data)
        perr, prel = rel_err(out, panel_out)
        log(f"  {k} ({plan.route}): vs plain max_abs_err={err:.3e} rel={rel:.2e}; vs float64 "
            f"(64 tiles) rel={srel:.2e}; vs the panel route's result max_abs_err={perr:.3e} "
            f"rel={prel:.2e} (bound {KERNEL_RTOL:.0e})")
        if not (rel <= KERNEL_RTOL and srel <= KERNEL_RTOL and prel <= KERNEL_RTOL):
            fail(f"{k} ({plan.route}) disagrees with its references")
        ex, km, pm, runs = timed_plain_kernel_exec(fn, a, b)
        tp = plan.tile_plan
        done = 2.0 * len(tp.stack) * 128**3
        log(f"  {k} times: executor {ex:.3f} ms, kernel {km:.3f} ms "
            f"({done / km / 1e9:.1f} TFLOP/s of products done), plain {pm:.3f} ms "
            f"[kernel runs {runs[0]:.3f}/{runs[1]:.3f}, plain runs {runs[2]:.3f}/{runs[3]:.3f}]")
        if k == "K4":
            # no C run is split at this shape, so the kernel must write the C
            # store itself: no join, and no padded copy of C beside the store
            gp = plan.grouped
            if gp.join is not None:
                fail(f"K4 at the banded SCF shape: {gp.split_runs} split C runs, join "
                     f"{type(gp.join).__name__}; expected the kernel to write the C store")
            a_in, b_in = (x.to(plan.in_dtype) for x in plan.op_stores(a.data, b.data))
            kern = kernel_of(plan)
            sync(dev)
            peak_memory(dev)  # keep the run's peak across the reset
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            held = kern(a_in, b_in)
            sync(dev)
            grew = torch.cuda.max_memory_allocated(dev) - before
            store = held.numel() * held.element_size()
            del held, a_in, b_in
            log(f"  K4 kernel time = launch {km:.3f} ms + join 0.000 ms (the kernel wrote the C "
                f"store: {gp.n_groups * gp.group - gp.n_c + len(gp.zero_slots)} padding rows "
                f"wrote nothing, {len(gp.zero_slots)} C slots zeroed); device memory grew by "
                f"{grew / 1e9:.3f} GB for a C store of {store / 1e9:.3f} GB")
            if grew > 1.01 * store + (1 << 22):
                fail("K4 allocated more than the C store: a padded copy of C is back")
        rows[k] = {"launches": launches[k], "max_abs_err": max(err, serr), "ms": km,
                   "plain_ms": pm, "exec_ms": ex,
                   "counts": (a.data.shape[0], b.data.shape[0], tp.n_c_tiles, len(tp.stack))}
        if k != "K4":
            log("  " + rate_line(f"{k} kernel", km, rows[k]["counts"], "float32")
                + f"; the sub-tile design it replaced read {OLD_ROUTINE_MS[k + ' float32']:.3f} ms "
                f"on {OLD_ROUTINE_CARD}")
    del outs

    # K5 and K3 with bf16 inputs: the same executors at "default" (the band
    # route follows ``stack_bf16_inputs``, on by default; the panel routes
    # follow ``panel_bf16_inputs``, which is off by default)
    for k in ("K5", "K3"):
        driver, cfg = cases[k]
        with dt.config_override(matmul_precision="default", panel_bf16_inputs=True, **cfg):
            fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b, driver=driver)
        plan = fn.plan
        if plan.route != routes[k] or plan.in_dtype != torch.bfloat16:
            fail(f"{k} at 'default': route {plan.route}, kernel inputs {plan.in_dtype}")
        before = read_launches()[k]
        out = fn(a.data, b.data)
        sync(dev)
        if read_launches()[k] != before + 1:
            fail(f"{k} at 'default' did not launch its kernel")
        c_keys = store_layout(c_index, 128).tile_keys()
        ref = take_tiles(plain_of(plan, a.data, b.data), plan.align_map(c_keys), 128)
        sync(dev)
        err, rel = rel_err(out, ref)
        del ref
        serr, srel = sampled_f64_check(plan, out, c_index, a.data, b.data)
        del out
        ex, km, pm, runs = timed_plain_kernel_exec(fn, a, b)
        counts = rows[k]["counts"]
        log(f"  {k} bf16 inputs ({plan.route} @ default): vs plain max_abs_err={err:.3e} "
            f"rel={rel:.2e}; vs float64 of the bf16-rounded stores (64 tiles) rel={srel:.2e} "
            f"(bound {KERNEL_RTOL:.0e}); executor {ex:.3f} ms, kernel {km:.3f} ms, plain {pm:.3f} ms "
            f"[kernel runs {runs[0]:.3f}/{runs[1]:.3f}, plain runs {runs[2]:.3f}/{runs[3]:.3f}]")
        log("  " + rate_line(f"{k} bf16 kernel", km, counts, "float32"))
        if not (rel <= KERNEL_RTOL and srel <= KERNEL_RTOL):
            fail(f"{k} with bf16 inputs disagrees with its references")
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], err, serr)
        rows[k + " bf16"] = {"ms": km, "plain_ms": pm, "exec_ms": ex}
    return rows


def store_matrix(rows, cols, sizes, dev, seed: int, name: str, scale: float = 1.0):
    """A float32 matrix with the given blocks, its data made in store form
    on the device (random, zero outside the blocks)."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import valid_mask

    idx, _ = dt.build_index(rows, cols, sizes, sizes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = torch.randn((store_layout(idx, 128).n_tiles, 128, 128), generator=gen, device=dev)
    return dt.BCSRMatrix(name=name, index=idx, data=data * (scale * valid_mask(idx, 128, dev)))


def phase_scrambled_chain(dev, nrows: int) -> None:
    """bench.py's ``clustered`` leg: a hidden 1-D chain (blocks 5/13/23,
    coupling probability exp(-d/4) out to 15 blocks), block numbering
    scrambled by one random permutation. The executor with ``reorder`` "off"
    and "auto" (tile-level RCM), then the block level."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.autotune import coords_bandedness
    from dbcsr_tpu_torch.mm.reorder import locality_reorder_plan

    rng = np.random.default_rng(0)
    rbs = dt.random_block_sizes(nrows, [5, 13, 23], rng)
    n, dmax = len(rbs), 15
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * dmax + 1)
    off = np.tile(np.arange(-dmax, dmax + 1, dtype=np.int64), n)
    j = i + off
    keep = (j >= 0) & (j < n) & (rng.random(len(j)) < np.exp(-np.abs(off) / 4.0))
    sig = rng.permutation(n).astype(np.int64)
    rbs_s = np.empty(n, np.int32)
    rbs_s[sig] = rbs  # sizes follow their blocks through the scramble
    sr, sc = sig[i[keep]], sig[j[keep]]
    t0 = time.perf_counter()
    a0 = store_matrix(sr, sc, rbs_s, dev, 0, "A0")
    b0 = a0.with_data(a0.data * 0.5)
    sync(dev)
    lay = a0.layout
    log(f"  scrambled chain: {nrows} rows, {n} block rows, {a0.nblks} blocks in "
        f"{lay.n_tiles} tiles of a {lay.ntr}x{lay.ntc} grid "
        f"({a0.data.numel() * 4 / 1e9:.2f} GB per operand); set-up {time.perf_counter() - t0:.1f} s")

    fns = {}
    for mode in ("off", "auto"):
        t0 = time.perf_counter()
        with dt.config_override(reorder=mode):
            fns[mode] = dt.build_multiply_executor("N", "N", a0, b0)
        plan = fns[mode][0].plan
        tp = plan.tile_plan
        log(f"  reorder={mode!r}: route={plan.route} (reordered: {plan.reorder is not None}), "
            f"S={len(tp.stack)} ({2.0 * len(tp.stack) * 128**3 / 1e12:.2f} TFLOP), planned C tiles "
            f"{tp.n_c_tiles} ({tp.n_c_tiles * 65536 / 1e9:.1f} GB), plan {time.perf_counter() - t0:.1f} s")
    if fns["off"][0].plan.route != "stack":
        fail("the scrambled chain must decline the panel route with reorder='off'")
    p_auto = fns["auto"][0].plan
    if p_auto.route != "stack" or p_auto.reorder is not None:
        fail(f"the scrambled chain under reorder='auto': route {p_auto.route}, reordered "
             f"{p_auto.reorder is not None}; expected the gate to decline (flat kernel)")
    t0 = time.perf_counter()
    rp = locality_reorder_plan(lay.tile_coords, (lay.ntr, lay.ntc), lay.tile_coords,
                               (lay.ntr, lay.ntc))
    rcm_s = time.perf_counter() - t0
    log(f"  tile-level RCM plan: {rcm_s:.3f} s; bandedness of the tile coords "
        f"{coords_bandedness(lay.tile_coords[:, 0], lay.tile_coords[:, 1], lay.ntr):.3f} -> "
        f"{coords_bandedness(rp.a_coords[:, 0], rp.a_coords[:, 1], lay.ntr):.3f} after "
        f"renumbering (gate 0.05): at T=128 a tile row holds blocks of unrelated chain positions")
    if coords_bandedness(rp.a_coords[:, 0], rp.a_coords[:, 1], lay.ntr) >= 0.05:
        fail("the renumbered chain passes the bandedness gate, yet reorder='auto' declined")

    fn, c_index, eff = fns["off"]
    reset_launches()
    out = fn(a0.data, b0.data)
    sync(dev)
    launches = read_launches()
    serr, srel = sampled_f64_check(fn.plan, out, c_index, a0.data, b0.data, n_samples=16)
    ms = cuda_median_ms(lambda: fn(a0.data, b0.data), reps=3, warmup=0)
    done = 2.0 * len(fn.plan.tile_plan.stack) * 128**3
    log(f"  reorder='off' executor (flat kernel, launches {launches}): {ms:.1f} ms "
        f"({done / ms / 1e9:.1f} TFLOP/s of tile products, {eff / ms / 1e6:.1f} GFLOP/s effective); "
        f"vs float64 (16 tiles) rel={srel:.2e} (bound {KERNEL_RTOL:.0e})")
    if launches["K1"] != 1 or not srel <= KERNEL_RTOL:
        fail("the scrambled chain's flat-kernel product is wrong or did not run K1")
    fn_on = fns["auto"][0]
    out_on = fn_on(a0.data, b0.data)
    sync(dev)
    err, rel = rel_err(out_on, out)
    log(f"  reorder='auto' executor (route {fn_on.plan.route}) vs reorder='off': "
        f"max_abs_err={err:.3e} rel={rel:.2e} (bound {KERNEL_RTOL:.0e})")
    if not rel <= KERNEL_RTOL:
        fail("reorder='auto' and reorder='off' disagree on the scrambled chain")
    del out_on, fns, fn_on
    c0 = dt.BCSRMatrix(name="C0", index=c_index, data=out)
    del out

    # the block level, as bench.py's leg does it
    t0 = time.perf_counter()
    pm, _, _ = dt.locality_block_permutation(a0.index)
    perm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ap, bp = dt.permute_blocks(a0, pm, pm), dt.permute_blocks(b0, pm, pm)
    sync(dev)
    log(f"  block-level RCM: permutation {perm_s:.3f} s, permute_blocks of A and B "
        f"{time.perf_counter() - t0:.1f} s; tiles {a0.layout.n_tiles} -> {ap.layout.n_tiles} "
        f"({a0.layout.n_tiles / ap.layout.n_tiles:.1f}x fewer)")
    fnp, cip, effp = dt.build_multiply_executor("N", "N", ap, bp)
    if fnp.plan.route != "panel":
        fail(f"the block-permuted chain took route {fnp.plan.route}, expected panel")
    reset_launches()
    outp = fnp(ap.data, bp.data)
    sync(dev)
    launches = read_launches()
    msp = cuda_median_ms(lambda: fnp(ap.data, bp.data), reps=10)
    t0 = time.perf_counter()
    want = dt.permute_blocks(c0, pm, pm)
    same = (np.array_equal(want.index.row_ptr, cip.row_ptr)
            and np.array_equal(want.index.col_idx, cip.col_idx))
    err, rel = rel_err(outp, want.data) if same else (float("inf"),) * 2
    log(f"  permuted operands: route=panel (launches {launches}), S={len(fnp.plan.tile_plan.stack)}, "
        f"executor {msp:.3f} ms ({ms / msp:.0f}x faster than scrambled); product of the permuted "
        f"matrices vs the permuted product ({c0.nblks} blocks, permute_blocks of C "
        f"{time.perf_counter() - t0:.1f} s): same pattern {same}, max_abs_err={err:.3e} "
        f"rel={rel:.2e} (bound {KERNEL_RTOL:.0e})")
    if launches["K2"] != 1 or not (same and rel <= KERNEL_RTOL):
        fail("the product of the permuted matrices is not the permuted product")


def phase_scrambled_tile_band(dev, n: int, w: int, **knobs) -> None:
    """A band of 128-blocks (|i-j| <= w) scrambled by three hidden
    permutations, as tests/test_reorder.py: the tile pattern is the block
    pattern, so the executor's tile-level RCM can recover it. At w = 2 the
    renumbered band's column spans (32 tiles) fit the default
    ``panel_cache`` of 48; at w = 3 they need 56, so that width runs under
    ``panel_cache=64`` given as ``knobs``."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.timing import timer_stats

    rng = np.random.default_rng(1)
    i = np.repeat(np.arange(n, dtype=np.int64), 2 * w + 1)
    j = i + np.tile(np.arange(-w, w + 1, dtype=np.int64), n)
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    sig_m, sig_k, sig_n = (rng.permutation(n).astype(np.int64) for _ in range(3))
    sizes = np.full(n, 128, np.int32)
    a = store_matrix(sig_m[i], sig_k[j], sizes, dev, 1, "A")
    b = store_matrix(sig_k[i], sig_n[j], sizes, dev, 2, "B", 0.5)
    sync(dev)
    log(f"  scrambled band of 128-blocks, +-{w}, knobs {knobs or 'default'}: {n * 128} rows, "
        f"{n} block rows, A/B {a.data.shape[0]} tiles ({a.data.numel() * 4 / 1e9:.2f} GB each)")
    res = {}
    for mode in ("off", "auto"):
        stat = timer_stats().get("multiply/reorder")
        rcm0 = stat.total_time if stat else 0.0
        t0 = time.perf_counter()
        with dt.config_override(reorder=mode, **knobs):
            fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b)
        secs = time.perf_counter() - t0
        plan = fn.plan
        reset_launches()
        out = fn(a.data, b.data)
        sync(dev)
        launches = read_launches()
        serr, srel = sampled_f64_check(plan, out, c_index, a.data, b.data)
        ex, km, pm, _ = timed_plain_kernel_exec(fn, a, b, reps=5)
        tp = plan.tile_plan
        extra = ""
        if plan.reorder is not None:
            pp = plan.panel.plan
            rcm = timer_stats()["multiply/reorder"].total_time - rcm0
            extra = (f"; RCM plan, replan and panel plan {rcm:.2f} s of the plan time: "
                     f"{pp.n_groups} groups, traffic ratio {pp.traffic_ratio:.3f}, "
                     f"caps a={pp.a_cap} b={pp.b_cap}")
        log(f"  reorder={mode!r}: route={plan.route} (reordered: {plan.reorder is not None}), "
            f"S={len(tp.stack)}, C tiles {tp.n_c_tiles}, plan {secs:.2f} s, launches {launches}; "
            f"executor {ex:.3f} ms, kernel {km:.3f} ms, plain {pm:.3f} ms; vs float64 (64 tiles) "
            f"rel={srel:.2e} (bound {KERNEL_RTOL:.0e}){extra}")
        if not srel <= KERNEL_RTOL:
            fail(f"scrambled band, reorder={mode!r}: the product disagrees with float64")
        res[mode] = (plan, out, launches, c_index)
    p_off, o_off, l_off, ci_off = res["off"]
    p_on, o_on, l_on, ci_on = res["auto"]
    if p_off.route != "stack" or l_off["K1"] != 1 or l_off["K2"]:
        fail(f"reorder='off' must run the flat kernel: route {p_off.route}, launches {l_off}")
    if p_on.route != "panel" or p_on.reorder is None or l_on["K2"] != 1 or l_on["K1"]:
        fail(f"reorder='auto' must take the panel route through the RCM plan: route "
             f"{p_on.route}, launches {l_on}")
    same = np.array_equal(ci_off.col_idx, ci_on.col_idx)
    err, rel = rel_err(o_on, o_off)
    log(f"  reorder='auto' (panel) vs reorder='off' (flat): same C index {same}, "
        f"max_abs_err={err:.3e} rel={rel:.2e} (bound {KERNEL_RTOL:.0e})")
    if not (same and rel <= KERNEL_RTOL):
        fail("the reordered panel product disagrees with the flat product")


# ---------------------------------------------------------------------------
# phase 11: the block-sparse tensor contraction
# ---------------------------------------------------------------------------

def ri_pattern(n_atoms: int, seed: int = 0):
    """Shape R, an RI-type 3-center contraction over one chain of atoms
    (CP2K's resolution-of-identity step C(μ,ν,Q) = Σ_P A(μ,ν,P)·B(P,Q)):
    one block per atom on every axis, AO and RI block sizes drawn in that
    order from bench.py's banded-SCF sizes {5, 13, 23}; A has a block where
    |μ-ν| ≤ 4 and |P - ⌊(μ+ν)/2⌋| ≤ 4, B where |P-Q| ≤ 8. Returns (AO
    sizes, RI sizes, A's block indices [n, 3], B's [n, 2]), row-major."""
    rng = np.random.default_rng(seed)
    ao = rng.choice([5, 13, 23], n_atoms).astype(np.int32)
    ri = rng.choice([5, 13, 23], n_atoms).astype(np.int32)
    mu, nu = (x.ravel() for x in np.meshgrid(np.arange(n_atoms), np.arange(n_atoms),
                                            indexing="ij"))
    near = np.abs(mu - nu) <= 4
    mu, nu = mu[near], nu[near]
    p = (mu + nu)[:, None] // 2 + np.arange(-4, 5)[None, :]
    ok = ((p >= 0) & (p < n_atoms)).ravel()
    a_idx = np.stack([np.repeat(mu, 9), np.repeat(nu, 9), p.ravel()], 1)[ok]
    pp, qq = (x.ravel() for x in np.meshgrid(np.arange(n_atoms), np.arange(n_atoms),
                                            indexing="ij"))
    band = np.abs(pp - qq) <= 8
    return ao, ri, a_idx.astype(np.int64), np.stack([pp[band], qq[band]], 1).astype(np.int64)


def folded_tensor(name, block_sizes, mapping, block_idx, dev, dtype, gen, tile=128):
    """A tensor whose blocks ``block_idx`` [n, ndim] hold standard normal
    data, made in store form on the device (``gen``: a torch generator
    there), folded by ``mapping``."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.tileops import valid_mask
    from dbcsr_tpu_torch.tensors import Tensor
    from dbcsr_tpu_torch.tensors.index import grouped_block_sizes

    bs = [np.asarray(b, dtype=np.int32) for b in block_sizes]
    rows, cols = mapping.fold(block_idx, [len(b) for b in bs])
    idx, _ = dt.build_index(rows, cols, grouped_block_sizes(bs, list(mapping.map1)),
                            grouped_block_sizes(bs, list(mapping.map2)))
    mask = valid_mask(idx, tile, dev).to(dtype)
    data = torch.randn(mask.shape, generator=gen, device=dev, dtype=dtype) * mask
    return Tensor(name=name, block_sizes=tuple(bs), mapping=mapping,
                  matrix=dt.BCSRMatrix(name=name, index=idx, data=data))


def ri_tensors(n_atoms: int, dev, dtype, seed: int = 0, tile: int = 128):
    """Shape R's A(μ,ν,P) and B(P,Q), each in the layout
    ``contraction_layouts`` gives for contract (2,)/(0,) and notcontract
    (0,1)/(1,)."""
    import torch

    from dbcsr_tpu_torch.tensors import contraction_layouts

    ao, ri, a_idx, b_idx = ri_pattern(n_atoms, seed)
    la, lb, _ = contraction_layouts(3, (2,), (0, 1), 2, (0,), (1,))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return (folded_tensor("A", [ao, ao, ri], la, a_idx, dev, dtype, gen, tile),
            folded_tensor("B", [ri, ri], lb, b_idx, dev, dtype, gen, tile))


def bench_tensor_pair(n_rows: int, dev, seed: int = 0):
    """Shape T: bench.py's tensor shape (``bench.py:417-439``: tall axis i in
    blocks of 5/13, j = k = l = 10 blocks of 8, A(i,j,k) at 15% and B(k,l)
    at 60% block occupancy) with i = ``n_rows`` elements, float32, in the
    contraction layouts."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.tensors import contraction_layouts

    rng = np.random.default_rng(seed)
    i_bs = dt.random_block_sizes(n_rows, [5, 13], rng)
    j_bs = k_bs = l_bs = np.full(10, 8, dtype=np.int32)
    la, lb, _ = contraction_layouts(3, (2,), (0, 1), 2, (0,), (1,))
    a_nb, b_nb = (len(i_bs), 10, 10), (10, 10)
    a_idx = np.stack(np.unravel_index(
        np.flatnonzero(rng.random(int(np.prod(a_nb))) < 0.15), a_nb), 1)
    b_idx = np.stack(np.unravel_index(np.flatnonzero(rng.random(100) < 0.6), b_nb), 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return (folded_tensor("A", [i_bs, j_bs, k_bs], la, a_idx, dev, torch.float32, gen),
            folded_tensor("B", [k_bs, l_bs], lb, b_idx, dev, torch.float32, gen))


def sampled_block_check(c, a, b, n_samples: int = 256, seed: int = 1, *,
                        alpha=1.0, beta=0.0, c_in=None) -> tuple:
    """float64 (complex128 for complex data) host recomputation of sampled
    blocks of C = alpha·A·B + beta·C_in (folded matrices, all 'N') from the
    host blocks of A and B (and C_in): (max |C - ref|, that over max
    |ref|)."""
    a_flat, b_flat = a.flat_host(), b.flat_host()
    wide = np.complex128 if np.iscomplexobj(a_flat) or np.iscomplexobj(b_flat) else np.float64
    ai, bi = a.index, b.index
    picks = np.sort(np.random.default_rng(seed).choice(
        c.nblks, size=min(n_samples, c.nblks), replace=False))
    err = scale = 0.0
    for p in picks:
        i, j = int(c.index.blk_rows[p]), int(c.index.col_idx[p])
        ref = np.zeros((int(c.row_block_sizes[i]), int(c.col_block_sizes[j])), dtype=wide)
        for ab in range(int(ai.row_ptr[i]), int(ai.row_ptr[i + 1])):
            k = int(ai.col_idx[ab])
            bb = bi.block_id(k, j)
            if bb < 0:
                continue
            ablk = a_flat[ai.blk_offset[ab]:ai.blk_offset[ab + 1]].reshape(
                int(ai.row_block_sizes[i]), int(ai.col_block_sizes[k]))
            bblk = b_flat[bi.blk_offset[bb]:bi.blk_offset[bb + 1]].reshape(
                int(bi.row_block_sizes[k]), int(bi.col_block_sizes[j]))
            ref += ablk.astype(wide) @ bblk.astype(wide)
        ref = alpha * ref
        old = c_in.get_block(i, j) if c_in is not None else None
        if old is not None:
            ref = ref + beta * old.astype(wide)
        got = c.get_block(i, j)
        if got is None or not np.isfinite(got).all():
            return float("inf"), float("inf")
        err = max(err, float(np.abs(got - ref).max()))
        scale = max(scale, float(np.abs(ref).max()))
    return err, err / (scale or 1.0)


def same_result(what: str, got, ref, rtol: float) -> None:
    """Fail unless two folded results have one index and agree within
    ``rtol`` of the largest reference entry."""
    if not (np.array_equal(got.index.row_ptr, ref.index.row_ptr)
            and np.array_equal(got.index.col_idx, ref.index.col_idx)):
        fail(f"{what}: the block indices differ")
    err, rel = rel_err(got.data, ref.data)
    log(f"    {what}: max_abs_err={err:.3e} rel={rel:.2e} (bound {rtol:.0e})")
    if not rel <= rtol:
        fail(f"{what} disagree")


def native_layout_check(what: str, index) -> None:
    """Print the tile grid of ``index`` at T = 128 and fail unless the
    native planner lays its store out (it declines past ``native_grid_cap``
    grid cells)."""
    from dbcsr_tpu_torch.native import native_grid_cap, store_layout_native

    ntr, ntc = -(-index.nfullrows // 128), -(-index.nfullcols // 128)
    ran = store_layout_native(index, 128) is not None
    log(f"    {what}: tile grid {ntr} x {ntc} = {ntr * ntc} cells (native cap "
        f"{native_grid_cap(index)}), native planner ran: {ran}")
    if not ran:
        fail(f"{what}: the native planner declined the store layout")


R_KW = dict(contract_1=(2,), notcontract_1=(0, 1), contract_2=(0,), notcontract_2=(1,))
K_KW = dict(contract_1=(0, 1), notcontract_1=(2,), contract_2=(0, 1), notcontract_2=(2,))


def launch_delta(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``read_launches()``)."""
    from dbcsr_tpu_torch.mm import launches_since

    return launches_since(before)


def kernel_vs_plain(what: str, plan, a_data, b_data, rtol: float) -> tuple:
    """Hold the executor's kernel against its plain version on the same
    inputs (every product tile); returns the kernel and its inputs."""
    a_st, b_st = plan.op_stores(a_data, b_data)
    a_in, b_in = a_st.to(plan.in_dtype), b_st.to(plan.in_dtype)
    kern = kernel_of(plan)
    ref = plain_of(plan, a_data, b_data)
    err, rel = rel_err(kern(a_in, b_in), ref)
    log(f"    {what} vs its plain version ({ref.shape[0]} product tiles): "
        f"max_abs_err={err:.3e} rel={rel:.2e} (bound {rtol:.0e})")
    if not rel <= rtol:
        fail(f"{what} disagrees with its plain version")
    return kern, a_in, b_in


def phase_tensor_r(dev, dtype) -> None:
    """Shape R at ``TENSOR_ATOMS`` atoms in one type: the legs R1 (steady
    state), R2 (one-shot, nsplit 1 and 4), R4 (refold) and R3 (k-long), each
    checked against the others and, for R1 and R3, a float64 host
    recomputation of sampled blocks."""
    import torch

    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache
    from dbcsr_tpu_torch.tas import split_factor_estimate
    from dbcsr_tpu_torch.tensors import BatchedContract, NDMapping, contract

    name = str(dtype)[6:]
    f64 = dtype == torch.float64
    rtol = F64_RTOL if f64 else KERNEL_RTOL
    want = "K6" if f64 else "K2"
    res = {}
    t0 = time.perf_counter()
    a, b = ri_tensors(TENSOR_ATOMS, dev, dtype)
    sync(dev)
    ma, mb = a.matrix, b.matrix
    gb = ma.data.numel() * ma.data.element_size() / 1e9
    log(f"  shape R, {name}: {TENSOR_ATOMS} atoms, A {a.nblks} blocks in {ma.data.shape[0]} "
        f"tiles ({gb:.2f} GB), B {b.nblks} blocks in {mb.data.shape[0]} tiles; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    native_layout_check("A (μν | P)", ma.index)

    # --- the main-path run: counts set to 0 just before, read just after ---
    reset_launches()
    # R1: BatchedContract, its first call plans the folded executor
    t0 = time.perf_counter()
    batch = BatchedContract()
    out1 = batch.contract(a, b, **R_KW)
    sync(dev)
    r1_first = time.perf_counter() - t0
    (fn, c_index, eff), = batch._tas._cache.values()
    plan = fn.plan
    tp = plan.tile_plan
    launches_r1 = read_launches()
    # R2: one-shot contract, nsplit 1 and 4 (m-long), each once to warm the plan cache
    out2 = {}
    for ns in (1, 4):
        t0 = time.perf_counter()
        before = read_launches()
        out2[ns] = contract(1.0, a, b, nsplit=ns, **R_KW)
        sync(dev)
        res[f"r2_first_s_{ns}"] = time.perf_counter() - t0
        res[f"r2_launches_{ns}"] = launch_delta(before)
    res["cache_r2"] = get_plan_cache().nbytes
    # R4: the refold of A to (P | μν), first call
    target = NDMapping(3, (2,), (0, 1))
    t0 = time.perf_counter()
    refolded = a.with_layout(target)
    sync(dev)
    res["r4_first_s"] = time.perf_counter() - t0
    # R3: C(P,Q) = Σ_{μν} A(μ,ν,P)·A(μ,ν,Q), k-long, nsplit 4
    t0 = time.perf_counter()
    before = read_launches()
    out3 = contract(1.0, a, a, nsplit=4, **K_KW)
    sync(dev)
    res["r3_first_s"] = time.perf_counter() - t0
    res["r3_launches"] = launch_delta(before)
    launches = read_launches()
    res["cache_r3"] = get_plan_cache().nbytes

    log(f"    R1 BatchedContract first call (plans the executor) {r1_first:.1f} s: route "
        f"{plan.route}, S={len(tp.stack)}, planned C tiles {tp.n_c_tiles} (C index "
        f"{c_index.nblks} blocks in {store_layout(c_index, 128).n_tiles} tiles), "
        f"{eff / 1e9:.2f} GFLOP effective, {plan.hw_flops / 1e9:.1f} GFLOP of tile products; "
        f"launches {launches_r1}")
    native_layout_check("C (μν | Q)", c_index)
    native_layout_check("A refolded (P | μν)", refolded.matrix.index)
    for ns in (1, 4):
        log(f"    R2 contract(nsplit={ns}) first call {res[f'r2_first_s_{ns}']:.1f} s, "
            f"launches {res[f'r2_launches_{ns}']}")
    m_e, k_e = int(ma.shape[0]), int(ma.shape[1])
    occ = max(ma.occupation(), mb.occupation())
    log(f"    R2 split_factor_estimate at this shape (not run): "
        f"{split_factor_estimate(m_e, k_e, int(mb.shape[1]), occ_hint=occ)} "
        f"(m={m_e}, k={k_e}, n={int(mb.shape[1])}, occupation {occ:.4f})")
    log(f"    R4 refold A -> (P | μν): first call {res['r4_first_s']:.2f} s "
        f"(host map + upload), {refolded.matrix.data.shape[0]} tiles")
    log(f"    R3 k-long contract(nsplit=4) first call {res['r3_first_s']:.1f} s, "
        f"launches by kernel {res['r3_launches'] or 'none (dense route)'}; "
        f"C(P,Q) {out3.matrix.nblks} blocks")
    log(f"    phase-11 main-path launches ({name}, shape R): {launches}")
    budget = get_plan_cache().max_bytes
    log(f"    plan cache's gather maps on the device: {res['cache_r2'] / 1e9:.3f} GB after R2, "
        f"{res['cache_r3'] / 1e9:.3f} GB after R4 and R3 (budget {budget / 1e9:.3f} GB)")
    if max(res["cache_r2"], res["cache_r3"]) > budget:
        fail(f"shape R {name}: the plan cache holds more than its byte budget")
    if launches_r1.get(want, 0) < 1 or sum(launches.values()) == 0:
        fail(f"shape R {name}: BatchedContract launched {launches_r1}, expected {want}")
    if plan.route != ("f64_stack" if f64 else "panel"):
        fail(f"shape R {name}: the folded executor took route {plan.route}")

    # --- agreement of the legs --------------------------------------------
    fold2d = fn(ma.data, mb.data)
    sync(dev)
    if not torch.equal(out1.matrix.data, fold2d):
        fail(f"shape R {name}: BatchedContract and the folded executor differ")
    same_result(f"R1 vs one-shot nsplit=1 ({name})", out2[1].matrix, out1.matrix, rtol)
    same_result(f"R1 vs one-shot nsplit=4 ({name})", out2[4].matrix, out1.matrix, rtol)
    serr, srel = sampled_block_check(out1.matrix, ma, mb)
    log(f"    R1 vs float64 host recomputation (256 blocks): max_abs_err={serr:.3e} "
        f"rel={srel:.2e} (bound {rtol:.0e})")
    if not srel <= rtol:
        fail(f"shape R {name}: R1 disagrees with the float64 recomputation")
    ref_t = a.with_layout(target)
    if not torch.equal(ref_t.matrix.data, refolded.matrix.data):
        fail(f"shape R {name}: the cached refold differs from the first")
    with BatchedContract() as kb:
        out3b = kb.contract(a, a, **K_KW)
        (fn3, _, _), = kb._tas._cache.values()
    out3_1 = contract(1.0, a, a, nsplit=1, **K_KW)
    fold3 = fn3(refolded.matrix.data, ma.data)
    kernel_vs_plain(f"R3 {fn3.plan.route} kernel", fn3.plan, refolded.matrix.data, ma.data,
                    rtol)
    same_result(f"R3 nsplit=4 vs BatchedContract ({name})", out3.matrix, out3b.matrix, rtol)
    same_result(f"R3 nsplit=1 vs BatchedContract ({name})", out3_1.matrix, out3b.matrix, rtol)
    if not torch.equal(out3b.matrix.data, fold3):
        fail(f"shape R {name}: R3's BatchedContract and its folded executor differ")
    serr3, srel3 = sampled_block_check(out3.matrix, refolded.matrix, ma)
    log(f"    R3 vs float64 host recomputation (256 blocks): max_abs_err={serr3:.3e} "
        f"rel={srel3:.2e} (bound {rtol:.0e})")
    if not srel3 <= rtol:
        fail(f"shape R {name}: R3 disagrees with the float64 recomputation")
    del out3b, out3_1, fold3, ref_t, out2

    # --- times (CUDA-event medians) -------------------------------------------
    ms = cuda_median_ms(lambda: batch.contract(a, b, **R_KW), reps=10)
    ms2d = cuda_median_ms(lambda: fn(ma.data, mb.data), reps=10)
    kern, a_in, b_in = kernel_vs_plain(f"R1 {plan.route} kernel", plan, ma.data, mb.data, rtol)
    kms = cuda_median_ms(lambda: kern(a_in, b_in), reps=10)
    pms = cuda_median_ms(lambda: plain_of(plan, ma.data, mb.data), reps=3, warmup=1)
    ms_r2 = {ns: cuda_median_ms(lambda: contract(1.0, a, b, nsplit=ns, **R_KW),
                                reps=3, warmup=0) for ns in (1, 4)}
    ms_r4 = cuda_median_ms(lambda: a.with_layout(target), reps=10)
    ms_r3 = cuda_median_ms(lambda: contract(1.0, a, a, nsplit=4, **K_KW), reps=3, warmup=0)
    counts = (ma.data.shape[0], mb.data.shape[0], tp.n_c_tiles, len(tp.stack))
    log(f"    R1 steady state: BatchedContract.contract {ms:.3f} ms, folded 2-D executor "
        f"{ms2d:.3f} ms (tensor-layer overhead factor {ms2d / ms:.3f}); kernel {kms:.3f} ms, "
        f"plain {pms:.3f} ms; {eff / ms / 1e9:.2f} TFLOP/s effective, "
        f"{plan.hw_flops / kms / 1e9:.1f} TFLOP/s of tile products")
    log("    " + rate_line(f"R1 {plan.route} kernel", kms, counts, name))
    log(f"    R2 one-shot contract (plan cache warm): nsplit=1 {ms_r2[1]:.3f} ms, "
        f"nsplit=4 {ms_r2[4]:.3f} ms")
    log(f"    R4 cached refold gather {ms_r4:.3f} ms; R3 k-long contract(nsplit=4) warm "
        f"{ms_r3:.3f} ms")
    batch.finalize()


def phase_tensor_t(dev, n_rows: int) -> None:
    """Shape T (bench.py's tensor shape, tall axis ``n_rows``): R1 and R4,
    held against a float64 matmul of the folded dense operands."""
    import torch

    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.tensors import BatchedContract, NDMapping

    t0 = time.perf_counter()
    a, b = bench_tensor_pair(n_rows, dev)
    sync(dev)
    ma, mb = a.matrix, b.matrix
    log(f"  shape T: i = {n_rows} elements ({len(a.block_sizes[0])} blocks), A {a.nblks} "
        f"blocks in {ma.data.shape[0]} tiles ({ma.data.numel() * 4 / 1e9:.2f} GB), B "
        f"{b.nblks} blocks; set-up {time.perf_counter() - t0:.1f} s")
    native_layout_check("A (ij | k)", ma.index)
    from dbcsr_tpu_torch.tas import split_factor_estimate

    dims = (int(ma.shape[0]), int(ma.shape[1]), int(mb.shape[1]))
    occ = max(ma.occupation(), mb.occupation())
    log(f"    split_factor_estimate at this shape (not run): "
        f"{split_factor_estimate(*dims, occ_hint=occ)} (m, k, n = {dims}, occupation "
        f"{occ:.4f})")
    before = read_launches()
    t0 = time.perf_counter()
    with BatchedContract() as batch:
        out = batch.contract(a, b, **R_KW)
        sync(dev)
        first = time.perf_counter() - t0
        (fn, c_index, eff), = batch._tas._cache.values()
        ms = cuda_median_ms(lambda: batch.contract(a, b, **R_KW), reps=10)
    ms2d = cuda_median_ms(lambda: fn(ma.data, mb.data), reps=10)
    log(f"    R1: route {fn.plan.route}, launches {launch_delta(before) or 'none'}, first "
        f"call {first:.1f} s; BatchedContract {ms:.3f} ms, folded 2-D executor {ms2d:.3f} ms "
        f"(overhead factor {ms2d / ms:.3f}), {eff / ms / 1e9:.2f} TFLOP/s effective; C "
        f"{store_layout(c_index, 128).n_tiles} tiles")
    # the reference: a float64 matmul of the folded dense operands on the card
    ref = ma.to_dense().double() @ mb.to_dense().double()
    err, rel = rel_err(out.matrix.to_dense(), ref)
    log(f"    R1 vs float64 dense matmul: max_abs_err={err:.3e} rel={rel:.2e} "
        f"(bound {KERNEL_RTOL:.0e})")
    if not rel <= KERNEL_RTOL:
        fail("shape T disagrees with the float64 dense product")
    del ref, out
    torch.cuda.empty_cache()
    target = NDMapping(3, (2,), (0, 1))
    t0 = time.perf_counter()
    refolded = a.with_layout(target)
    sync(dev)
    first = time.perf_counter() - t0
    ms4 = cuda_median_ms(lambda: a.with_layout(target), reps=10)
    log(f"    R4 refold A -> (k | ij): first call {first:.2f} s, cached gather {ms4:.3f} ms "
        f"({refolded.matrix.data.shape[0]} tiles)")
    if not torch.equal(refolded.matrix.data, a.with_layout(target).matrix.data):
        fail("shape T: the cached refold differs from the first")


def phase_tensor(dev) -> None:
    import torch

    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        phase_tensor_r(dev, dtype)
        torch.cuda.empty_cache()
    phase_tensor_t(dev, TENSOR_T_ROWS)
    log(f"    phase 11: {time.perf_counter() - t0:.1f} s, peak device memory so far "
        f"{peak_memory(dev) / 1e9:.2f} GB")
    # the plan cache holds the prepared refold, extraction and merge maps
    get_plan_cache().clear()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the host API around the multiply on the card
# ---------------------------------------------------------------------------

#: phase 12b: (T, driver, config knobs) of the retiled executors per type,
#: held against T = 128 under ``auto``. At T = 64 the band's B span per
#: window of 16 C tiles is 80 tiles, past the default ``panel_cache`` of 48:
#: ``auto`` declines the panel plan there and takes K1, so K2 runs forced,
#: with a cache of 96
RETILE_LEGS = {"float32": ((64, "auto", {}), (64, "stack", {}),
                           (64, "panel", {"panel_cache": 96}), (32, "stack", {})),
               "float64": ((64, "auto", {}), (32, "stack", {}))}
#: phase 12's launches, summed over its legs' checked windows (timing runs
#: and the self-tests' comparisons with plain versions are outside them)
LEG_LAUNCHES = {}
#: the kernel each route launches (None: the dense path, a torch matmul)
ROUTE_KERNEL = {"stack": "K1", "panel": "K2", "panel_runs": "K3", "grouped": "K4",
                "band": "K5", "f64_stack": "K6", "dense": None, "empty": None}


def expect_launches(what: str, before: dict, kernel, at_least: int = 1) -> dict:
    """Fail unless, since ``before`` (a ``read_launches()``), ``kernel``
    launched at least ``at_least`` times and no other kernel launched
    (``kernel`` None: no kernel at all). The wrappers launch their kernel on
    CUDA tensors or raise, so a product that launched nothing ran nowhere
    else: a plain version on the card would show as no launch."""
    delta = launch_delta(before)
    want = set() if kernel is None else {kernel}
    if set(delta) != want or (kernel is not None and delta[kernel] < at_least):
        fail(f"{what}: kernel launches {delta}, expected "
             f"{'none' if kernel is None else f'{kernel} at least {at_least} times, no other'}")
    for k, n in delta.items():
        LEG_LAUNCHES[k] = LEG_LAUNCHES.get(k, 0) + n
    return delta


def window_mask(c, rows, cols):
    """[n_tiles, T, T] bool over C's store: the elements inside the element
    rectangle of the half-open block ranges ``rows`` x ``cols``."""
    import torch

    t, dev = c.tile, c.device
    r0, r1 = (int(c.index.row_offsets[x]) for x in rows)
    c0, c1 = (int(c.index.col_offsets[x]) for x in cols)
    tc = torch.as_tensor(c.layout.tile_coords.astype(np.int64), device=dev)
    ar = torch.arange(t, device=dev)
    gr, gc = tc[:, 0, None] * t + ar, tc[:, 1, None] * t + ar
    return (((gr >= r0) & (gr < r1))[:, :, None]) & (((gc >= c0) & (gc < c1))[:, None, :])


def phase_limits(dev, a, b) -> None:
    """12a: ``multiply(limits=...)`` at the phase-4 shape, beta 0.5 with C =
    the full product (its pattern and values): W1 over rows and cols
    [NB/4, 3NB/4) with k full, W2 over all three. W1 against the full
    product inside the window and ``beta·C`` (bitwise) outside; W2 against
    the plain version of its window product on the card and a host float64
    recomputation of 256 sampled blocks."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles
    from dbcsr_tpu_torch.tas.matrix import extract_block_subset

    name = str(a.dtype)[6:]
    f64 = a.dtype == torch.float64
    kern, rtol = ("K6", F64_RTOL) if f64 else ("K2", KERNEL_RTOL)
    nb = a.nblkrows
    q = (nb // 4, 3 * nb // 4)
    sel = np.arange(*q, dtype=np.int64)
    before = read_launches()
    t0 = time.perf_counter()
    c = dt.multiply("N", "N", 1.0, a, b)
    sync(dev)
    expect_launches(f"12a {name}: the full product", before, kern)
    log(f"  {name}: {nb} block rows, window blocks [{q[0]}, {q[1]}); full product "
        f"{c.nblks} blocks, {c.data.shape[0]} tiles, one-shot {time.perf_counter() - t0:.2f} s")
    half_c = 0.5 * c.data
    inside = window_mask(c, q, q)
    for wname, lim in (("W1", {"rows": q, "cols": q}), ("W2", {"rows": q, "cols": q, "k": q})):
        before = read_launches()
        secs = []
        for _ in range(2):  # the first call plans; the second is the warm one-shot
            t0 = time.perf_counter()
            w = dt.multiply("N", "N", 1.0, a, b, 0.5, c, limits=lim)
            sync(dev)
            secs.append(time.perf_counter() - t0)
        launched = expect_launches(f"12a {name} {wname}", before, kern, at_least=2)
        if not (np.array_equal(w.index.row_ptr, c.index.row_ptr)
                and np.array_equal(w.index.col_idx, c.index.col_idx)):
            fail(f"12a {name} {wname}: the result's index is not C's")
        if not torch.equal(torch.where(inside, 0.0, w.data), torch.where(inside, 0.0, half_c)):
            fail(f"12a {name} {wname}: outside the window the result is not beta·C")
        msg = (f"  {wname} {name}: first call {secs[0]:.2f} s, warm one-shot "
               f"{secs[1] * 1e3:.1f} ms, launches {launched}; outside the window "
               f"== beta·C bitwise")
        if wname == "W1":
            err, rel = rel_err(torch.where(inside, w.data - half_c, 0.0),
                               torch.where(inside, c.data, 0.0))
            log(f"{msg}; inside vs the full product max_abs_err={err:.3e} rel={rel:.2e} "
                f"(bound {rtol:.0e})")
            if not rel <= rtol:
                fail(f"12a {name} W1 disagrees with the full product")
            continue
        log(msg)
        # the window product alone, against its plain version and float64
        before = read_launches()
        r = dt.multiply("N", "N", 1.0, a, b, limits=lim)
        expect_launches(f"12a {name} W2 without C", before, kern)
        r_w = extract_block_subset(r, row_blocks=sel, col_blocks=sel)
        a_sub = extract_block_subset(a, row_blocks=sel, col_blocks=sel)
        b_sub = extract_block_subset(b, row_blocks=sel, col_blocks=sel)
        fn, c_index, _ = dt.build_multiply_executor("N", "N", a_sub, b_sub)
        if not np.array_equal(r_w.index.col_idx, c_index.col_idx):
            fail(f"12a {name} W2: the window product's index is not the executor's")
        plain = take_tiles(plain_of(fn.plan, a_sub.data, b_sub.data),
                           fn.plan.align_map(store_layout(c_index, 128).tile_keys()), 128)
        err, rel = rel_err(r_w.data, plain)
        serr, srel = sampled_block_check(r_w, a_sub, b_sub, 256)
        log(f"    W2 {name} window product ({fn.plan.route}, {r_w.nblks} blocks): vs plain "
            f"max_abs_err={err:.3e} rel={rel:.2e}; vs float64 (256 blocks) "
            f"max_abs_err={serr:.3e} rel={srel:.2e} (bound {rtol:.0e})")
        if not (rel <= rtol and srel <= rtol):
            fail(f"12a {name} W2 disagrees with its references")
        del r, r_w, a_sub, b_sub, fn, plain
    del c, half_c, inside, w
    torch.cuda.empty_cache()


def phase_retile(dev, a, b, card: str) -> None:
    """12b: ``retile`` round trip, then the executors of RETILE_LEGS at T =
    64 and 32 against the T = 128 executor under ``auto`` (the same block
    index: flat data within 1e-4 / 1e-12), each timed (CUDA-event medians,
    kernel and plain version) beside its bound at that T."""
    import torch

    import dbcsr_tpu_torch as dt

    name = str(a.dtype)[6:]
    tol = F64_RTOL if a.dtype == torch.float64 else KERNEL_RTOL
    size = a.data.element_size()
    t0 = time.perf_counter()
    r64 = dt.retile(a, 64)
    back = dt.retile(r64, 128)
    sync(dev)
    if not torch.equal(back.data, a.data):
        fail(f"12b {name}: retile(retile(A, 64), 128) is not A")
    log(f"  {name}: retile(retile(A, 64), 128) == A bitwise ({time.perf_counter() - t0:.2f} s "
        f"with the first calls' maps); A at T=128 {a.data.shape[0]} tiles, at T=64 "
        f"{r64.data.shape[0]}")
    del r64, back
    fn, ref_index, _ = dt.build_multiply_executor("N", "N", a, b)
    before = read_launches()
    out = fn(a.data, b.data)
    sync(dev)
    expect_launches(f"12b {name} T=128", before, ROUTE_KERNEL[fn.plan.route])
    ref = dt.BCSRMatrix(name="C", index=ref_index, data=out).flat_host()
    scale = float(np.abs(ref).max()) or 1.0
    del fn, out
    stores = {}
    for tile, driver, knobs in RETILE_LEGS[name]:
        if tile not in stores:
            stores.clear()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            stores[tile] = (dt.retile(a, tile), dt.retile(b, tile))
            sync(dev)
            t_retile = time.perf_counter() - t0
        at, bt = stores[tile]
        t0 = time.perf_counter()
        with dt.config_override(mm_driver=driver, **knobs):
            fn, c_index, eff = dt.build_multiply_executor("N", "N", at, bt)
        t_plan = time.perf_counter() - t0
        plan = fn.plan
        kern = ROUTE_KERNEL[plan.route]
        what = f"T={tile} {name} {driver}" + "".join(f" {k}={v}" for k, v in knobs.items())
        before = read_launches()
        out = fn(at.data, bt.data)
        sync(dev)
        expect_launches(f"12b {what}", before, kern)
        if not (np.array_equal(c_index.col_idx, ref_index.col_idx)
                and np.array_equal(c_index.row_ptr, ref_index.row_ptr)):
            fail(f"12b {what}: C's block index differs from T=128's")
        err = float(np.abs(dt.BCSRMatrix(name="C", index=c_index, data=out).flat_host()
                           - ref).max())
        a_in, b_in = plan.op_stores(at.data, bt.data)
        a_in, b_in = a_in.to(plan.in_dtype), b_in.to(plan.in_dtype)
        kf = kernel_of(plan)
        p1 = cuda_median_ms(lambda: plain_of(plan, at.data, bt.data), reps=3, warmup=1)
        k1 = cuda_median_ms(lambda: kf(a_in, b_in), reps=10)
        ex = cuda_median_ms(lambda: fn(at.data, bt.data), reps=10)
        k2 = cuda_median_ms(lambda: kf(a_in, b_in), reps=10)
        p2 = cuda_median_ms(lambda: plain_of(plan, at.data, bt.data), reps=3, warmup=1)
        km, pm = float(np.median([k1, k2])), float(np.median([p1, p2]))
        counts = plan_counts(at, bt, plan)
        bound_ms, bound_by = kernel_bound(*counts, tile, size, size, name)
        log(f"  {what}: route {plan.route} ({kern}), S={counts[3]}, A/B "
            f"{counts[0]}/{counts[1]} tiles ({at.data.numel() * size / 1e9:.2f} GB store "
            f"each), C {counts[2]} planned tiles; plan {t_plan:.1f} s, retile {t_retile:.1f} s; "
            f"vs T=128 (flat) max_abs_err={err:.3e} rel={err / scale:.2e} (bound {tol:.0e})")
        log(f"    kernel {km:.3f} ms (runs {k1:.3f}/{k2:.3f}), plain {pm:.3f}, executor "
            f"{ex:.3f}; bound {bound_ms:.3f} ms by {bound_by}: {bound_ms / km:.1%} of it; "
            f"{eff / ex / 1e6:.1f} GFLOP/s effective [{card}]")
        if not err <= tol * scale:
            fail(f"12b {what} disagrees with T=128")
        del out, a_in, b_in, fn
    stores.clear()
    torch.cuda.empty_cache()


def phase_checkpoint(dev, a) -> None:
    """12c: ``binary_write`` of A, ``binary_read`` back onto the card: the
    store bitwise equal, ``checksum(pos=True)`` identical; no kernel runs."""
    import tempfile

    import torch

    import dbcsr_tpu_torch as dt

    before = read_launches()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "a.dbcsr")
        t0 = time.perf_counter()
        dt.binary_write(a, path)
        t_write = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = dt.binary_read(path, device=dev)
        sync(dev)
        t_read = time.perf_counter() - t0
    expect_launches("12c checkpoint", before, None)
    same = back.device == a.device and torch.equal(back.data, a.data)
    cks = (dt.checksum(a, pos=True), dt.checksum(back, pos=True))
    log(f"  {str(a.dtype)[6:]} A ({a.nblks} blocks, {a.index.nelems} elements): file "
        f"{nbytes} bytes, write {t_write:.2f} s, read onto the card {t_read:.2f} s; "
        f"store bitwise equal {same}; checksum(pos) {cks[0]:.15e} / {cks[1]:.15e}")
    if not (same and cks[0] == cks[1]):
        fail("12c: the checkpoint did not read back bitwise")


def phase_csr(dev, a) -> None:
    """12d: ``to_csr`` of A and ``from_csr`` back onto A's block sizes: the
    store bitwise equal; no kernel runs."""
    import torch

    import dbcsr_tpu_torch as dt

    before = read_launches()
    t0 = time.perf_counter()
    csr = dt.to_csr(a)
    t_to = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = dt.from_csr(csr, a.row_block_sizes, a.col_block_sizes, device=dev, name=a.name)
    sync(dev)
    t_from = time.perf_counter() - t0
    expect_launches("12d CSR", before, None)
    same = (back.device == a.device and back.nblks == a.nblks
            and torch.equal(back.data, a.data))
    log(f"  {str(a.dtype)[6:]} A: to_csr {t_to:.2f} s ({csr.nnz} stored elements), "
        f"from_csr {t_from:.2f} s ({back.nblks} blocks); store bitwise equal {same}")
    if not same:
        fail("12d: the CSR round trip did not give A back")


def perf_reference_checksum(cfg, seed: int = 0) -> float:
    """``checksum(pos=True)`` of the recipe's product recomputed on the host
    in float64: the same operands drawn on the CPU, exchanged through
    ``to_csr`` (scipy), multiplied densely in float64."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.perf import perf_operands

    a, b, c, limits = perf_operands(cfg, device=torch.device("cpu"), seed=seed)
    if limits or cfg.retain_sparsity:
        fail("12e: the host recomputation covers plain products only")
    cplx = a.dtype.is_complex  # complex128 then, with complex alpha/beta
    wide = np.complex128 if cplx else np.float64
    alpha, beta = (cfg.alpha, cfg.beta) if cplx else (cfg.alpha.real, cfg.beta.real)

    def op(m, trans):
        d = dt.to_csr(m).toarray().astype(wide)
        return d.conj().T if trans == "C" else d.T if trans == "T" else d

    ref = alpha * (op(a, cfg.transa) @ op(b, cfg.transb))
    if c is not None:
        ref += beta * dt.to_csr(c).toarray().astype(wide)
    w = np.log(np.arange(1, ref.shape[0] + 1, dtype=np.float64))[:, None] + np.log(
        np.arange(1, ref.shape[1] + 1, dtype=np.float64))[None, :]
    return float((ref.real * w).sum())


def phase_perf_recipes(dev) -> None:
    """12e: every ``tests/inputs/*.perf`` through ``perf.run_perf`` on the
    card with the file's nrep: the checksum against the host float64
    recomputation (1e-12 relative), the file's TPU reference printed
    beside it (not gated), and the route's kernel as the only launches."""
    import glob

    from dbcsr_tpu_torch.perf import parse_perf, run_perf

    for path in sorted(glob.glob(os.path.join(REPO, "tests", "inputs", "*.perf"))):
        fname = os.path.basename(path)
        cfg = parse_perf(path)
        before = read_launches()
        t0 = time.perf_counter()
        res = run_perf(cfg, device=dev, seed=0, verbose=False)
        secs = time.perf_counter() - t0
        kern = ROUTE_KERNEL[res["route"]]
        # nrep one-shot multiplies, then the steady leg's 2 + 10 executor calls
        launched = expect_launches(f"12e {fname}", before, kern, at_least=cfg.nrep + 12)
        ref = perf_reference_checksum(cfg)
        rel = abs(res["checksum"] - ref) / max(abs(ref), 1e-300)
        tpu = cfg.checksum_refs[0] if cfg.checksum_refs else float("nan")
        log(f"  {fname:28s} {cfg.m}x{cfg.n}x{cfg.k} {'float64' if cfg.data_type == 3 else 'float32'}"
            f" {cfg.transa}{cfg.transb} nrep {cfg.nrep}: mean {res['mean_time_s'] * 1e3:.3f} ms, "
            f"best {res['best_time_s'] * 1e3:.3f} ms, steady {res['steady_time_s'] * 1e3:.3f} ms = "
            f"{res['flops_per_s_steady'] / 1e9:.1f} GFLOP/s, route {res['route']} "
            f"(launches {launched or 'none'}); checksum {res['checksum']:.15e} vs host float64 "
            f"rel {rel:.2e} (bound 1e-12); TPU ref {tpu:.15e} match "
            f"{res.get('checksum_match')} (not gated); {secs:.1f} s")
        if not rel <= 1e-12:
            fail(f"12e {fname}: the checksum disagrees with the host float64 recomputation")


def phase_self_tests(dev) -> None:
    """12f: the built-in self-tests on the card; 12g: the machine helpers."""
    import torch

    from dbcsr_tpu_torch import testing
    from dbcsr_tpu_torch.core.machine import device_memory_stats, m_peak_memory

    t0 = time.perf_counter()
    ok_run = testing.run_tests(dev)
    ok_val = testing.validate_kernels(dev, verbose=True)
    log(f"  testing.run_tests(cuda) {ok_run}, validate_kernels(cuda) {ok_val} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (ok_run and ok_val):
        fail("12f: a built-in self-test failed on the card")
    stats = device_memory_stats(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  [12g] device_memory_stats: in use {stats['bytes_in_use']}, peak "
        f"{stats['peak_bytes_in_use']} (torch.cuda.max_memory_allocated {peak}), limit "
        f"{stats['bytes_limit']}; host m_peak_memory {m_peak_memory() / 1e9:.2f} GB")
    if stats["peak_bytes_in_use"] != peak:
        fail("12g: device_memory_stats disagrees with torch.cuda.max_memory_allocated")


def phase_host_api(dev, card: str) -> None:
    """Phase 12 over phase 4's banded SCF operands in float32 and float64,
    with the launch counters set to 0 just before and read just after."""
    import torch

    reset_launches()
    LEG_LAUNCHES.clear()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        t0 = time.perf_counter()
        a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=dtype)
        sync(dev)
        log(f"[12] {name} operands at {MAIN_ROWS} rows: set-up {time.perf_counter() - t0:.1f} s")
        log(f"[12a] limits, {name}")
        phase_limits(dev, a, b)
        log(f"[12b] retile, {name}")
        phase_retile(dev, a, b, card)
        if dtype == torch.float64:
            log("[12c] binary checkpoint, float64")
            phase_checkpoint(dev, a)
        else:
            log("[12d] CSR exchange, float32")
            phase_csr(dev, a)
        del a, b
        torch.cuda.empty_cache()
    log("[12e] .perf recipes")
    phase_perf_recipes(dev)
    log("[12f] built-in self-tests")
    phase_self_tests(dev)
    log(f"  phase 12 launches on its legs (timing and self-test launches apart): "
        f"{LEG_LAUNCHES}; all launches of the phase: {read_launches()}")


# ---------------------------------------------------------------------------
# the library yardstick: one PyTorch call for the same product
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: complex matrices (KC1 complex64, KC2 complex128)
# ---------------------------------------------------------------------------

#: phase 13: each complex type, its kernel, and the real type of its parts
#: (the four-real-products yardstick runs K1 / the float64 kernel on them)
C_TYPES = (("complex64", "KC1", "float32"), ("complex128", "KC2", "float64"))
#: phase 13b: the coefficients of the Hermitian leg
ALPHA_13B, BETA_13B = 0.5 + 0.25j, 1j


def complex_bound(counts: tuple, tile: int, tname: str) -> tuple:
    """The least time (ms) the card could take for a complex stack product:
    the larger of its compulsory bytes (each A and B tile read once, each C
    tile written once; 8 or 16 bytes an element) over the HBM rate and its
    real flops (8·T³ a tile product) over the peak of its parts' type."""
    n_a, n_b, n_c, n_products = counts
    size = 8 if tname == "complex64" else 16
    t_bytes = (n_a + n_b + n_c) * size * tile * tile / HBM_BYTES_PER_S * 1e3
    peak = PEAK_FLOPS["float32" if tname == "complex64" else "float64"]
    t_ops = 8.0 * n_products * tile**3 / peak * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def four_real_products(plan, rname: str):
    """The TPU's schedule for a complex product (dbcsr_tpu/ops/complex_emu.py,
    emu_multiply): split A and B into real and imaginary planes, four real
    products on the plan's stack through K1 (float32 parts) or the float64
    kernel (float64 parts), then combine. Returns ``run(a_store, b_store)``,
    the product tiles in the plan's order."""
    import torch

    from dbcsr_tpu_torch.mm.f64_stack import tile_stack_matmul_f64
    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul

    ds = plan.stack
    real_kernel = tile_stack_matmul if rname == "float32" else tile_stack_matmul_f64

    def run(a, b):
        ar, ai = a.real.contiguous(), a.imag.contiguous()
        br, bi = b.real.contiguous(), b.imag.contiguous()
        re = real_kernel(ar, br, ds).sub_(real_kernel(ai, bi, ds))
        im = real_kernel(ar, bi, ds).add_(real_kernel(ai, br, ds))
        return torch.complex(re, im)

    return run


def phase_complex_main(dev) -> tuple:
    """13a: the banded SCF operands at MAIN_ROWS rows in complex64 and
    complex128 through ``build_multiply_executor`` under ``auto``: route
    ``c_stack``, KC1 / KC2 the only launches of the main-path run, two calls
    bitwise equal, against the plain version (every tile), a host
    complex128 recomputation of 64 sampled tiles and the four-real-products
    schedule; CUDA-event medians of the kernel, the executor, the plain
    version and the yardstick. Returns ({kernel: row}, the complex128
    operands and product for 13b)."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles

    rows, keep = {}, None
    for tname, kname, rname in C_TYPES:
        dtype = getattr(torch, tname)
        rtol = C_RTOL[tname]
        t0 = time.perf_counter()
        a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=dtype)
        sync(dev)
        t_set = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b)
        plan, tp = fn.plan, fn.plan.tile_plan
        n_c = store_layout(c_index, 128).n_tiles
        log(f"  13a {tname}: A/B {a.data.shape[0]} tiles "
            f"({a.data.numel() * a.data.element_size() / 1e9:.2f} GB each), set-up "
            f"{t_set:.1f} s; executor (auto) route={plan.route}, S={len(tp.stack)}, planned "
            f"C tiles {tp.n_c_tiles} (C index {n_c}), plan {time.perf_counter() - t0:.1f} s")
        if plan.route != "c_stack":
            fail(f"13a {tname}: auto took route {plan.route}, expected c_stack")

        # --- the main-path run: counts set to 0 just before, read just after
        reset_launches()
        out = fn(a.data, b.data)
        sync(dev)
        launched = {k: n for k, n in read_launches().items() if n}
        log(f"  13a {tname} main-path launches: {launched}")
        if launched != {kname: 1}:
            fail(f"13a {tname}: launches {launched}, expected {kname} once and no other")
        if tuple(out.shape) != (n_c, 128, 128) or out.dtype != dtype:
            fail(f"13a {tname}: output {tuple(out.shape)} {out.dtype}")
        same = bool(torch.equal(out, fn(a.data, b.data)))
        ref = take_tiles(plain_of(plan, a.data, b.data),
                         plan.align_map(store_layout(c_index, 128).tile_keys()), 128)
        err, rel = rel_err(out, ref)
        del ref
        serr, srel = sampled_f64_check(plan, out, c_index, a.data, b.data)
        kern = kernel_of(plan)
        four = four_real_products(plan, rname)
        yerr, yrel = rel_err(four(a.data, b.data), kern(a.data, b.data))
        sync(dev)
        log(f"  13a {tname}: two calls bitwise equal {same}; vs plain max_abs_err={err:.3e} "
            f"rel={rel:.2e}; vs host complex128 (64 tiles) rel={srel:.2e}; four real "
            f"products ({'K1' if rname == 'float32' else 'the float64 kernel'} on split "
            f"planes) vs {kname} rel={yrel:.2e} (bound {rtol:.0e})")
        if not (same and rel <= rtol and srel <= rtol and yrel <= rtol):
            fail(f"13a {tname}: {kname} disagrees with its references")

        # plain, kernel, executor, yardstick, kernel, yardstick, plain: one call
        p1 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
        k1 = cuda_median_ms(lambda: kern(a.data, b.data), reps=10)
        ex = cuda_median_ms(lambda: fn(a.data, b.data), reps=10)
        y1 = cuda_median_ms(lambda: four(a.data, b.data), reps=10)
        k2 = cuda_median_ms(lambda: kern(a.data, b.data), reps=10)
        y2 = cuda_median_ms(lambda: four(a.data, b.data), reps=10)
        p2 = cuda_median_ms(lambda: plain_of(plan, a.data, b.data), reps=3, warmup=1)
        km, pm, ym = (float(np.median(x)) for x in ((k1, k2), (p1, p2), (y1, y2)))
        counts = (a.data.shape[0], b.data.shape[0], tp.n_c_tiles, len(tp.stack))
        bound_ms, bound_by = complex_bound(counts, 128, tname)
        flop = 8.0 * len(tp.stack) * 128**3
        log(f"  13a {tname}: {kname} {km:.3f} ms (runs {k1:.3f}/{k2:.3f}) = "
            f"{flop / km / 1e9:.1f} TFLOP/s, bound {bound_ms:.3f} ms by {bound_by}: "
            f"{bound_ms / km:.1%} of it; executor {ex:.3f} ms; plain {pm:.3f} ms; four real "
            f"products {ym:.3f} ms (runs {y1:.3f}/{y2:.3f}, {ym / km:.2f}x {kname}); "
            f"executor {eff / ex / 1e6:.1f} effective GFLOP/s (block-level 2·m·n·k)")
        rows[kname] = {"launches": 1, "max_abs_err": err, "ms": km, "plain_ms": pm,
                       "exec_ms": ex, "four_ms": ym, "bound_ms": bound_ms,
                       "bound_by": bound_by}
        if tname == "complex128":
            keep = (a, b, dt.BCSRMatrix(name="C", index=c_index, data=out))
        else:
            del out
        del a, b, fn, plan, tp
        torch.cuda.empty_cache()
    return rows, keep


def phase_complex_hermitian(dev, a, b, c_in) -> None:
    """13b: a Hermitian A (``sym="H"``: the upper block triangle of 13a's
    complex128 A, its diagonal made real), ``transa="C"``, alpha = 0.5+0.25j
    and beta = 1j on a complex C (13a's product): the one-shot ``multiply``
    and the executor (KC2 the only launches of each), against each other
    and a host complex128 recomputation of 256 sampled blocks."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.tileops import coord_mask

    h = dt.fold_symmetric(a, "H")
    diag = coord_mask(h.layout, lambda r, c: r == c, dev)
    h = h.with_data(torch.where(diag, h.data.real.to(h.dtype), h.data))
    del diag
    hf = dt.desymmetrize(h)
    t0 = time.perf_counter()
    before = read_launches()
    out = dt.multiply("C", "N", ALPHA_13B, h, b, BETA_13B, c_in)
    sync(dev)
    t_one = time.perf_counter() - t0
    expect_launches("13b one-shot multiply", before, "KC2")
    fn, c_index, _ = dt.build_multiply_executor("C", "N", h, b)
    if fn.plan.route != "c_stack" or not fn.plan.a_conj:
        fail(f"13b: the executor took route {fn.plan.route}, a_conj {fn.plan.a_conj}")
    before = read_launches()
    prod = fn(hf.data, b.data)
    sync(dev)
    expect_launches("13b executor", before, "KC2")
    via = dt.add(ALPHA_13B, dt.BCSRMatrix(name="P", index=c_index, data=prod), BETA_13B, c_in)
    same_result("13b executor + add vs one-shot multiply", via, out, F64_RTOL)
    del via, prod
    ah = dt.transpose(hf, conjugate=True)
    serr, srel = sampled_block_check(out, ah, b, alpha=ALPHA_13B, beta=BETA_13B, c_in=c_in)
    log(f"  13b H ({h.nblks} stored blocks, {hf.nblks} expanded), 'C','N', alpha "
        f"{ALPHA_13B}, beta {BETA_13B}: C {out.nblks} blocks; one-shot {t_one:.1f} s; vs "
        f"host complex128 (256 blocks) max_abs_err={serr:.3e} rel={srel:.2e} "
        f"(bound {F64_RTOL:.0e})")
    if not srel <= F64_RTOL:
        fail("13b: the Hermitian product disagrees with the host recomputation")


def phase_complex_filtered(dev) -> None:
    """13c: the complex128 filtered SCF step (phase 7's decay and eps) on
    the banded shape: KC2 the only launch of the step, the kept share equal
    to the one-shot ``multiply(filter_eps=...)``'s and ``compact()`` equal
    to it element for element (the same kernel on the same stack)."""
    import torch

    import dbcsr_tpu_torch as dt

    a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=torch.complex128, decay=DECAY)
    t0 = time.perf_counter()
    ex = dt.build_filtered_executor("N", "N", a, b, FILTER_EPS)
    sync(dev)
    t_plan = time.perf_counter() - t0
    if ex.fn.plan.route != "c_stack":
        fail(f"13c: the filtered executor took route {ex.fn.plan.route}")
    reset_launches()
    c, keep, _ = ex.step(a.data, b.data)
    sync(dev)
    launched = {k: n for k, n in read_launches().items() if n}
    if launched != {"KC2": 1}:
        fail(f"13c: the step launched {launched}, expected KC2 once and no other")
    one_s = []
    for _ in range(2):  # cold (plans the pattern), then warm
        t0 = time.perf_counter()
        one = dt.multiply("N", "N", 1.0, a, b, filter_eps=FILTER_EPS)
        sync(dev)
        one_s.append(time.perf_counter() - t0)
    comp = ex.compact(c, keep)
    kept = int(keep.sum())
    same_index = (np.array_equal(one.index.row_ptr, comp.index.row_ptr)
                  and np.array_equal(one.index.col_idx, comp.index.col_idx))
    equal = same_index and bool(torch.equal(comp.data, one.data))
    ms = cuda_median_ms(lambda: ex.step(a.data, b.data), reps=10)
    log(f"  13c complex128 filtered step: kept {kept} of {ex.c_index.nblks} blocks (share "
        f"{kept / ex.c_index.nblks:.4f}), one-shot kept {one.nblks}; compact() equal to the "
        f"one-shot element for element: {equal}; step {ms:.3f} ms (CUDA-event median), plan "
        f"{t_plan:.1f} s, one-shot {one_s[0]:.2f} s cold, {one_s[1]:.3f} s warm")
    if not (kept == one.nblks and equal and 0 < kept < ex.c_index.nblks):
        fail("13c: the filtered step disagrees with the one-shot filtered multiply")


def phase_complex_tensor(dev) -> None:
    """13d: shape R in complex128 through ``BatchedContract`` (KC2 the only
    launches), bitwise equal to the folded 2-D executor, against the
    kernel's plain version and a host complex128 recomputation of 256
    sampled blocks."""
    import torch

    from dbcsr_tpu_torch.tensors import BatchedContract

    t0 = time.perf_counter()
    a, b = ri_tensors(TENSOR_ATOMS, dev, torch.complex128)
    sync(dev)
    ma, mb = a.matrix, b.matrix
    t_set = time.perf_counter() - t0
    reset_launches()
    batch = BatchedContract()
    out = batch.contract(a, b, **R_KW)
    sync(dev)
    launched = {k: n for k, n in read_launches().items() if n}
    if set(launched) != {"KC2"}:
        fail(f"13d: BatchedContract launched {launched}, expected KC2 only")
    (fn, _, _), = batch._tas._cache.values()
    if fn.plan.route != "c_stack" or not torch.equal(out.matrix.data, fn(ma.data, mb.data)):
        fail(f"13d: route {fn.plan.route}, or BatchedContract and the folded executor differ")
    kern, a_in, b_in = kernel_vs_plain("13d KC2", fn.plan, ma.data, mb.data, F64_RTOL)
    serr, srel = sampled_block_check(out.matrix, ma, mb)
    ms = cuda_median_ms(lambda: batch.contract(a, b, **R_KW), reps=10)
    kms = cuda_median_ms(lambda: kern(a_in, b_in), reps=10)
    tp = fn.plan.tile_plan
    bound_ms, by = complex_bound((ma.data.shape[0], mb.data.shape[0], tp.n_c_tiles,
                                  len(tp.stack)), 128, "complex128")
    log(f"  13d shape R complex128 ({TENSOR_ATOMS} atoms, set-up {t_set:.1f} s): launches "
        f"{launched}; S={len(tp.stack)}; vs host complex128 (256 blocks) max_abs_err="
        f"{serr:.3e} rel={srel:.2e} (bound {F64_RTOL:.0e}); BatchedContract {ms:.3f} ms, "
        f"KC2 {kms:.3f} ms (bound {bound_ms:.3f} ms by {by}: {bound_ms / kms:.1%})")
    if not srel <= F64_RTOL:
        fail("13d: shape R in complex128 disagrees with the host recomputation")
    batch.finalize()


def phase_complex_perf(dev) -> None:
    """13e: the H2O recipe with data type 7 (complex128) and a complex
    alpha, written to a temporary file and run as ``python -m
    dbcsr_tpu_torch.perf`` runs it: the dense route (no stack kernel), its
    checksum against a host complex128 recomputation."""
    import tempfile

    from dbcsr_tpu_torch.perf import parse_perf, run_perf

    with open(os.path.join(REPO, "tests", "inputs", "H2O.perf")) as f:
        lines = f.read().splitlines()
    at = {line: i for i, line in enumerate(lines) if line.startswith("#")}
    lines[at["# data type"] + 1] = "7"
    lines[at["# alpha"] + 2] = "0.5d0"  # alpha = 1 + 0.5i
    lines = lines[:at["# checksum"]] + ["F"]  # its references are the float64 recipe's
    with tempfile.NamedTemporaryFile("w", suffix=".perf", delete=False) as f:
        f.write("\n".join(lines) + "\n")
        path = f.name
    try:
        cfg = parse_perf(path)
        before = read_launches()
        t0 = time.perf_counter()
        res = run_perf(cfg, device=dev, seed=0, verbose=False)
        secs = time.perf_counter() - t0
    finally:
        os.remove(path)
    expect_launches("13e H2O complex128", before, None)
    ref = perf_reference_checksum(cfg)
    rel = abs(res["checksum"] - ref) / max(abs(ref), 1e-300)
    log(f"  13e H2O.perf as data type 7 (alpha {cfg.alpha}, beta {cfg.beta}), nrep "
        f"{cfg.nrep}: mean {res['mean_time_s'] * 1e3:.3f} ms, best "
        f"{res['best_time_s'] * 1e3:.3f} ms, steady {res['steady_time_s'] * 1e3:.3f} ms, route "
        f"{res['route']}; checksum {res['checksum']:.15e} vs host complex128 rel {rel:.2e} "
        f"(bound 1e-12); {secs:.1f} s")
    if res["route"] != "dense" or not rel <= 1e-12:
        fail("13e: the complex128 recipe took another route or its checksum disagrees")


def phase_complex(dev) -> dict:
    """Phase 13: 13a-13e; returns 13a's rows by kernel."""
    import torch

    rows, (a, b, c) = phase_complex_main(dev)
    phase_complex_hermitian(dev, a, b, c)
    del a, b, c
    torch.cuda.empty_cache()
    phase_complex_filtered(dev)
    torch.cuda.empty_cache()
    phase_complex_tensor(dev)
    torch.cuda.empty_cache()
    phase_complex_perf(dev)
    return rows


# ---------------------------------------------------------------------------
# phase 14: the distributed multiply on virtual ranks of the one card
# ---------------------------------------------------------------------------

#: phase 14c: rows of the element-granular Cannon leg (its plan keeps int64
#: maps over every stored element: 24.6 M for A here, 246 M at 400,000)
DIST_ELEMENT_ROWS = 40_000
#: the dist kernels by store type, and the bound each leg is held to
DIST_KERNEL = {"float32": "K1", "float64": "K6", "complex128": "KC2"}
DIST_RTOL = {"float32": KERNEL_RTOL, "float64": F64_RTOL, "complex128": F64_RTOL}


def dist_grid(shape, dev):
    """A grid of ``shape`` whose ranks are all ``dev``."""
    from dbcsr_tpu_torch.dist import ProcessGrid

    return ProcessGrid.make(*shape, devices=[dev] * 8)


def dist_breakdown(fn, a, b) -> dict:
    """CUDA-event medians of a distributed executor's parts on the same
    inputs: the packing of the ranks' pieces, the ticks (kernel launches,
    the adds into the C panels, the ring hand-overs and the layer sums) and
    the unpacking into C's store."""
    from dbcsr_tpu_torch.mm.engine import _op_store

    ex = fn.exec
    a_st = _op_store(a.data, ex.a_perm)
    b_st = _op_store(b.data, ex.b_perm)
    pa, pb = ex.pack_a(a_st), ex.pack_b(b_st)
    panels = ex.plan.run(pa, pb, a.dtype)
    return {
        "pack": cuda_median_ms(lambda: (ex.pack_a(a_st), ex.pack_b(b_st)), reps=5),
        "ticks": cuda_median_ms(lambda: ex.plan.run(pa, pb, a.dtype), reps=5),
        "unpack": cuda_median_ms(lambda: ex.unpack(panels), reps=5),
    }


def dist_leg(what: str, fn, a, b, ref, c_index, local_plan, tname: str,
             local_ms: float, plan_s: float, rows: dict, keep: bool = False) -> None:
    """One distributed executor against the local executor's product
    ``ref``: its dtype's kernel must be the only launch, once per non-empty
    (rank, tick) stack; two calls bitwise equal; the product against ``ref``
    and a host float64 recomputation of 64 sampled tiles; CUDA-event
    medians of the executor and its parts. With ``keep`` the product's
    digest, sampled tiles and their host recomputation stay in
    ``rows[(what, tname)]["c"]`` (phase 17 holds its processes against
    them)."""
    import torch

    kname = DIST_KERNEL[tname]
    rtol = DIST_RTOL[tname]
    before = read_launches()
    out = fn(a.data, b.data)
    sync(out.device)
    launched = launch_delta(before)
    if launched != {kname: fn.plan.launches} or fn.plan.launches < 1:
        fail(f"14 {what}: launches {launched}, expected {kname} x {fn.plan.launches}")
    same = bool(torch.equal(out, fn(a.data, b.data)))
    err, rel = rel_err(out, ref)
    picks, host = sampled_f64_tiles(local_plan, c_index, a.data, b.data)
    tiles = out[picks].cpu()
    serr, srel = rel_err(tiles, host)
    ms = cuda_median_ms(lambda: fn(a.data, b.data), reps=5)
    parts = dist_breakdown(fn, a, b)
    rp = fn.plan
    log(f"  14 {what} {tname}: {rp.algo}, {rp.grid.size} ranks, n_a {rp.n_a} n_b {rp.n_b} "
        f"n_c {rp.n_c} tiles per rank, S {rp.n_stack} over {rp.launches} {kname} launches; "
        f"host plan {plan_s:.2f} s; two calls bitwise equal {same}; vs local executor "
        f"rel={rel:.2e}, vs host float64 (64 tiles) rel={srel:.2e} (bound {rtol:.0e}); "
        f"executor {ms:.3f} ms (pack {parts['pack']:.3f}, ticks {parts['ticks']:.3f}, "
        f"unpack {parts['unpack']:.3f}) against the local executor {local_ms:.3f} ms "
        f"({ms / local_ms:.2f}x)")
    if not (same and rel <= rtol and srel <= rtol):
        fail(f"14 {what} {tname}: the distributed product disagrees with its references")
    rows[(what, tname)] = {"ms": ms, "launches": rp.launches, "max_abs_err": err, **parts}
    if keep:
        rows[(what, tname)]["c"] = {"digest": store_digest(out), "picks": picks,
                                    "tiles": tiles, "host": host}


def phase_dist_cannon(dev, rows: dict) -> None:
    """14a and 14b at the banded SCF shape (MAIN_ROWS rows, T = 128):
    Cannon on a 2×2 grid in float32 (K1 ticks) and float64 (the float64
    kernel's ticks), then, in float32, the 8-rank dryrun: 2.5D Cannon
    2×2×2, SUMMA 2×4 and 2.5D SUMMA 2×2×2; every leg against the local
    ``stack`` executor. The one-shot ``multiply(dist=...)`` prints the
    message statistics (``record_comm``)."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.stats import get_stats, reset_stats
    from dbcsr_tpu_torch.dist import tile_aligned_dist

    legs = {torch.float32: [("14a 2x2", (2, 2, 1), "cannon"),
                            ("14b 2x2x2", (2, 2, 2), "cannon"),
                            ("14b 2x4", (2, 4, 1), "summa"),
                            ("14b 2x2x2", (2, 2, 2), "summa")],
            torch.float64: [("14a 2x2", (2, 2, 1), "cannon")]}
    for dtype, cases in legs.items():
        tname = str(dtype)[6:]
        a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=dtype)
        with dt.config_override(mm_driver="stack"):
            lfn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
        ref = lfn(a.data, b.data)
        local_ms = cuda_median_ms(lambda: lfn(a.data, b.data), reps=5)
        rbs = a.row_block_sizes
        for what, shape, algo in cases:
            dist = tile_aligned_dist(dist_grid(shape, dev), rbs, rbs, 128)
            t0 = time.perf_counter()
            fn, ci, _ = dt.build_distributed_executor("N", "N", a, b, dist, algo=algo)
            plan_s = time.perf_counter() - t0
            if not (np.array_equal(ci.row_ptr, c_index.row_ptr)
                    and np.array_equal(ci.col_idx, c_index.col_idx)):
                fail(f"14 {what}: the distributed C index differs from the local one")
            dist_leg(what, fn, a, b, ref, c_index, lfn.plan, tname, local_ms, plan_s, rows,
                     keep=what == "14a 2x2")
            del fn
            torch.cuda.empty_cache()
        if dtype == torch.float32:
            # the one-shot multiply(dist=...) (tiled plan) and its messages
            dist = tile_aligned_dist(dist_grid((2, 2, 1), dev), rbs, rbs, 128)
            reset_stats()
            t0 = time.perf_counter()
            before = read_launches()
            c = dt.multiply("N", "N", 1.0, a, b, dist=dist)
            sync(dev)
            one_s = time.perf_counter() - t0
            launched = launch_delta(before)
            err, rel = rel_err(c.data, ref)
            msgs = {k: (n, round(v)) for k, (n, v) in sorted(get_stats().comm_msgs.items())}
            total = sum(v for _, v in msgs.values())
            log(f"  14a one-shot multiply(dist=2x2) {tname}: {one_s:.2f} s cold, launches "
                f"{launched}, vs local rel={rel:.2e}; record_comm {msgs} ({total / 1e9:.3f} GB "
                f"between ranks, none of it moved: the ranks share the card)")
            if launched.keys() != {"K1"} or not rel <= KERNEL_RTOL or c.dist is not dist:
                fail("14a: the one-shot multiply(dist=...) disagrees or ran another kernel")
            del c
        del a, b, ref, lfn
        torch.cuda.empty_cache()
        log(f"    peak device memory so far {peak_memory(dev) / 1e9:.2f} GB")


def phase_dist_oneshot(dev, rows: dict) -> None:
    """14c: the one-shot ``multiply(dist=...)`` with a block-cyclic
    distribution through the element-granular Cannon plan at
    DIST_ELEMENT_ROWS rows (float32, ``filter_eps`` = 1e-9, as the dryrun
    passes it) against the local one-shot multiply; then a complex128
    Cannon executor on a 2×2 grid at MAIN_ROWS rows (KC2 ticks) against the
    local complex128 executor."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.dist import block_cyclic_dist

    a, b, _ = banded_scf_matrices(DIST_ELEMENT_ROWS, dev)
    dist = block_cyclic_dist(dist_grid((2, 2, 1), dev), a.nblkrows, a.nblkcols)
    ref = dt.multiply("N", "N", 1.0, a, b, filter_eps=1e-9)
    first = None
    for call in ("cold", "warm"):
        t0 = time.perf_counter()
        before = read_launches()
        with dt.config_override(use_tiled_cannon=False):
            c = dt.multiply("N", "N", 1.0, a, b, dist=dist, filter_eps=1e-9)
        sync(dev)
        wall = time.perf_counter() - t0
        launched = launch_delta(before)
        same_index = (np.array_equal(c.index.row_ptr, ref.index.row_ptr)
                      and np.array_equal(c.index.col_idx, ref.index.col_idx))
        err, rel = rel_err(c.data, ref.data) if same_index else (float("inf"),) * 2
        log(f"  14c element-granular Cannon 2x2, block-cyclic, {DIST_ELEMENT_ROWS} rows, "
            f"float32, filter_eps=1e-9 ({call}): {wall:.2f} s, launches {launched}, "
            f"{c.nblks} blocks kept (local {ref.nblks}), vs local one-shot rel={rel:.2e}")
        if not (same_index and rel <= KERNEL_RTOL and set(launched) == {"K1"}):
            fail("14c: the element-granular Cannon product disagrees or ran another kernel")
        if first is not None and not torch.equal(c.data, first):
            fail("14c: the warm call differs from the cold one")
        first = c.data
    rows[("14c element 2x2", "float32")] = {"launches": launched.get("K1", 0), "max_abs_err": err}
    del a, b, c, ref, first
    torch.cuda.empty_cache()

    from dbcsr_tpu_torch.dist import tile_aligned_dist

    a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=torch.complex128)
    lfn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
    ref = lfn(a.data, b.data)
    local_ms = cuda_median_ms(lambda: lfn(a.data, b.data), reps=5)
    dist = tile_aligned_dist(dist_grid((2, 2, 1), dev), a.row_block_sizes,
                             a.row_block_sizes, 128)
    t0 = time.perf_counter()
    fn, _, _ = dt.build_distributed_executor("N", "N", a, b, dist)
    dist_leg("14c 2x2", fn, a, b, ref, c_index, lfn.plan, "complex128", local_ms,
             time.perf_counter() - t0, rows)
    del a, b, ref, lfn, fn
    torch.cuda.empty_cache()


def phase_dist_sharded(dev, rows: dict) -> None:
    """14d: the sharded at-rest form in float64 at MAIN_ROWS rows (phase
    7's decayed operands): ``shard_matrix``, ``build_sharded_multiply`` (the
    float64 kernel's ticks, the only launches) against the local executor,
    then ``sharded_filter`` / ``sharded_trace`` / ``sharded_frobenius``
    against the local ops, and a ``sharded_checkpoint_write/read`` round
    trip, bitwise."""
    import tempfile

    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.dist import (
        build_sharded_multiply, shard_matrix, sharded_checkpoint_read,
        sharded_checkpoint_write, sharded_filter, sharded_frobenius, sharded_trace,
        tile_aligned_dist,
    )
    from dbcsr_tpu_torch.dist.sharded_ops import ShardedMatrix

    a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=torch.float64, decay=DECAY)
    lfn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
    ref = lfn(a.data, b.data)
    local_ms = cuda_median_ms(lambda: lfn(a.data, b.data), reps=5)
    rbs = a.row_block_sizes
    dist = tile_aligned_dist(dist_grid((2, 2, 1), dev), rbs, rbs, 128)
    t0 = time.perf_counter()
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    sync(dev)
    t_shard = time.perf_counter() - t0
    t0 = time.perf_counter()
    ci, c_sl, fn = build_sharded_multiply("N", "N", sa, sb)
    plan_s = time.perf_counter() - t0
    before = read_launches()
    out = fn(sa.data, sb.data)
    sync(dev)
    launched = launch_delta(before)
    if launched != {"K6": fn.plan.launches}:
        fail(f"14d: launches {launched}, expected K6 x {fn.plan.launches}")
    same = all(torch.equal(x, y) for x, y in zip(out, fn(sa.data, sb.data)))
    sc = ShardedMatrix(name="C", index=ci, tile=128, dist=dist, shard=c_sl, data=out)
    err, rel = rel_err(sc.to_local().data, ref)
    ms = cuda_median_ms(lambda: fn(sa.data, sb.data), reps=5)
    log(f"  14d sharded float64 2x2: shard_matrix A, B {t_shard:.2f} s; plan {plan_s:.2f} s; "
        f"{fn.plan.launches} K6 launches; two calls bitwise equal {same}; vs local executor "
        f"rel={rel:.2e} (bound {F64_RTOL:.0e}); sharded multiply {ms:.3f} ms against the local "
        f"executor {local_ms:.3f} ms")
    if not (same and rel <= F64_RTOL):
        fail("14d: the sharded product disagrees with the local one")
    rows[("14d sharded 2x2", "float64")] = {"ms": ms, "launches": fn.plan.launches,
                                            "max_abs_err": err}
    c_loc = dt.BCSRMatrix(name="C", index=c_index, data=ref)
    t0 = time.perf_counter()
    fs = sharded_filter(sc, FILTER_EPS)
    sync(dev)
    t_f = time.perf_counter() - t0
    fl = dt.filter_blocks(c_loc, FILTER_EPS)
    f_err, f_rel = rel_err(fs.to_local().data, fl.data) if fs.nblks == fl.nblks else (
        float("inf"),) * 2
    tr, tr_ref = sharded_trace(sc), dt.trace(c_loc)
    fr, fr_ref = sharded_frobenius(sc), dt.norm_frobenius(c_loc)
    log(f"  14d sharded_filter(eps={FILTER_EPS:g}) {t_f:.2f} s: {fs.nblks} of {sc.nblks} "
        f"blocks kept (local {fl.nblks}), rel={f_rel:.2e}; trace {tr:.12e} vs {tr_ref:.12e}; "
        f"frobenius {fr:.12e} vs {fr_ref:.12e}")
    if not (fs.nblks == fl.nblks and f_rel <= F64_RTOL
            and abs(tr - tr_ref) <= F64_RTOL * max(abs(tr_ref), 1.0)
            and abs(fr - fr_ref) <= F64_RTOL * fr_ref):
        fail("14d: the sharded ops disagree with the local ones")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        sharded_checkpoint_write(sa, d)
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = sharded_checkpoint_read(d, dist.grid)
        sync(dev)
        t_r = time.perf_counter() - t0
    same_ck = all(torch.equal(x, y) for x, y in zip(back.data, sa.data))
    gb = sum(x.numel() * x.element_size() for x in sa.data) / 1e9
    log(f"  14d sharded checkpoint of A ({gb:.2f} GB in {len(sa.data)} shards): write "
        f"{t_w:.2f} s, read {t_r:.2f} s, bitwise {same_ck}")
    if not same_ck:
        fail("14d: the sharded checkpoint did not read back bitwise")
    del a, b, sa, sb, sc, out, ref, lfn, fs, fl, c_loc, back
    torch.cuda.empty_cache()


def phase_dist_tas(dev, rows: dict) -> None:
    """14e: shape R through ``tas_multiply_parallel`` (``long_dim="auto"``,
    ``nsplit=4`` over four cuda ranks) in float32 and float64 against
    ``BatchedContract``'s product: one launch of the dtype's stack kernel a
    group; then ``contract`` over the 2×2 grid of a ``TensorPGrid``
    (Cannon, K1 ticks) in float32."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.tas import tas_multiply_parallel
    from dbcsr_tpu_torch.tensors import BatchedContract, TensorPGrid, contract

    for dtype in (torch.float32, torch.float64):
        tname = str(dtype)[6:]
        kname = "K6" if dtype == torch.float64 else "K1"
        rtol = DIST_RTOL[tname]
        a, b = ri_tensors(TENSOR_ATOMS, dev, dtype)
        ref = BatchedContract().contract(a, b, **R_KW).matrix
        ranks = [dev] * 4
        t0 = time.perf_counter()
        before = read_launches()
        c = tas_multiply_parallel(a.matrix, b.matrix, long_dim="auto", nsplit=4,
                                  devices=ranks)
        sync(dev)
        first = time.perf_counter() - t0
        launched = launch_delta(before)
        same_index = (np.array_equal(c.index.row_ptr, ref.index.row_ptr)
                      and np.array_equal(c.index.col_idx, ref.index.col_idx))
        err, rel = rel_err(c.data, ref.data) if same_index else (float("inf"),) * 2
        t0 = time.perf_counter()
        again = tas_multiply_parallel(a.matrix, b.matrix, long_dim="auto", nsplit=4,
                                      devices=ranks)
        sync(dev)
        warm = time.perf_counter() - t0
        if not torch.equal(again.data, c.data):
            fail(f"14e {tname}: two calls of tas_multiply_parallel differ")
        del again
        log(f"  14e shape R {tname}: tas_multiply_parallel(auto, nsplit=4, 4 ranks) "
            f"{first:.2f} s first, {warm:.2f} s warm; launches {launched}; vs BatchedContract "
            f"rel={rel:.2e} (bound {rtol:.0e})")
        if not (same_index and rel <= rtol and set(launched) == {kname}
                and launched[kname] == 4):
            fail(f"14e {tname}: tas_multiply_parallel disagrees or its groups did not each "
                 f"launch {kname} once")
        rows[("14e tas 4 groups", tname)] = {"launches": launched.get(kname, 0),
                                             "max_abs_err": err}
        if dtype == torch.float32:
            pgrid = TensorPGrid.make(3, dims=(2, 2, 1), devices=ranks)
            dist = dt.dist.tile_aligned_dist(pgrid.grid, a.matrix.row_block_sizes,
                                             b.block_sizes[1], 128)
            before = read_launches()
            t0 = time.perf_counter()
            ct = contract(1.0, a, b, dist=dist, nsplit=1, **R_KW).matrix
            sync(dev)
            wall = time.perf_counter() - t0
            launched = launch_delta(before)
            err, rel = rel_err(ct.data, ref.data) if ct.nblks == ref.nblks else (
                float("inf"),) * 2
            log(f"  14e contract over TensorPGrid dims (2, 2, 1) (grid 2x2, Cannon): "
                f"{wall:.2f} s cold, launches {launched}, vs BatchedContract rel={rel:.2e}")
            if not (rel <= rtol and set(launched) == {"K1"}):
                fail("14e: contract over the TensorPGrid disagrees or ran another kernel")
            del ct
        del a, b, ref, c
        torch.cuda.empty_cache()


def phase_dist(dev) -> dict:
    """Phase 14: every leg's launches are counted from 0, set just before
    the phase and read after it."""
    rows: dict = {}
    reset_launches()
    phase_dist_cannon(dev, rows)
    phase_dist_oneshot(dev, rows)
    phase_dist_sharded(dev, rows)
    phase_dist_tas(dev, rows)
    launched = {k: n for k, n in read_launches().items() if n}
    log(f"  phase 14 launches: {launched}")
    for k in ("K1", "K6", "KC2"):
        if not launched.get(k):
            fail(f"phase 14 launched no {k}")
    rows["launches"] = launched
    return rows


# ---------------------------------------------------------------------------
# phase 15: the C API on the card
# ---------------------------------------------------------------------------

#: phase 15a: warm ``c_dbcsr_multiply_d`` calls timed, each beside a Python
#: one-shot ``multiply`` on the same operands (the two in turns)
CAPI_WARM_REPS = 10

#: phase 15a: a C library over the port's shim, built into a shared object and
#: loaded with ctypes (``CDLL``: the GIL is released around each call and the
#: shim takes it back). ``scf_capi_build`` makes A and B from host blocks
#: (block b of each at ``offsets[b]`` of its data) through
#: ``c_dbcsr_create_new``, ``c_dbcsr_reserve_blocks``,
#: ``c_dbcsr_put_block2d_d`` and ``c_dbcsr_finalize``, and C as an empty
#: template of A, and reports the seconds of the puts and of finalize;
#: ``scf_capi_multiply`` is one ``c_dbcsr_multiply_d('N', 'N', 1, A, B, 0, C)``.
CAPI_SCF_C = r"""
#include <stdint.h>
#include <time.h>

#include "dbcsr_tpu.h"

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

static int build(const char *name, int nblk, const int *sizes, int n,
                 const int *rows, const int *cols, const int64_t *offsets,
                 const double *data, int64_t *out, double *seconds) {
  int64_t m = 0;
  if (c_dbcsr_create_new(&m, name, 0, 'N', sizes, nblk, sizes, nblk,
                         dbcsr_type_real_8))
    return 1;
  double t0 = now();
  if (c_dbcsr_reserve_blocks(m, rows, cols, n)) return 1;
  for (int b = 0; b < n; ++b)
    if (c_dbcsr_put_block2d_d(m, rows[b], cols[b], data + offsets[b],
                              sizes[rows[b]], sizes[cols[b]], 0))
      return 1;
  double t1 = now();
  if (c_dbcsr_finalize(m)) return 1;
  seconds[0] += t1 - t0;
  seconds[1] += now() - t1;
  *out = m;
  return 0;
}

int scf_capi_build(int nblk, const int *sizes, int n, const int *rows,
                   const int *cols, const int64_t *offsets,
                   const double *a_data, const double *b_data,
                   int64_t *handles, double *seconds) {
  seconds[0] = seconds[1] = 0.0;
  if (build("A", nblk, sizes, n, rows, cols, offsets, a_data, &handles[0],
            seconds) ||
      build("B", nblk, sizes, n, rows, cols, offsets, b_data, &handles[1],
            seconds))
    return 1;
  if (c_dbcsr_create_template(&handles[2], "C", handles[0], 0, 'N',
                              dbcsr_type_real_8))
    return 1;
  return c_dbcsr_finalize(handles[2]);
}

int scf_capi_multiply(const int64_t *handles, double *flop) {
  return c_dbcsr_multiply_d('N', 'N', 1.0, 0.0, handles[0], handles[1], 0.0,
                            0.0, handles[2], 0, -1.0, flop);
}
"""


def c_test_program(name: str) -> str:
    """A C program of the C API tests (``tests/test_capi_v2.py``), read as a
    string constant without running the file."""
    import ast

    with open(os.path.join(REPO, "tests", "test_capi_v2.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    fail(f"tests/test_capi_v2.py has no {name}")


def build_c(text: str, out: str, shim: str, hdr: str, *flags: str) -> str:
    """Compile ``text`` against the port's header and shim (gcc)."""
    with open(out + ".c", "w") as f:
        f.write(text)
    res = subprocess.run(
        ["gcc", "-O2", *flags, out + ".c", shim, f"-I{hdr}",
         f"-Wl,-rpath,{os.path.dirname(shim)}", "-o", out],
        capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        fail(f"gcc {os.path.basename(out)}.c: {res.stderr.strip()[-2000:]}")
    return out


def capi_env(device: str) -> dict:
    """A C program's environment: this interpreter's module path for the
    Python it embeds, and the shim's device."""
    paths = [REPO] + [p for p in sys.path if p and os.path.isdir(p)]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths), DBCSR_CAPI_DEVICE=device)


def capi_device(dev) -> str:
    """``DBCSR_CAPI_DEVICE`` for ``dev``."""
    return "cpu" if dev.type == "cpu" else f"cuda:{dev.index}"


def event_ms(fn):
    """(device ms between CUDA events around one call, its result)."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), out


def c_stdout(fn):
    """(fn(), what C code wrote to standard output meanwhile)."""
    import ctypes
    import tempfile

    libc = ctypes.CDLL(None)
    libc.fflush.argtypes = [ctypes.c_void_p]
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile(mode="w+") as f:
        os.dup2(f.fileno(), 1)
        try:
            rc = fn()
        finally:
            libc.fflush(None)
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return rc, f.read()


def host_trace_ab(idx, a_host, b_host) -> tuple:
    """(trace(A·B), Σ|A_ik·B_ki|) on the host in float64 from the flat data
    of A and B over one block index, block by block."""
    n = idx.nblkrows
    keys = idx.blk_rows.astype(np.int64) * n + idx.col_idx
    order = np.argsort(keys)
    skeys = keys[order]
    tkeys = idx.col_idx.astype(np.int64) * n + idx.blk_rows
    pos = np.minimum(np.searchsorted(skeys, tkeys), len(skeys) - 1)
    hit = skeys[pos] == tkeys
    bm, bn = idx.blk_shapes
    off = idx.blk_offset
    total = absum = 0.0
    for ia, ib in zip(np.flatnonzero(hit), order[pos[hit]]):
        pa = a_host[off[ia]:off[ia + 1]].reshape(bm[ia], bn[ia])
        pb = b_host[off[ib]:off[ib + 1]].reshape(bm[ib], bn[ib])
        p = pa * pb.T
        total += float(p.sum())
        absum += float(np.abs(p).sum())
    return total, absum


def host_sampled_blocks(c_idx, c_host, idx, a_host, b_host, n_samples=64, seed=1) -> tuple:
    """Sampled blocks of C = A·B recomputed on the host in float64 from the
    flat data of A and B (one block index): (max |err|, that over max |ref|)."""
    bm, bn = idx.blk_shapes
    off = idx.blk_offset
    cbm, cbn = c_idx.blk_shapes
    picks = np.random.default_rng(seed).choice(c_idx.nblks, size=min(n_samples, c_idx.nblks),
                                               replace=False)
    err = scale = 0.0
    for p in picks:
        i, j = int(c_idx.blk_rows[p]), int(c_idx.col_idx[p])
        ref = np.zeros((cbm[p], cbn[p]))
        for q in range(int(idx.row_ptr[i]), int(idx.row_ptr[i + 1])):
            k = int(idx.col_idx[q])
            r = idx.block_id(k, j)
            if r >= 0:
                ref += (a_host[off[q]:off[q + 1]].reshape(bm[q], bn[q])
                        @ b_host[off[r]:off[r + 1]].reshape(bm[r], bn[r]))
        got = c_host[c_idx.blk_offset[p]:c_idx.blk_offset[p + 1]].reshape(ref.shape)
        err = max(err, float(np.abs(got - ref).max()))
        scale = max(scale, float(np.abs(ref).max()))
    return err, err / (scale or 1.0)


def phase_capi_scf(dev, shim: str, hdr: str, work: str, card: str) -> dict:
    """15a: the float64 SCF product at full width through the C API, in
    this process, against the Python one-shot ``multiply`` on the same
    operands: bitwise, the float64 kernel the only launch, once a call."""
    import ctypes

    import torch

    import dbcsr_tpu_torch as dt

    i64, i32, dbl, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    os.environ["DBCSR_CAPI_DEVICE"] = capi_device(dev)
    lib = ctypes.CDLL(shim)  # not PyDLL: the shim takes the GIL itself
    lib.c_dbcsr_last_error.restype = ctypes.c_char_p
    lib.c_dbcsr_last_error.argtypes = []
    lib.c_dbcsr_init_lib.argtypes = []
    lib.c_dbcsr_get_data_d.argtypes = [i64, vp, i32, ctypes.POINTER(i64)]
    lib.c_dbcsr_get_num_blocks.argtypes = [i64, ctypes.POINTER(i32)]
    lib.c_dbcsr_checksum.argtypes = [i64, i32, ctypes.POINTER(dbl)]
    lib.c_dbcsr_trace_d.argtypes = [i64, ctypes.POINTER(dbl), ctypes.POINTER(dbl)]
    lib.c_dbcsr_release.argtypes = [i64]
    scf = ctypes.CDLL(build_c(CAPI_SCF_C, os.path.join(work, "scf_capi.so"), shim, hdr,
                              "-shared", "-fPIC"))
    scf.scf_capi_build.argtypes = [i32, vp, i32, vp, vp, vp, vp, vp,
                                   ctypes.POINTER(i64), ctypes.POINTER(dbl)]
    scf.scf_capi_multiply.argtypes = [ctypes.POINTER(i64), ctypes.POINTER(dbl)]

    def check(rc, what):
        if rc != 0:
            fail(f"15a {what}: {lib.c_dbcsr_last_error().decode()}")

    def ptr(arr):
        return arr.ctypes.data_as(vp)

    check(lib.c_dbcsr_init_lib(), "c_dbcsr_init_lib")
    t0 = time.perf_counter()
    a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=torch.float64)
    idx = a.index
    a_host, b_host = a.flat_host(), b.flat_host()  # float64, in index order
    sizes = np.ascontiguousarray(idx.row_block_sizes, dtype=np.int32)
    brow = np.ascontiguousarray(idx.blk_rows, dtype=np.int32)
    bcol = np.ascontiguousarray(idx.col_idx, dtype=np.int32)
    offs = np.ascontiguousarray(idx.blk_offset[:-1], dtype=np.int64)
    log(f"  15a operands (phase 7's float64 call, no decay): {MAIN_ROWS} rows, {idx.nblks} "
        f"blocks, {a.data.shape[0]} tiles ({a.data.numel() * 8 / 1e9:.2f} GB each), host "
        f"copies {a_host.nbytes / 1e9:.2f} GB each; {time.perf_counter() - t0:.1f} s")

    handles = (i64 * 3)()
    secs = (dbl * 2)()
    t0 = time.perf_counter()
    check(scf.scf_capi_build(len(sizes), ptr(sizes), idx.nblks, ptr(brow), ptr(bcol),
                             ptr(offs), ptr(a_host), ptr(b_host), handles, secs),
          "scf_capi_build")
    setup_s = time.perf_counter() - t0
    log(f"  15a C-side set-up: puts {secs[0]:.3f} s, finalize {secs[1]:.3f} s (A and B, "
        f"{2 * idx.nblks} blocks through c_dbcsr_put_block2d_d), build call {setup_s:.3f} s")

    def c_data(h: int, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        size = i64()
        check(lib.c_dbcsr_get_data_d(h, ptr(out), n, ctypes.byref(size)), "c_dbcsr_get_data_d")
        if size.value != n:
            fail(f"15a c_dbcsr_get_data_d: {size.value} elements, expected {n}")
        return out

    if not np.array_equal(c_data(handles[0], a_host.size), a_host):
        fail("15a A read back through c_dbcsr_get_data_d differs from the host blocks put")

    c0 = dt.BCSRMatrix.empty(sizes, sizes, device=dev, dtype=torch.float64, tile=a.tile,
                             name="C")
    flop = dbl()

    def c_multiply():
        check(scf.scf_capi_multiply(handles, ctypes.byref(flop)), "c_dbcsr_multiply_d")

    def py_fresh():
        return dt.multiply("N", "N", 1.0, a, b, 0.0, c0, return_flops=True)

    # the C handle holds the previous product, which the next call takes as
    # its C (beta = 0): the Python twin of a warm call does the same
    py_state = {}

    def py_reused():
        py_state["out"] = dt.multiply("N", "N", 1.0, a, b, 0.0, py_state["out"][0],
                                      return_flops=True)
        return py_state["out"]

    def one(fn, what):
        reset_launches()
        ms, out = event_ms(fn)
        launched = {k: n for k, n in read_launches().items() if n}
        if launched != {"K6": 1}:
            fail(f"15a {what} launched {launched}, expected the float64 kernel once")
        return ms, out

    cold_ms, _ = one(c_multiply, "the cold c_dbcsr_multiply_d")
    first_py_ms, py_state["out"] = one(py_fresh, "the first Python multiply")
    times = {c_multiply: [], py_reused: [], py_fresh: []}
    order = list(times)
    for r in range(CAPI_WARM_REPS):
        for fn in order[r % 3:] + order[:r % 3]:  # each first in turn
            ms, out = one(fn, "a warm call")
            times[fn].append(ms)
    c_ms, py_ms, fresh_ms = times[c_multiply], times[py_reused], times[py_fresh]
    ref, ref_flops = py_state["out"]
    nblks = i32()
    check(lib.c_dbcsr_get_num_blocks(handles[2], ctypes.byref(nblks)), "c_dbcsr_get_num_blocks")
    ref_host = ref.flat_host()
    got = c_data(handles[2], ref_host.size)
    fresh_host = py_fresh()[0].flat_host()
    if nblks.value != ref.nblks or not (np.array_equal(got, ref_host)
                                        and np.array_equal(got, fresh_host)):
        fail(f"15a the C API's product ({nblks.value} blocks) is not bitwise the Python "
             f"multiply's ({ref.nblks} blocks)")
    if flop.value != float(ref_flops):
        fail(f"15a flops {flop.value} from C, {ref_flops} from Python")
    cks, tr_re, tr_im = dbl(), dbl(), dbl()
    check(lib.c_dbcsr_checksum(handles[2], 0, ctypes.byref(cks)), "c_dbcsr_checksum")
    check(lib.c_dbcsr_trace_d(handles[2], ctypes.byref(tr_re), ctypes.byref(tr_im)),
          "c_dbcsr_trace_d")
    t0 = time.perf_counter()
    host_cks = float(np.dot(got, got))
    host_tr, tr_scale = host_trace_ab(idx, a_host, b_host)
    s_err, s_rel = host_sampled_blocks(ref.index, got, idx, a_host, b_host)
    host_s = time.perf_counter() - t0
    cks_rel = abs(cks.value - host_cks) / host_cks
    tr_rel = abs(tr_re.value - host_tr) / tr_scale
    log(f"  15a c_dbcsr_checksum {cks.value!r} (host {host_cks!r}, rel {cks_rel:.2e}); "
        f"c_dbcsr_trace_d {tr_re.value!r} (host float64 {host_tr!r}, err over Σ|terms| "
        f"{tr_rel:.2e}); 64 sampled blocks vs host float64: rel {s_rel:.2e} ({host_s:.1f} s)")
    if not (cks_rel <= F64_RTOL and tr_rel <= F64_RTOL and s_rel <= F64_RTOL):
        fail("15a the C API's product disagrees with the host float64 recomputation")
    for h in handles:
        check(lib.c_dbcsr_release(h), "c_dbcsr_release")
    row = {"setup_put_s": secs[0], "setup_finalize_s": secs[1], "setup_s": setup_s,
           "cold_ms": cold_ms, "first_py_ms": first_py_ms,
           "warm_ms": float(np.median(c_ms)), "py_ms": float(np.median(py_ms)),
           "fresh_ms": float(np.median(fresh_ms)), "c_ms_all": c_ms, "py_ms_all": py_ms,
           "fresh_ms_all": fresh_ms, "nblks": ref.nblks,
           "checksum": cks.value, "trace": tr_re.value, "sampled_rel": s_rel}
    log(f"  15a c_dbcsr_multiply_d: cold {cold_ms:.3f} ms (empty C; plans the pattern), "
        f"warm median {row['warm_ms']:.3f} ms over {CAPI_WARM_REPS} (C = the previous "
        f"product, beta 0); Python one-shot multiply: first {first_py_ms:.3f} ms (empty C), "
        f"warm median {row['py_ms']:.3f} ms with the previous product as C, "
        f"{row['fresh_ms']:.3f} ms with an empty C; the shim's overhead "
        f"{row['warm_ms'] - row['py_ms']:+.3f} ms a call; {ref.nblks} C blocks, bitwise "
        f"equal; the float64 kernel once a call, nothing else [{card}]")
    log(f"      warm C ms {[round(x, 3) for x in c_ms]}")
    log(f"      warm Python ms (previous C) {[round(x, 3) for x in py_ms]}")
    log(f"      warm Python ms (empty C) {[round(x, 3) for x in fresh_ms]}")
    del a, b, ref, c0, py_state, out, fresh_host
    return row


def phase_capi(dev, card: str) -> dict:
    """Phase 15: the C API on the card. (a) the float64 SCF product at the
    phase-4 shape from C in this process; (b) ``examples/example_6_c_api.c``
    as a program of its own on the card; (c) the typed sweep of
    ``tests/test_capi_v2.py`` (``MATRIX_PROGRAM``) in this process under
    ``mm_driver="panel"``, where its d, s, z and c products take the float64
    kernel, K2, KC2 and KC1, each launched once."""
    import ctypes
    import shutil
    import tempfile

    import torch

    from dbcsr_tpu_torch.capi import build_capi, header_path
    from dbcsr_tpu_torch.core.config import config_override

    t_phase = time.perf_counter()
    shim = build_capi()
    if shim is None:
        fail("the C API shim (dbcsr_tpu_torch/capi, gcc and a shared libpython) did not build")
    hdr = os.path.dirname(header_path())
    work = tempfile.mkdtemp(prefix="capi_")
    try:
        row = phase_capi_scf(dev, shim, hdr, work, card)
        torch.cuda.empty_cache()

        with open(os.path.join(REPO, "examples", "example_6_c_api.c")) as f:
            exe = build_c(f.read(), os.path.join(work, "example_6"), shim, hdr)
        t0 = time.perf_counter()
        res = subprocess.run([exe], capture_output=True, text=True, timeout=600, cwd=work,
                             env=capi_env(capi_device(dev)))
        row["example_s"] = time.perf_counter() - t0
        if res.returncode != 0 or not res.stdout.startswith("C = A*A^T: "):
            fail(f"15b example_6_c_api.c on the card: rc {res.returncode}: "
                 f"{res.stdout.strip()} {res.stderr.strip()[-2000:]}")
        log(f"  15b example_6_c_api.c (DBCSR_CAPI_DEVICE={capi_device(dev)}), rc 0 in "
            f"{row['example_s']:.1f} s: {res.stdout.strip()}")

        prog = ctypes.CDLL(build_c(c_test_program("MATRIX_PROGRAM"),
                                   os.path.join(work, "typed_sweep.so"), shim, hdr,
                                   "-shared", "-fPIC", "-Dmain=typed_sweep_main"))
        prog.typed_sweep_main.argtypes = []
        prog.typed_sweep_main.restype = ctypes.c_int
        reset_launches()
        with config_override(mm_driver="panel"):
            rc, out = c_stdout(prog.typed_sweep_main)
        launched = {k: n for k, n in read_launches().items() if n}
        lines = out.strip().splitlines()
        if rc != 0 or not lines or lines[-1] != "OK" or [ln.split()[0] for ln in lines[:4]] != [
                "d", "s", "z", "c"]:
            fail(f"15c the typed sweep: rc {rc}: {out.strip()}")
        if launched != {"K6": 1, "K2": 1, "KC2": 1, "KC1": 1}:
            fail(f"15c the typed sweep launched {launched}: expected the float64 kernel, K2, "
                 f"KC2 and KC1 once each")
        log(f"  15c typed sweep (MATRIX_PROGRAM of tests/test_capi_v2.py, mm_driver=panel): rc "
            f"0, launches {launched}")
        for ln in lines[:4]:
            log(f"      {ln}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t_phase
    return row


# ---------------------------------------------------------------------------
# phase 16: the tuned ``auto``
# ---------------------------------------------------------------------------

#: the panel knobs of a tuned row, which the engine applies with its driver
#: (the row's precision and bf16 knobs are not applied)
TUNED_PANEL_KNOBS = ("panel_c_win", "panel_cache", "panel_chunk", "panel_runlen")
#: 16b: the sweep's rows at the banded_fine class, one for each kernel, every
#: other knob at its default (two grids: the runlen axis only under panel)
SWEEP_GRIDS = ({"mm_driver": ["stack", "grouped", "band"]},
               {"mm_driver": ["panel"], "panel_runlen": [0, 3]})
SWEEP_CLASS = "banded_fine"


def tuned_knobs(best: dict) -> dict:
    """The explicit config that reproduces what ``auto`` takes from a
    tuned row: its driver and its panel knobs."""
    return {"mm_driver": best["mm_driver"],
            **{k: best[k] for k in TUNED_PANEL_KNOBS if k in best}}


def phase_tuned_sweep(dev, card: str) -> dict:
    """16b: ``autotune.sweep`` on the card at the banded_fine class, one row
    each of K1-K5; every timed call of a row must launch its route's kernel
    once and nothing else. Then each row's kernel alone against its plain
    version, both timed, beside the bound and ``torch.sparse.mm`` on the
    same operands. Returns {kernel: row of the kernels line}."""
    import torch

    from dbcsr_tpu_torch import autotune

    orig = autotune.steady_state_time
    swept = {}

    def checked(fn, args, **kw):
        calls = [0]

        def counted(*xs):
            calls[0] += 1
            return fn(*xs)

        before = read_launches()
        t = orig(counted, args, **kw)
        sync(dev)
        want = ROUTE_KERNEL[fn.plan.route]
        delta = launch_delta(before)
        if delta != {want: calls[0]}:
            fail(f"16b sweep row {fn.plan.route}: launches {delta}, expected {want} "
                 f"once a call ({calls[0]} calls)")
        swept[want] = (fn, args, delta.get(want, 0))
        return t

    autotune.steady_state_time = checked
    try:
        rows = []
        for grid in SWEEP_GRIDS:
            table = autotune.sweep(grid=grid, workloads=[SWEEP_CLASS], device=dev,
                                   verbose=False)
            rows += table["results"][SWEEP_CLASS]["all"]
    finally:
        autotune.steady_state_time = orig
    if set(swept) != {"K1", "K2", "K3", "K4", "K5"} or len(rows) != 5:
        fail(f"16b the sweep's rows ran {sorted(swept)} ({len(rows)} rows), expected K1-K5")
    log(f"  16b sweep of {SWEEP_CLASS} on the card [{card}]:")
    for r in sorted(rows, key=lambda r: -r["gflops"]):
        knobs = {k: v for k, v in r.items() if k not in ("route", "gflops")}
        log(f"      {r['route']:10s} {r['gflops']:9.1f} GFLOP/s  {knobs}")

    a, b = autotune.WORKLOADS[SWEEP_CLASS](0, dev)
    ac, bc = element_csr(a), element_csr(b)
    lib = cuda_median_ms(lambda: torch.sparse.mm(ac, bc), reps=3, warmup=1)
    del ac, bc
    out = {}
    for kname, (fn, args, launched) in sorted(swept.items()):
        plan = fn.plan
        a_in, b_in = (x.to(plan.in_dtype) for x in plan.op_stores(*args))
        kern = kernel_of(plan)
        err, rel = rel_err(kern(a_in, b_in), plain_of(plan, *args))
        if not rel <= KERNEL_RTOL:
            fail(f"16b {kname} disagrees with its plain version (rel {rel:.2e})")
        ms = cuda_median_ms(lambda: kern(a_in, b_in), reps=10)
        plain_ms = cuda_median_ms(lambda: plain_of(plan, *args), reps=3, warmup=1)
        counts = plan_counts(a, b, plan)
        bound_ms, bound_by = kernel_bound(*counts, 128, 4, 4, "float32")
        log(f"      {kname} ({plan.route}) alone {ms:.4f} ms, plain {plain_ms:.4f}, vs plain "
            f"max_abs_err={err:.3e} rel={rel:.2e}; " + rate_line("kernel", ms, counts, "float32"))
        out[kname] = {"launches": launched, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": lib}
    log(f"      torch.sparse.mm (CSR x CSR) on the same operands {lib:.4f} ms")
    return out


def untuned_executor(dev, table, a, b):
    """The executor ``auto`` builds for A·B with the card's table held off
    (and put back after)."""
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch import autotune
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    kind = autotune.device_kind(dev)
    autotune._TABLE_CACHE[kind] = None
    get_plan_cache().clear()
    try:
        fn, _, _ = dt.build_multiply_executor("N", "N", a, b)
    finally:
        autotune._TABLE_CACHE[kind] = table
        get_plan_cache().clear()
    return fn


def tuned_vs_untuned(what: str, fn, fu, a, b, eff: float, card: str) -> float:
    """CUDA-event medians of the tuned and the untuned executor, in turns
    (untuned, tuned, tuned, untuned). Returns the tuned median (ms)."""
    u1 = cuda_median_ms(lambda: fu(a.data, b.data), reps=10)
    t1 = cuda_median_ms(lambda: fn(a.data, b.data), reps=10)
    t2 = cuda_median_ms(lambda: fn(a.data, b.data), reps=10)
    u2 = cuda_median_ms(lambda: fu(a.data, b.data), reps=10)
    tm, um = float(np.median([t1, t2])), float(np.median([u1, u2]))
    log(f"      {what} executor medians [{card}]: tuned auto ({fn.plan.route}) {tm:.4f} ms "
        f"(runs {t1:.4f}/{t2:.4f}), {eff / tm / 1e6:.1f} GFLOP/s; untuned auto "
        f"({fu.plan.route}) {um:.4f} ms (runs {u1:.4f}/{u2:.4f}), {eff / um / 1e6:.1f} GFLOP/s")
    return tm


def phase_tuned_auto(dev, card: str) -> dict:
    """16c: ``auto`` at default provenance at the phase-4 shape takes the
    table's driver for the nearest class; its product bitwise the explicit
    driver's with the same knobs and against the plain version; its
    CUDA-event median beside the untuned auto's (phase 4's K2 leg), in
    turns. 16d: shape R's float32 fold at default provenance, its route and
    nearest class, against the plain version, and its median beside the
    untuned auto's. Returns the launches of the two products (the phase's
    main path)."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch import autotune
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    table = autotune._cached_table(dev)
    launches = {}
    t0 = time.perf_counter()
    a, b = autotune._mk_banded(MAIN_ROWS)(0, dev)
    cls, dist = autotune.nearest_class(autotune.workload_features(a.index, b.index), table)
    best = table["results"][cls]["best"]
    get_plan_cache().clear()  # a cold build, as phase 18b's
    t1 = time.perf_counter()
    fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b)
    PHASE16["build_s"] = time.perf_counter() - t1
    log(f"  16c {MAIN_ROWS} rows: nearest class {cls} at distance {dist:.4f}, its best row "
        f"{best}; auto takes route {fn.plan.route} (set-up and plan "
        f"{time.perf_counter() - t0:.1f} s)")
    if fn.plan.route.replace("panel_runs", "panel") != best["mm_driver"]:
        fail(f"16c auto took {fn.plan.route}, the table's driver for {cls} is "
             f"{best['mm_driver']}")
    before = read_launches()
    got = fn(a.data, b.data)
    sync(dev)
    launches.update(expect_launches("16c tuned auto", before, ROUTE_KERNEL[fn.plan.route], 1))
    with dt.config_override(**tuned_knobs(best)):
        fx, _, _ = dt.build_multiply_executor("N", "N", a, b)
    same = fx.plan.route == fn.plan.route and bool(torch.equal(got, fx(a.data, b.data)))
    ref = take_tiles(plain_of(fn.plan, a.data, b.data),
                     fn.plan.align_map(store_layout(c_index, 128).tile_keys()), 128)
    err, rel = rel_err(got, ref)
    del ref, fx
    log(f"      bitwise the explicit {tuned_knobs(best)}: {same}; vs plain max_abs_err="
        f"{err:.3e} rel={rel:.2e} (bound {KERNEL_RTOL:.0e})")
    if not same or not rel <= KERNEL_RTOL:
        fail("16c the tuned auto's product disagrees with the explicit driver's or the plain "
             "version")
    fu = untuned_executor(dev, table, a, b)
    if fu.plan.route != "panel":
        fail(f"16c the untuned auto took {fu.plan.route}, not phase 4's panel route")
    PHASE16["exec_ms"] = tuned_vs_untuned("16c", fn, fu, a, b, eff, card)
    PHASE16["route"] = fn.plan.route
    del a, b, fn, fu, got
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ta, tb = ri_tensors(TENSOR_ATOMS, dev, torch.float32)
    ma, mb = ta.matrix, tb.matrix
    cls, dist = autotune.nearest_class(autotune.workload_features(ma.index, mb.index), table)
    fr, _, eff = dt.build_multiply_executor("N", "N", ma, mb)
    log(f"  16d shape R float32 fold ({TENSOR_ATOMS} atoms): nearest class {cls} at distance "
        f"{dist:.4f} (best {table['results'][cls]['best']['mm_driver']}); auto takes route "
        f"{fr.plan.route} (set-up and plan {time.perf_counter() - t0:.1f} s)")
    before = read_launches()
    fr(ma.data, mb.data)
    sync(dev)
    delta = expect_launches("16d shape R", before, ROUTE_KERNEL[fr.plan.route], 1)
    for k, n in delta.items():
        launches[k] = launches.get(k, 0) + n
    kernel_vs_plain("16d shape R's kernel", fr.plan, ma.data, mb.data, KERNEL_RTOL)
    tuned_vs_untuned("16d", fr, untuned_executor(dev, table, ma, mb), ma, mb, eff, card)
    return launches


def phase_tuned(dev, card: str) -> tuple:
    """Phase 16: load the committed table for this card (fail without one),
    then 16b, 16c and 16d. Returns (the 16b rows by kernel, the launches of
    16c and 16d)."""
    from dbcsr_tpu_torch import autotune

    table = autotune._cached_table(dev)
    if table is None:
        fail(f"16a no committed parameter table for {autotune.device_kind(dev)} "
             f"(dbcsr_tpu_torch/params/)")
    log(f"  16a table for {table['device_kind']}: classes "
        + ", ".join(f"{c} -> {r['best']['mm_driver']}" for c, r in table["results"].items()))
    return phase_tuned_sweep(dev, card), phase_tuned_auto(dev, card)


# ---------------------------------------------------------------------------
# phase 17: the multi-process distributed multiply (torch.distributed)
# ---------------------------------------------------------------------------

#: leg (b)'s shape: the banded SCF pattern at 12,000 rows (the autotune
#: class banded_fine's size), cut from phase 14(c)'s 40,000 so that the
#: phase keeps within its budget (at 40,000 rows it took 93 s, at 20,000
#: 90 s), and shape R's chain for the contraction over a TensorPGrid cut to
#: this many atoms
MP_ROWS_B = 12_000
MP_TENSOR_ATOMS = 120
#: a leg's deadline (s): a hang or a lost peer fails the phase, never the run's limit
MP_TIMEOUT = 300
#: timed calls of leg (a)'s executors (the first call before them warms it up)
MP_REPS = 3
#: what the phase may cost (s); printed beside its time
MP_BUDGET_S = 90


def store_digest(x) -> str:
    """blake2b digest of a tensor's bytes (on the host)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def plan_digest(hp) -> str:
    """blake2b digest of a distributed executor's host plan."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for arr in (hp.stacks, hp.a_pack, hp.b_pack, hp.c_unpack):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def mp_spawn(fn, nprocs: int, args: tuple, what: str) -> None:
    """``nprocs`` workers of ``fn(pid, *args)`` through torch.multiprocessing
    (start method spawn), joined against one deadline; a failed worker, or
    the deadline, kills the others and fails the run."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")
    deadline = time.perf_counter() + MP_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
            if time.perf_counter() > deadline:
                fail(f"17 {what}: the workers did not finish within {MP_TIMEOUT} s")
    except Exception as e:  # a worker raised or exited non-zero
        fail(f"17 {what}: a worker failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)


def mp_init(pid: int, nprocs: int, url: str, backend: str, device: str):
    """A worker's start: the repository on the path, the world brought up,
    the card's tuned table held off as in phases 3-15. Returns the
    process's device and its start-up seconds."""
    import torch

    sys.path.insert(0, REPO)
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch import autotune
    from dbcsr_tpu_torch.dist import comm

    t0 = time.perf_counter()
    dt.init_lib(distributed=True, coordinator_address=url, num_processes=nprocs,
                process_id=pid, backend=backend, device=device)
    dev = comm.device()
    autotune._TABLE_CACHE[torch.cuda.get_device_name(dev)] = None
    return dev, time.perf_counter() - t0


def mp_timed_calls(ex, a_data, b_data, reps: int, first) -> dict:
    """CUDA-event medians over the same ``reps`` calls of a warm
    distributed executor and of its parts: pack (this process's
    ranks' pieces), ticks (launches, adds, ring shifts, layer sums) and
    unpack (every process's C panels into the whole store); transfers =
    the host seconds inside ``dist/comm.py`` a call (staging included),
    which lie inside ticks and unpack. ``bitwise``: every call's C equals
    ``first``, the store of the call before them."""
    import torch

    from dbcsr_tpu_torch.dist import comm
    from dbcsr_tpu_torch.mm.engine import _op_store
    from dbcsr_tpu_torch.mm.kernels import accumulator_dtype

    acc = accumulator_dtype(a_data.dtype)
    rows = {"ms": [], "pack": [], "ticks": [], "unpack": [], "transfers": []}
    same = True
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        s0 = comm.transfer_counts().seconds
        ev[0].record()
        pa = ex.pack_a(_op_store(a_data, ex.a_perm))
        pb = ex.pack_b(_op_store(b_data, ex.b_perm))
        ev[1].record()
        panels = ex.plan.run(pa, pb, a_data.dtype)
        ev[2].record()
        c = ex.unpack(panels, acc)
        ev[3].record()
        ev[3].synchronize()
        same = same and bool(torch.equal(c, first))
        rows["ms"].append(ev[0].elapsed_time(ev[3]))
        rows["pack"].append(ev[0].elapsed_time(ev[1]))
        rows["ticks"].append(ev[1].elapsed_time(ev[2]))
        rows["unpack"].append(ev[2].elapsed_time(ev[3]))
        rows["transfers"].append((comm.transfer_counts().seconds - s0) * 1e3)
        del pa, pb, panels, c
    return {"bitwise": same, **{k: float(np.median(v)) for k, v in rows.items()}}


def mp_leg_a(pid: int, nprocs: int, url: str, work: str, refs: dict, backend: str,
             devices: list) -> None:
    """Leg (a)/(c) worker: phase 4's banded SCF operands at MAIN_ROWS rows,
    Cannon 2×2 over the world (two ranks a process) in float32 (K1 ticks)
    and float64 (the float64 kernel's), held against phase 14's
    single-process executor (``refs``: digest, sampled tiles, their host
    float64 recomputation). With gloo on one card it first asks for nccl,
    which must refuse two processes on one card, naming gloo."""
    import torch

    sys.path.insert(0, REPO)
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.core.errors import DbcsrError
    from dbcsr_tpu_torch.dist import ProcessGrid, comm, tile_aligned_dist

    res = {}
    if backend == "gloo" and len(set(devices)) == 1:
        try:
            dt.init_lib(distributed=True, coordinator_address=url + "_nccl",
                        num_processes=nprocs, process_id=pid, backend="nccl",
                        device=devices[pid])
            res["nccl_refusal"] = "none: nccl came up with two processes on one card"
        except DbcsrError as e:
            res["nccl_refusal"] = str(e)
    dev, res["init_s"] = mp_init(pid, nprocs, url, backend, devices[pid])
    for tname in ("float32", "float64"):
        ref = refs[tname]
        t0 = time.perf_counter()
        a, b, _ = banded_scf_matrices(MAIN_ROWS, dev, dtype=getattr(torch, tname))
        sync(dev)
        r = {"operands_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        dist = tile_aligned_dist(ProcessGrid.make(2, 2), a.row_block_sizes,
                                 a.row_block_sizes, 128)
        fn, _, _ = dt.build_distributed_executor("N", "N", a, b, dist, algo="cannon")
        r["plan_s"] = time.perf_counter() - t0
        r["plan_digest"] = plan_digest(fn.host_plan)
        r["ranks"] = [list(rk) for rk in dist.grid.local_ranks()]
        r["planned_launches"] = fn.plan.launches
        reset_launches()
        comm.reset_transfer_counts()
        out = fn(a.data, b.data)
        sync(dev)
        r["launches"] = {k: n for k, n in read_launches().items() if n}
        moved = comm.transfer_counts()
        r["moved"] = {"messages": moved.messages, "bytes_sent": moved.bytes_sent,
                      "bytes_received": moved.bytes_received}
        r["digest"] = store_digest(out)
        tiles = out[ref["picks"]].cpu()
        r["tiles_bitwise"] = bool(torch.equal(tiles, ref["tiles"]))
        r["host_rel"] = rel_err(tiles, ref["host"])[1]
        r.update(mp_timed_calls(fn.exec, a.data, b.data, MP_REPS, out))
        del out
        res[tname] = r
        del a, b, fn
        torch.cuda.empty_cache()
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    with open(os.path.join(work, f"a_{pid}.json"), "w") as f:
        json.dump(res, f)
    dt.finalize_lib()


def mp_leg_b_run(dev, ckpt_dir: str) -> dict:
    """Leg (b)'s products at MP_ROWS_B rows on grids that ``ProcessGrid.make``
    deals: in the parent (no world) the single-process virtual ranks of
    ``dev``, in a worker the ranks of the world. Returns, by leg, the
    result's digest (scalars as they are) and this process's launches."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.dist import (
        ProcessGrid, build_sharded_multiply, shard_matrix, sharded_checkpoint_read,
        sharded_checkpoint_write, sharded_filter, sharded_frobenius, sharded_trace,
        tile_aligned_dist,
    )
    from dbcsr_tpu_torch.dist.sharded_ops import ShardedMatrix
    from dbcsr_tpu_torch.tas import tas_multiply_parallel
    from dbcsr_tpu_torch.tensors import TensorPGrid, contract

    def grid(*shape):
        return ProcessGrid.make(*shape, devices=[dev] * int(np.prod(shape)))

    out = {}

    def record(name, run):
        before = read_launches()
        val = run()
        sync(dev)
        out[name] = {"launches": launch_delta(before), **val}

    a, b, _ = banded_scf_matrices(MP_ROWS_B, dev)
    rbs = a.row_block_sizes
    for name, shape, algo in (("2.5D Cannon 2x2x2", (2, 2, 2), "cannon"),
                              ("SUMMA 2x4", (2, 4), "summa")):
        dist = tile_aligned_dist(grid(*shape), rbs, rbs, 128)
        fn, _, _ = dt.build_distributed_executor("N", "N", a, b, dist, algo=algo)
        record(name, lambda: {"digest": store_digest(fn(a.data, b.data)),
                              "plan_digest": plan_digest(fn.host_plan)})
    record("TAS 4 groups", lambda: {"digest": store_digest(tas_multiply_parallel(
        a, b, long_dim="auto", nsplit=4, devices=[dev] * 4).data)})
    del a, b
    a, b, _ = banded_scf_matrices(MP_ROWS_B, dev, dtype=torch.complex128)
    dist = tile_aligned_dist(grid(2, 2), rbs, rbs, 128)
    fn, _, _ = dt.build_distributed_executor("N", "N", a, b, dist, algo="cannon")
    record("Cannon 2x2 complex128", lambda: {"digest": store_digest(fn(a.data, b.data))})
    del a, b, fn
    a, b, _ = banded_scf_matrices(MP_ROWS_B, dev, dtype=torch.float64, decay=DECAY)
    sa, sb = shard_matrix(a, dist), shard_matrix(b, dist)
    ci, c_sl, sfn = build_sharded_multiply("N", "N", sa, sb)

    def sharded():
        sc = ShardedMatrix(name="C", index=ci, tile=128, dist=dist, shard=c_sl,
                           data=sfn(sa.data, sb.data), dtype=torch.float64)
        fs = sharded_filter(sc, FILTER_EPS)
        return {"digest": store_digest(sc.to_local().data),
                "filtered": store_digest(fs.to_local().data), "kept": fs.nblks,
                "trace": sharded_trace(sc), "frobenius": sharded_frobenius(sc)}

    record("sharded float64 2x2", sharded)
    sharded_checkpoint_write(sa, ckpt_dir)
    back = sharded_checkpoint_read(ckpt_dir, dist.grid)
    out["checkpoint"] = {
        "launches": {}, "shards": sum(x is not None for x in sa.data),
        "bitwise": all((x is None and y is None) or bool(torch.equal(x, y))
                       for x, y in zip(back.data, sa.data))}
    del a, b, sa, sb, back
    ta, tb = ri_tensors(MP_TENSOR_ATOMS, dev, torch.float32)
    pgrid = TensorPGrid.make(3, dims=(2, 2, 1), devices=[dev] * 4)
    tdist = tile_aligned_dist(pgrid.grid, ta.matrix.row_block_sizes, tb.block_sizes[1],
                              128)
    record("contract over TensorPGrid 2x2", lambda: {"digest": store_digest(contract(
        1.0, ta, tb, dist=tdist, nsplit=1, **R_KW).matrix.data)})
    return out


def mp_leg_b(pid: int, nprocs: int, url: str, work: str, backend: str,
             devices: list) -> None:
    """Leg (b) worker: ``mp_leg_b_run`` over the world."""
    import torch

    dev, init_s = mp_init(pid, nprocs, url, backend, devices[pid])
    reset_launches()
    t0 = time.perf_counter()
    res = mp_leg_b_run(dev, os.path.join(work, "ckpt_b"))
    res["_"] = {"init_s": init_s, "run_s": time.perf_counter() - t0,
                "launches": {k: n for k, n in read_launches().items() if n},
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    with open(os.path.join(work, f"b_{pid}.json"), "w") as f:
        json.dump(res, f)
    import dbcsr_tpu_torch as dt

    dt.finalize_lib()


def mp_check_a(what: str, work: str, nprocs: int, refs: dict, card: str) -> dict:
    """Read and check leg (a)'s (or (c)'s) workers; print their readings."""
    res = [json.load(open(os.path.join(work, f"a_{pid}.json"))) for pid in range(nprocs)]
    for tname, kname, rtol in (("float32", "K1", KERNEL_RTOL), ("float64", "K6", F64_RTOL)):
        rs = [r[tname] for r in res]
        for pid, r in enumerate(rs):
            moved = r["moved"]
            log(f"  {what} {tname} process {pid} (ranks {r['ranks']}): operands "
                f"{r['operands_s']:.2f} s, host plan {r['plan_s']:.2f} s; launches "
                f"{r['launches']} (planned {r['planned_launches']}); {moved['messages']} "
                f"messages a call, {moved['bytes_sent'] / 1e9:.4f} GB sent, "
                f"{moved['bytes_received'] / 1e9:.4f} GB received; bitwise the "
                f"single-process executor {r['digest'] == refs[tname]['digest']}, sampled "
                f"tiles bitwise {r['tiles_bitwise']}, vs host float64 (64 tiles) rel="
                f"{r['host_rel']:.2e} (bound {rtol:.0e}), the {MP_REPS} timed calls "
                f"bitwise the first {r['bitwise']}; executor {r['ms']:.3f} ms (pack {r['pack']:.3f}, "
                f"ticks {r['ticks']:.3f}, unpack {r['unpack']:.3f}; transfers "
                f"{r['transfers']:.3f} of host time) [{card}]")
            if not (r["digest"] == refs[tname]["digest"] and r["tiles_bitwise"]
                    and r["host_rel"] <= rtol and r["bitwise"]):
                fail(f"{what} {tname}: process {pid}'s product is not the single-process one")
            if r["launches"] != {kname: r["planned_launches"]} or r["planned_launches"] < 1:
                fail(f"{what} {tname}: process {pid} launched {r['launches']}, expected "
                     f"{kname} x {r['planned_launches']}")
        if len({r["plan_digest"] for r in rs}) != 1:
            fail(f"{what} {tname}: the processes built different plans")
    return {"launches": {k: [r[t]["launches"].get(k, 0) for r in res]
                         for t, k in (("float32", "K1"), ("float64", "K6"))},
            "ms": {t: max(r[t]["ms"] for r in res) for t in ("float32", "float64")},
            "nccl_refusal": [r.get("nccl_refusal") for r in res],
            "init_s": max(r["init_s"] for r in res),
            "peak_gb": max(r["peak_gb"] for r in res)}


def mp_check_b(what: str, work: str, nprocs: int, refs_b: dict) -> list:
    """Read and check leg (b)'s workers against the single-process results
    ``refs_b``; print their readings. Returns each process's launches."""
    res_b = [json.load(open(os.path.join(work, f"b_{pid}.json"))) for pid in range(nprocs)]
    for name, ref in refs_b.items():
        for pid, r in enumerate(res_b):
            got = r[name]
            same = {k: got[k] == v for k, v in ref.items() if k not in ("launches", "shards")}
            log(f"  {what} {name} process {pid}: launches {got['launches']}; equal to the "
                f"single-process result: {same}")
            if not all(same.values()):
                fail(f"{what} {name}: process {pid} differs from the single-process result")
    launched_b = [r["_"]["launches"] for r in res_b]
    for pid, r in enumerate(res_b):
        log(f"  {what} process {pid}: start-up {r['_']['init_s']:.2f} s, legs "
            f"{r['_']['run_s']:.2f} s, launches {r['_']['launches']}, peak device memory "
            f"{r['_']['peak_gb']:.2f} GB")
        if not all(r["_"]["launches"].get(k) for k in ("K1", "K6", "KC2")):
            fail(f"{what}: process {pid} launched {r['_']['launches']}: each of K1, K6, KC2 "
                 f"must run")
        if not r["checkpoint"]["shards"]:
            fail(f"{what}: process {pid} held no shard of the 2x2 grid")
    return launched_b


def phase_mp(dev, card: str, refs_a: dict) -> dict:
    """Phase 17: the multi-process form over torch.distributed, every
    worker spawned from this file; (a) two processes on cuda:0 over gloo at
    the phase-4 shape, (b) four at MP_ROWS_B rows, (c) NCCL one process a
    card when there are two cards. Returns the launches by leg."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dbcsr_mp_")
    one = [str(dev)] * 4
    torch.cuda.empty_cache()
    # (b)'s single-process references first: the same products on this
    # process's virtual ranks (the workers' kernels are the build above)
    t0 = time.perf_counter()
    reset_launches()
    refs_b = mp_leg_b_run(dev, os.path.join(work, "ckpt_single"))
    torch.cuda.empty_cache()
    log(f"  17b single-process references at {MP_ROWS_B} rows: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mp_spawn(mp_leg_a, 2, (2, f"file://{work}/a_rdzv", work, refs_a, "gloo", one), "a")
    log(f"  17a two processes on {one[0]} over gloo, Cannon 2x2 at {MAIN_ROWS} rows: "
        f"{time.perf_counter() - t0:.2f} s")
    row_a = mp_check_a("17a", work, 2, refs_a, card)
    for pid, msg in enumerate(row_a["nccl_refusal"]):
        log(f"  17a backend='nccl' with two processes on one card, process {pid}: {msg}")
        if not (msg and 'backend="gloo"' in msg):
            fail("17a: nccl with two processes on one card did not refuse, naming gloo")

    t0 = time.perf_counter()
    mp_spawn(mp_leg_b, 4, (4, f"file://{work}/b_rdzv", work, "gloo", one), "b")
    b_s = time.perf_counter() - t0
    launched_b = mp_check_b("17b", work, 4, refs_b)
    log(f"  17b four processes on {one[0]} over gloo at {MP_ROWS_B} rows: {b_s:.2f} s")

    row_c = None
    if torch.cuda.device_count() >= 2:
        cards = [f"cuda:{i}" for i in range(2)]
        t0 = time.perf_counter()
        mp_spawn(mp_leg_a, 2, (2, f"file://{work}/c_rdzv", work, refs_a, "nccl", cards),
                 "c")
        log(f"  17c two processes over nccl, one a card ({cards}): "
            f"{time.perf_counter() - t0:.2f} s")
        row_c = mp_check_a("17c", work, 2, refs_a, card)
    else:
        log(f"  17c the NCCL leg was not run: this machine has {torch.cuda.device_count()} "
            f"card and NCCL runs one process a card (not counted as passed)")
    shutil.rmtree(work, ignore_errors=True)
    took = time.perf_counter() - t_phase
    log(f"  phase 17 took {took:.1f} s (budget {MP_BUDGET_S} s"
        f"{'' if took <= MP_BUDGET_S else ', OVER'}); the slowest process's executor "
        f"{row_a['ms']['float32']:.3f} / {row_a['ms']['float64']:.3f} ms float32 / float64 "
        f"against phase 14's single-process {refs_a['float32']['ms']:.3f} / "
        f"{refs_a['float64']['ms']:.3f} ms [{card}]")
    return {"a": row_a["launches"], "b": launched_b,
            "c": None if row_c is None else row_c["launches"]}


# ---------------------------------------------------------------------------
# phase 18: the examples, the large-scale check, weak scaling
# ---------------------------------------------------------------------------

#: the port's counterparts of the JAX examples, in examples/torch/
EXAMPLES = ("example_1_create_multiply", "example_2_tensor_contraction",
            "example_3_sparse_1000", "example_5_purification", "example_8_reordering",
            "example_9_reference_example_3", "example_10_reference_tensor_example_2")
#: 18b: rows and band (blocks) of tools/torch/large_scale_check.py: 2.5x
#: phase 4's rows, ~73,000 blocks a side, a 7,813² tile grid at T = 128
#: (past the JAX package's native planner cap of 2^24 cells, inside the
#: port's); a fixed number, never shrunk at run time
LARGE_ROWS = 1_000_000
LARGE_BAND = 8
#: 18c: 23-row blocks a rank (the JAX tool's 64 is launch overhead on a
#: card), rounds and calls a round of tools/torch/weak_scaling.py
WS_BLOCKS, WS_ROUNDS, WS_REPS = 256, 5, 3
PHASE18_BUDGET_S = 60
#: phase 4's readings at MAIN_ROWS (set-up s: pattern, index, layout and
#: operands on the card; the untuned executors' build s) and phase 16c's
#: (the tuned auto's build s, median ms and route), beside phase 18b's
PHASE4 = {}
PHASE16 = {}


def port_program(sub: str, name: str):
    """Import ``sub/name.py`` (``examples/torch`` or ``tools/torch``) by
    its plain name, its directory on the path: workers that a program
    spawns import it again by that name."""
    import importlib

    path = os.path.join(REPO, *sub.split("/"))
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def phase_examples(dev) -> dict:
    """18a: each example in this process on the card, its output kept to
    its last line; example 9 again across two processes. Returns the
    launches of the in-process runs."""
    import contextlib
    import io

    launches = {}
    outs = {}
    for name in EXAMPLES:
        mod = port_program("examples/torch", name)
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(["--device", "cuda"])
        sync(dev)
        secs = time.perf_counter() - t0
        got = {k: n for k, n in read_launches().items() if n}
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        outs[name] = out
        route = out.get("route") or out.get("routes")
        extra = ""
        if name == "example_3_sparse_1000":
            extra = (f"; executor {out['ms']:.4f} ms ({out['clock']}), "
                     f"{out['launches'] or 'no kernel'} a call")
            if out["clock"] != "CUDA events":
                fail("18a example 3 was not timed by CUDA events")
        lines = buf.getvalue().strip().splitlines()
        log(f"  18a {name}: {secs:.2f} s, route {route}, launches {got or 'none'}{extra}; "
            f"last line: {lines[-1] if lines else ''}")
    one = outs["example_9_reference_example_3"]
    t0 = time.perf_counter()
    two = port_program("examples/torch", "example_9_reference_example_3").main(
        ["--device", "cuda", "--nprocs", "2", "--backend", "gloo"])
    same = two["digest"] == one["digest"] and two["checksum"] == one["checksum"]
    log(f"  18a example 9 with --nprocs 2 over gloo: {time.perf_counter() - t0:.2f} s, "
        f"process 0's launches {two['launches'] or 'none'}; C bitwise the "
        f"single-process one: {same}")
    if not same:
        fail("18a example 9 across two processes differs from the single-process product")
    return launches


def phase_large_scale(dev, card: str, rows4: dict) -> dict:
    """18b: tools/torch/large_scale_check.py at LARGE_ROWS, two legs.
    Returns the launches of the legs' executor calls."""
    import torch

    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles
    from dbcsr_tpu_torch.core.machine import m_memory

    lsc = port_program("tools/torch", "large_scale_check")
    peak_memory(dev)  # keep the run's peak before resetting torch's counter
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rss0 = m_memory()
    a, b, su = lsc.build(LARGE_ROWS, LARGE_BAND, dev)
    sync(dev)
    log(f"  18b {LARGE_ROWS} rows, band ±{LARGE_BAND}: {su['blocks']} blocks, tile grid "
        f"{su['tile_grid'][0]}², A/B {su['n_tiles']} tiles ({su['store_mb']} MB each); "
        f"pattern and index {su['setup_s']:.2f} s, store_layout {su['store_layout_s']:.2f} s, "
        f"set-up with the operands on the card {su['operands_s']:.2f} s against phase 4's "
        f"{PHASE4.get('setup_s', float('nan')):.2f} s at {MAIN_ROWS} rows "
        f"({su['operands_s'] / PHASE4.get('setup_s', float('nan')):.2f}x); native layout "
        f"{su['native_layout']}"
        f"{'' if su['native_layout'] else ' (the numpy path: a host-memory finding)'}")
    launches, prods = {}, {}
    for driver in ("auto", "stack"):
        leg, fn, c_index, prod = lsc.measure(a, b, driver)
        if not leg["launches"]:
            fail(f"18b {driver}: the executor launched no hand-written kernel")
        for k, n in leg["launches"].items():
            launches[k] = launches.get(k, 0) + n
        ref = take_tiles(plain_of(fn.plan, a.data, b.data),
                         fn.plan.align_map(store_layout(c_index, 128).tile_keys()), 128)
        sync(dev)
        err, rel = rel_err(prod, ref)
        del ref
        serr, srel = sampled_f64_check(fn.plan, prod, c_index, a.data, b.data)
        # the same driver at MAIN_ROWS: the tuned auto is phase 16c's, the
        # explicit stack phase 4's
        if driver == "auto":
            what, was = "phase 16c's tuned auto", PHASE16
        else:
            what, p4 = "phase 4's stack", rows4[("highest", driver)]
            was = {"route": p4["route"], "build_s": PHASE4[("highest", driver)],
                   "exec_ms": p4["exec_ms"]}
        build0, ms0 = was.get("build_s", float("nan")), was.get("exec_ms", float("nan"))
        tuned = leg["tuned_class"]
        log(f"  18b {driver}: route {leg['route']}"
            + (f" (tuned class {tuned['class']} at distance {tuned['distance']:.4f})"
               if tuned else "")
            + f", launches {leg['launches']} a call; first multiply "
            f"{leg['first_multiply_s']:.2f} s, executor build {leg['executor_build_s']:.2f} s "
            f"and first call {leg['executor_first_call_s']:.2f} s, executor median "
            f"{leg['executor_median_ms']:.4f} ms ({leg['clock']}); against {what} at "
            f"{MAIN_ROWS} rows ({was.get('route')}): build {build0:.2f} s "
            f"({leg['executor_build_s'] / build0:.2f}x), median {ms0:.4f} ms "
            f"({leg['executor_median_ms'] / ms0:.2f}x) for {LARGE_ROWS / MAIN_ROWS:.1f}x the "
            f"rows; {leg['eff_tflops']:.3f} effective TFLOP/s; C {leg['c_blocks']} blocks "
            f"[{card}]")
        log(f"      vs plain (whole store) max_abs_err={err:.3e} rel={rel:.2e}; vs float64 "
            f"(64 tiles) max_abs_err={serr:.3e} rel={srel:.2e} (bound {KERNEL_RTOL:.0e})")
        if not (rel <= KERNEL_RTOL and srel <= KERNEL_RTOL):
            fail(f"18b {driver} disagrees with its references")
        prods[driver] = (prod, c_index)
        if driver == "auto":
            legs_route, c_blocks = leg["route"], leg["c_blocks"]
        del fn
    (pa, ia), (ps, is_) = prods["auto"], prods["stack"]
    if store_layout(ia, 128).n_tiles != store_layout(is_, 128).n_tiles:
        fail("18b the two legs' C layouts differ")
    err, rel = rel_err(pa, ps)
    log(f"  18b auto against stack: max_abs_err={err:.3e} rel={rel:.2e} (bound "
        f"{KERNEL_RTOL:.0e}); host RSS {rss0 / 1e9:.2f} GB before the phase, "
        f"{m_memory() / 1e9:.2f} GB now; peak device memory of the two legs "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if not rel <= KERNEL_RTOL:
        fail("18b the auto and stack legs disagree")
    del a, b, prods, pa, ps
    torch.cuda.empty_cache()

    # the tool as a user runs it, in a process of its own: its host peak RSS
    # and device peak are the tool's alone (this process's include phases 1-17)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch", "large_scale_check.py"),
         str(LARGE_ROWS), str(LARGE_BAND), "--device", "cuda"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    if res.returncode != 0:
        fail(f"18b the tool as a program failed: {res.stderr[-2000:]}")
    own = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    log(f"  18b the tool as a program ({time.perf_counter() - t0:.1f} s with its start): "
        f"route {own['route']}, launches {own['launches']} a call, executor median "
        f"{own['executor_median_ms']:.4f} ms, set-up {own['operands_s']:.2f} s, first multiply "
        f"{own['first_multiply_s']:.2f} s, build {own['executor_build_s']:.2f} s and first "
        f"call {own['executor_first_call_s']:.2f} s; host peak "
        f"RSS {own['host_peak_rss_mb'] / 1e3:.2f} GB (sampled; the process high-water mark "
        f"reads {own['host_hwm_mb'] / 1e3:.2f} GB), peak device memory "
        f"{own['device_peak_mb'] / 1e3:.2f} GB [{card}]")
    if (own["blocks"], own["n_tiles"], own["c_blocks"]) != (su["blocks"], su["n_tiles"],
                                                            c_blocks) \
            or own["route"] != legs_route or not own["launches"]:
        fail("18b the tool as a program disagrees with the in-process auto leg")
    return launches


def phase_weak_scaling(dev, card: str) -> dict:
    """18c: tools/torch/weak_scaling.py over every card (and across as many
    processes with nccl) where there are two or more, else over four
    virtual ranks of the one card. Returns the launches of one n-rank call."""
    import torch

    ws = port_program("tools/torch", "weak_scaling")
    ncards = torch.cuda.device_count()
    legs = []
    if ncards >= 2:
        legs.append(("every card", lambda: ws.run(WS_BLOCKS, WS_ROUNDS, WS_REPS)))
        legs.append((f"{ncards} processes over nccl", lambda: ws.main(
            [str(WS_BLOCKS), str(WS_ROUNDS), str(WS_REPS), "--nprocs", str(ncards),
             "--backend", "nccl", "--device", "cuda"])))
    else:
        legs.append(("four virtual ranks of one card", lambda: ws.run(
            WS_BLOCKS, WS_ROUNDS, WS_REPS, devices=[dev], ranks=4)))
    launches = {}
    for what, leg in legs:
        t0 = time.perf_counter()
        out = leg()
        eff = out["weak_scaling_efficiency_median"]
        log(f"  18c {what}: {out['devices']} ranks, grid {out['grid']}, {out['processes']} "
            f"process(es), shared_device: {str(out['shared_device']).lower()}; t1 "
            f"{out['t_1dev_median_s'] * 1e3:.3f} ms, tn {out['t_ndev_median_s'] * 1e3:.3f} ms, "
            f"efficiency {eff:.3f} (IQR {out['efficiency_iqr'][0]:.3f}-"
            f"{out['efficiency_iqr'][1]:.3f})"
            + (f", x n {out['efficiency_x_n_median']:.3f} ({out['note']})"
               if out["shared_device"] else "")
            + f"; launches of an n-rank call {out['launches_n']}; "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        if not (0 < eff < float("inf")) or not out["launches_n"]:
            fail(f"18c {what}: efficiency {eff} or no kernel launched")
        for k, n in out["launches_n"].items():
            launches[k] = launches.get(k, 0) + n
    if ncards < 2:
        log(f"  18c the multi-card leg was not run: this machine has {ncards} card "
            f"(not counted as passed)")
    return launches


def phase_examples_tools(dev, card: str, rows4: dict) -> dict:
    """Phase 18. Returns its launches by leg."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    a = phase_examples(dev)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = phase_large_scale(dev, card, rows4)
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = phase_weak_scaling(dev, card)
    t_c = time.perf_counter() - t0
    took = time.perf_counter() - t_phase
    log(f"  phase 18 took {took:.1f} s (budget {PHASE18_BUDGET_S} s"
        f"{'' if took <= PHASE18_BUDGET_S else ', OVER'}): (a) {t_a:.1f} s, (b) {t_b:.1f} s, "
        f"(c) {t_c:.1f} s [{card}]")
    return {"a": a, "b": b, "c": c}


def element_csr(m):
    """The matrix as an element-level torch CSR tensor on its device (what
    ``torch.sparse.mm`` multiplies: cuSPARSE SpGEMM has no block format)."""
    import torch

    from dbcsr_tpu_torch.block.tileops import valid_mask

    lay = m.layout
    t = m.tile
    mask = valid_mask(m.index, t, m.device) > 0.5
    ti, i, j = mask.nonzero(as_tuple=True)
    tc = torch.as_tensor(lay.tile_coords.astype(np.int64), device=m.device)
    idx = torch.stack([tc[ti, 0] * t + i, tc[ti, 1] * t + j])
    coo = torch.sparse_coo_tensor(idx, m.data[mask], (lay.ntr * t, lay.ntc * t),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()  # coalesce sorts: the store is tile-major


def phase_library(dev, sizes) -> dict:
    """``torch.sparse.mm`` (CSR × CSR) on the banded SCF shape beside the
    port's executor, in one call each way: the only single PyTorch call that
    computes the same product. Float32 operands as phase 4's (K1-K5), then
    float64 operands as phase 7's (the float64 kernel), then complex64 and
    complex128 operands as phase 13's (KC1, KC2). It is timed here and used
    nowhere in the port. Returns {(type name, rows): ms or None}: None
    where cuSPARSE refuses the product for want of resources, or refuses a
    complex type (its message is logged); any other error ends the run, and
    after a refusal the executor must still reproduce its earlier result
    bitwise."""
    import torch

    import dbcsr_tpu_torch as dt

    def frob2(x):  # |x|_F² (a CSR tensor's values are no strided view: abs() copies)
        return float((x.abs() if x.is_complex() else x).double().square().sum())

    out = {}
    for dtype, decay in ((torch.float32, 0.0), (torch.float64, DECAY),
                         (torch.complex64, 0.0), (torch.complex128, 0.0)):
        name = str(dtype)[6:]
        for nrows in sizes:
            a, b, _ = banded_scf_matrices(nrows, dev, dtype=dtype, decay=decay)
            fn, c_index, _ = dt.build_multiply_executor("N", "N", a, b)
            ac, bc = element_csr(a), element_csr(b)
            first = fn(a.data, b.data)
            ex = cuda_median_ms(lambda: fn(a.data, b.data), reps=5)
            head = (f"  {name}, {nrows} rows ({ac._nnz()} stored elements, route "
                    f"{fn.plan.route}): executor {ex:.3f} ms")
            try:
                lib = cuda_median_ms(lambda: torch.sparse.mm(ac, bc), reps=3, warmup=1)
            except RuntimeError as e:
                msg = str(e)
                refused = "insufficient resources" in msg and "cusparseSpGEMM" in msg
                if not (refused or dtype.is_complex):
                    raise
                # the yardstick's refusal is a result, not the port's
                sync(dev)
                if not torch.equal(fn(a.data, b.data), first):
                    fail(f"the executor changed its result after cuSPARSE's refusal "
                         f"({name}, {nrows} rows)")
                out[(name, nrows)] = None
                log(f"{head}; torch.sparse.mm fails: {msg.splitlines()[0][:160]}")
            else:
                c = torch.sparse.mm(ac, bc)
                got, ref = frob2(first), frob2(c.values())
                log(f"{head}, torch.sparse.mm (CSR x CSR) {lib:.3f} ms "
                    f"({lib / ex:.1f}x the executor), |C|_F² {got:.6e} vs {ref:.6e}")
                if not abs(got - ref) <= 1e-4 * abs(ref):
                    fail(f"torch.sparse.mm and the executor disagree ({name}, {nrows} rows)")
                out[(name, nrows)] = lib
                del c
            if nrows == sizes[0]:
                # each kernel that computes this product, alone, at this size
                legs = ({"K1": {"mm_driver": "stack"}, "K2": {},
                         "K3": {"mm_driver": "panel", "panel_runlen": 4},
                         "K4": {"mm_driver": "grouped"}, "K5": {"mm_driver": "band"}}
                        if dtype == torch.float32 else {"auto": {}})
                times = []
                for kname, knobs in legs.items():
                    with dt.config_override(**knobs):
                        fk, _, _ = dt.build_multiply_executor("N", "N", a, b)
                    a_in, b_in = (x.to(fk.plan.in_dtype)
                                  for x in fk.plan.op_stores(a.data, b.data))
                    kern = kernel_of(fk.plan)
                    times.append(f"{kname} ({fk.plan.route}) "
                                 f"{cuda_median_ms(lambda: kern(a_in, b_in), reps=5):.3f} ms")
                    del fk, a_in, b_in
                log(f"    {name}, {nrows} rows, each kernel alone: " + ", ".join(times))
            del a, b, ac, bc, first, fn
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1, 2, 3, 5 and 8 only: build and check the kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "dbcsr_tpu_torch", "csrc")):
        fail("run from a checkout: dbcsr_tpu_torch/csrc is missing")
    sys.path.insert(0, REPO)
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch import _build
    from dbcsr_tpu_torch.mm.plancache import get_plan_cache

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {name}")
    dev = torch.device("cuda", 0)
    dt.init_lib()
    # phases 3-15 pin the untuned route decisions (and their readings stay
    # comparable with earlier runs): the card's tuned table is held off
    # until phase 16
    from dbcsr_tpu_torch import autotune
    autotune._TABLE_CACHE[name] = None

    # 2. build
    info = _build.build_kernels(verbose=True)
    log(f"[2] built {os.path.relpath(info.path, REPO)} in {info.seconds:.1f} s")
    regs = [int(w) for line in info.log.splitlines() if "registers" in line
            for w in line.split("Used ")[1].split()[:1]]
    spills = [line for line in info.log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    log(f"    ptxas: {len(regs)} kernel instantiations, {min(regs)}-{max(regs)} registers, "
        f"{len(spills)} with spills")
    for line in spills:
        log("    " + line.strip())
    # the redesigned kernels, each with its registers and spills
    entry_fn = ""
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            entry_fn = line.split("'")[1]
        elif "blocked_kernel" in entry_fn or "mma_kernel" in entry_fn:
            if "spill" in line or "Used" in line:
                log(f"    {entry_fn}: {line.strip().replace('ptxas info    : ', '')}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                fail(f"the pipelined kernel {entry_fn} spills registers")
            if "Used" in line:
                entry_fn = ""
    from dbcsr_tpu_torch.native import native_available
    if not native_available():
        fail("the native host planner (dbcsr_tpu_torch/native/stackbuild.cpp, g++) "
             "did not build: the numpy planner would change the set-up times")
    log("    native host planner: built")
    peaks = phase_calibration(dev)
    log(f"    this card from registers alone: FFMA {peaks['ffma']:.1f} TFLOP/s (data sheet "
        f"{PEAK_FLOPS['float32'] / 1e12:.0f}); FP64 mma m16n8k8 {peaks['dmma_m16n8k8']:.1f} TFLOP/s "
        f"(data sheet {PEAK_FLOPS['float64'] / 1e12:.0f}), m8n8k4 {peaks['dmma_m8n8k4']:.1f}")

    # 3. kernels against their plain versions
    log("[3] kernels vs plain versions on the card")
    k12_err = phase_kernels(dev)
    for k, err in phase_kernels_k2_blocked(dev).items():
        k12_err[k] = max(k12_err[k], err)
    f64_err = phase_kernels_f64(dev)
    new_err = phase_kernels_new(dev)
    for k, err in phase_kernels_jobs(dev).items():
        new_err[k] = max(new_err[k], err)
    c_err = phase_kernels_complex(dev)
    if args.quick:
        log("[5] one-shot multiply through the dense path")
        phase_dense(dev)
        log("[8] McWeeny purification on the card")
        phase_mcweeny(dev)
        log("quick mode: phases 1, 2, 3, 5 and 8 passed")
        return 0

    # 4. main path
    log("[4] main path: banded SCF shape through build_multiply_executor")
    a, b, execs, launches, errs, panel_out = phase_main_path(dev, MAIN_ROWS)

    # 5. dense one-shot multiply
    log("[5] one-shot multiply through the dense path")
    phase_dense(dev)

    # 6. times
    log("[6] times (CUDA-event medians)")
    rows = phase_times(a, b, execs, card)
    phase_steady_state(dev)
    log(f"    peak device memory so far {peak_memory(dev) / 1e9:.2f} GB")
    counts14 = {k: (a.data.shape[0], b.data.shape[0], fn.plan.tile_plan.n_c_tiles,
                    len(fn.plan.tile_plan.stack))
                for k, (fn, _, _) in execs.items()}
    del execs

    # 9. the further drivers at the same shape, then the scrambled patterns
    log("[9] band, grouped and run-fused panel drivers at the phase-4 shape")
    new_rows = phase_new_drivers(dev, a, b, panel_out)
    del a, b, panel_out
    torch.cuda.empty_cache()
    log(f"[9] RCM reordering: the scrambled chain of bench.py's clustered leg at "
        f"{SCRAMBLED_ROWS} rows")
    phase_scrambled_chain(dev, SCRAMBLED_ROWS)
    torch.cuda.empty_cache()
    log(f"[9] RCM reordering: scrambled bands of 128-blocks, {TILE_BAND_BLOCKS} block rows")
    phase_scrambled_tile_band(dev, TILE_BAND_BLOCKS, 2)  # every knob at its default
    torch.cuda.empty_cache()
    phase_scrambled_tile_band(dev, TILE_BAND_BLOCKS, 3, panel_cache=64)
    log(f"    peak device memory so far {peak_memory(dev) / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # 7. the filtered SCF path, float64 (the float64 kernel), then float32 (K2)
    log(f"[7] filtered SCF path: build_filtered_executor at {MAIN_ROWS} rows, "
        f"decay exp(-{DECAY}·|bi-bj|), filter_eps={FILTER_EPS:g}")
    filtered = {}
    for dtype, rtol in ((torch.float64, F64_RTOL), (torch.float32, KERNEL_RTOL)):
        t0 = time.perf_counter()
        a, b, variants = banded_scf_matrices(MAIN_ROWS, dev, dtype=dtype, decay=DECAY,
                                             n_variants=N_VARIANTS)
        sync(dev)
        log(f"  {str(dtype)[6:]} operands: A/B {a.data.shape[0]} tiles "
            f"({a.data.numel() * a.data.element_size() / 1e9:.2f} GB each), "
            f"{N_VARIANTS} A variants; set-up {time.perf_counter() - t0:.1f} s")
        filtered[dtype] = phase_filtered(dev, a, b, variants, rtol)
        del a, b, variants
        torch.cuda.empty_cache()

    # 8. McWeeny on the card
    log("[8] McWeeny purification on the card")
    phase_mcweeny(dev)
    log(f"    peak device memory {peak_memory(dev) / 1e9:.2f} GB "
        f"(phases 1-9)")

    # 11. the block-sparse tensor contraction (TAS and tensors over the multiply)
    log(f"[11] tensor contraction: shape R (RI-type 3-center, {TENSOR_ATOMS} atoms) in "
        f"float32 and float64, shape T (bench.py's tensor shape, i = {TENSOR_T_ROWS})")
    phase_tensor(dev)

    # 12. the host API around the multiply, on phase 4's operands
    log(f"[12] the host API on the card: limits, retile, checkpoint, CSR, .perf recipes, "
        f"self-tests (banded SCF shape at {MAIN_ROWS} rows, float32 and float64) [{card}]")
    t12 = time.perf_counter()
    phase_host_api(dev, card)
    get_plan_cache().clear()
    log(f"[12] took {time.perf_counter() - t12:.1f} s; peak device memory "
        f"{peak_memory(dev) / 1e9:.2f} GB")

    # 13. complex matrices: KC1 and KC2 on the main path, then the Hermitian,
    # filtered, tensor and .perf legs
    log(f"[13] complex matrices: complex64 (KC1) and complex128 (KC2) at the banded SCF "
        f"shape ({MAIN_ROWS} rows), a Hermitian 'C' product, the filtered step, shape R, "
        f"H2O as data type 7 [{card}]")
    t13 = time.perf_counter()
    complex_rows = phase_complex(dev)
    get_plan_cache().clear()
    log(f"[13] took {time.perf_counter() - t13:.1f} s; peak device memory "
        f"{peak_memory(dev) / 1e9:.2f} GB")

    # 14. the distributed multiply on virtual ranks of this card
    log(f"[14] the distributed multiply: Cannon, SUMMA and 2.5D over virtual ranks of "
        f"one card, the sharded at-rest form and rank-parallel TAS, at the banded SCF "
        f"shape ({MAIN_ROWS} rows) and shape R [{card}]")
    t14 = time.perf_counter()
    dist_rows = phase_dist(dev)
    get_plan_cache().clear()
    log(f"[14] took {time.perf_counter() - t14:.1f} s; peak device memory "
        f"{peak_memory(dev) / 1e9:.2f} GB")

    # 15. the C API: the float64 SCF product from C, example 6, the typed sweep
    log(f"[15] the C API on the card: c_dbcsr_multiply_d at the banded SCF shape "
        f"({MAIN_ROWS} rows, float64) from C in this process, example_6_c_api.c, the "
        f"typed sweep [{card}]")
    capi_row = phase_capi(dev, card)
    get_plan_cache().clear()
    log(f"[15] took {capi_row['seconds']:.1f} s; peak device memory "
        f"{peak_memory(dev) / 1e9:.2f} GB")

    # 16. the tuned auto: the committed table, a sweep on the card, auto's choice
    log(f"[16] the tuned auto: the committed parameter table, the sweep at {SWEEP_CLASS}, "
        f"auto at the banded SCF shape ({MAIN_ROWS} rows) and shape R [{card}]")
    t16 = time.perf_counter()
    del autotune._TABLE_CACHE[name]
    get_plan_cache().clear()
    reset_launches()
    tuned_rows, tuned_launches = phase_tuned(dev, card)
    log(f"    phase-16 main-path launches: sweep rows "
        f"{ {k: r['launches'] for k, r in tuned_rows.items()} }, 16c and 16d {tuned_launches}")
    autotune._TABLE_CACHE[name] = None  # phase 10 runs untuned, as before
    get_plan_cache().clear()
    log(f"[16] took {time.perf_counter() - t16:.1f} s; peak device memory "
        f"{peak_memory(dev) / 1e9:.2f} GB")

    # 17. the multi-process form: workers of this file over torch.distributed
    log(f"[17] the multi-process distributed multiply: (a) 2 processes on one card over "
        f"gloo, Cannon 2x2 at {MAIN_ROWS} rows, against phase 14's single-process "
        f"executor; (b) 4 processes at {MP_ROWS_B} rows: 2.5D Cannon, SUMMA, complex128 "
        f"Cannon, the sharded form, TAS, a contraction; (c) NCCL, one process a card "
        f"[{card}]")
    refs_a = {t: {**dist_rows[("14a 2x2", t)]["c"], "ms": dist_rows[("14a 2x2", t)]["ms"]}
              for t in ("float32", "float64")}
    del dist_rows
    mp_launches = phase_mp(dev, card, refs_a)
    get_plan_cache().clear()

    # 18. the examples and the planner-scale tools, with the tuned table
    log(f"[18] the examples (examples/torch/ 1, 2, 3, 5, 8, 9, 10), the large-scale check at "
        f"{LARGE_ROWS} rows and weak scaling [{card}]")
    del autotune._TABLE_CACHE[name]
    ex_launches = phase_examples_tools(dev, card, rows)
    autotune._TABLE_CACHE[name] = None  # phase 10 runs untuned, as before
    get_plan_cache().clear()
    log(f"    phase-18 launches: (a) examples {ex_launches['a']}, (b) large-scale executor "
        f"calls {ex_launches['b']}, (c) weak scaling n-rank call {ex_launches['c']}; peak "
        f"device memory {peak_memory(dev) / 1e9:.2f} GB")

    # the library yardstick, last: a failed cuSPARSE call cannot disturb a phase
    log("[10] library yardstick: torch.sparse.mm on the banded SCF shape")
    torch.cuda.empty_cache()
    library = phase_library(dev, (LIBRARY_ROWS, MAIN_ROWS))

    def entry(kname, source, replaces, launched, err, ms, plain_ms, counts, dtype="float32"):
        size = 8 if dtype == "float64" else 4
        bound_ms, bound_by = kernel_bound(*counts, 128, size, size, dtype)
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": round(ms, 4),
                "plain_ms": round(plain_ms, 4), "bound_ms": round(bound_ms, 4),
                "bound_by": bound_by,
                # torch.sparse.mm at this kernel's shape and input type (None:
                # cuSPARSE refused the product there, in this run)
                "library_ms": (None if library[(dtype, MAIN_ROWS)] is None
                               else round(library[(dtype, MAIN_ROWS)], 4))}

    def entry14(kname, source, replaces, key, route_key):
        r = rows[("highest", route_key)]
        return entry(kname, source, replaces, launches[key],
                     max(errs[("highest", route_key)], errs[("default", route_key)], k12_err[key]),
                     r["kernel_ms"], r["plain_ms"], counts14[("highest", route_key)])

    def entry9(kname, source, replaces, key):
        r = new_rows[key]
        return entry(kname, source, replaces, r["launches"],
                     max(r["max_abs_err"], new_err[key]), r["ms"], r["plain_ms"], r["counts"])

    def entry13(kname, key, source, replaces, tname):
        r = complex_rows[key]
        lib = library[(tname, MAIN_ROWS)]
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": r["launches"], "max_abs_err": max(r["max_abs_err"], c_err[key]),
                "ms": round(r["ms"], 4), "plain_ms": round(r["plain_ms"], 4),
                "bound_ms": round(r["bound_ms"], 4), "bound_by": r["bound_by"],
                "library_ms": None if lib is None else round(lib, 4)}

    def entry16(kname, source, replaces):
        r = tuned_rows[kname]
        return {"name": f"{kname} at {SWEEP_CLASS} (phase 16 sweep)", "route": "cuda",
                "source": source, "replaces": replaces, "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": round(r["ms"], 4),
                "plain_ms": round(r["plain_ms"], 4), "bound_ms": round(r["bound_ms"], 4),
                "bound_by": r["bound_by"], "library_ms": round(r["library_ms"], 4)}

    r64 = filtered[torch.float64]

    def with17(e, kname):
        # phase 17's launches on each process: (a) and (c) Cannon 2x2, (b) every leg
        e["phase17_launches"] = {
            "a": mp_launches["a"].get(kname), "b": [n.get(kname, 0) for n in mp_launches["b"]],
            "c": None if mp_launches["c"] is None else mp_launches["c"].get(kname)}
        return with18(e, kname)

    def with18(e, kname):
        # phase 18's launches: (a) the examples, (b) the large-scale executor
        # calls, (c) one n-rank weak-scaling call
        e["phase18_launches"] = {leg: ex_launches[leg].get(kname, 0) for leg in "abc"}
        return e

    print(json.dumps({"kernels": [
        with17(entry14("stack_matmul (K1)", "dbcsr_tpu_torch/csrc/stack_matmul.cu",
                       "dbcsr_tpu/mm/kernels.py:76", "K1", "stack"), "K1"),
        with18(entry14("panel_matmul (K2)", "dbcsr_tpu_torch/csrc/panel_matmul.cu",
                       "dbcsr_tpu/mm/panel.py:297", "K2", "auto"), "K2"),
        with18(entry9("panel_runs_matmul (K3)", "dbcsr_tpu_torch/csrc/panel_runs_matmul.cu",
                      "dbcsr_tpu/mm/panel.py:757", "K3"), "K3"),
        with18(entry9("grouped_matmul (K4)", "dbcsr_tpu_torch/csrc/grouped_matmul.cu",
                      "dbcsr_tpu/mm/kernels.py:419", "K4"), "K4"),
        with18(entry9("band_matmul (K5)", "dbcsr_tpu_torch/csrc/band_matmul.cu",
                      "dbcsr_tpu/mm/band.py:257", "K5"), "K5"),
        with17(entry("stack_matmul_f64 (K6)", "dbcsr_tpu_torch/csrc/stack_matmul_f64.cu",
                     "dbcsr_tpu/mm/ozaki_panel.py:222", r64["launches"],
                     max(f64_err, r64["max_abs_err"]), r64["kernel_ms"], r64["plain_ms"],
                     r64["counts"], "float64"), "K6"),
        with18(entry13("stack_matmul_c64 (KC1)", "KC1",
                       "dbcsr_tpu_torch/csrc/stack_matmul_c64.cu",
                       "dbcsr_tpu/mm/kernels.py:76", "complex64"), "KC1"),
        with17(entry13("stack_matmul_c128 (KC2)", "KC2",
                       "dbcsr_tpu_torch/csrc/stack_matmul_c128.cu",
                       "dbcsr_tpu/mm/ozaki_panel.py:222", "complex128"), "KC2"),
        entry16("K1", "dbcsr_tpu_torch/csrc/stack_matmul.cu", "dbcsr_tpu/mm/kernels.py:76"),
        entry16("K2", "dbcsr_tpu_torch/csrc/panel_matmul.cu", "dbcsr_tpu/mm/panel.py:297"),
        entry16("K3", "dbcsr_tpu_torch/csrc/panel_runs_matmul.cu", "dbcsr_tpu/mm/panel.py:757"),
        entry16("K4", "dbcsr_tpu_torch/csrc/grouped_matmul.cu", "dbcsr_tpu/mm/kernels.py:419"),
        entry16("K5", "dbcsr_tpu_torch/csrc/band_matmul.cu", "dbcsr_tpu/mm/band.py:257"),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
