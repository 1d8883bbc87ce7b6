#!/usr/bin/env python3
"""Bring-up smoke test of the PyTorch/CUDA port (dbcsr_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py            # every phase, one GPU
    python3 chip_smoke.py --quick    # phases 1, 2, 3 and 5 (no 400k-row run)

Phases (any failure exits non-zero before the final line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels from ``dbcsr_tpu_torch/csrc`` with nvcc into the
   git-ignored build directory (ptxas register report printed);
3. each kernel (K1 flat stack, K2 panel) against its plain PyTorch version
   on the card: f32 and bf16→f32, T=128 and T=32, a stack with one long run
   per C tile and a banded panel plan with a clamped last group;
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
   versions at the phase-4 shape, as GFLOP/s beside the card and its limit.

The kernel summary is one JSON line, then the ``nvidia-smi`` line, then the
final line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> tuple:
    import torch

    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 1.0
    return err, err / (scale or 1.0)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


# ---------------------------------------------------------------------------
# phase 4: the main path at 400,000 rows
# ---------------------------------------------------------------------------

def banded_scf_matrices(nrows: int, dev, seed: int = 0):
    """The banded SCF shape of bench.py (blocks of 5/13/23, band of ±12
    blocks at 50% fill) with data made in store form on the device."""
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import valid_mask

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
    data = torch.randn((lay.n_tiles, 128, 128), generator=gen, device=dev)
    data *= valid_mask(idx, 128, dev)
    a = dt.BCSRMatrix(name="A", index=idx, data=data)
    b = dt.BCSRMatrix(name="B", index=idx, data=data * 0.5)
    return a, b


def plain_of(plan, a_data, b_data):
    """The plain version of the executor's kernel on the same inputs."""
    import torch

    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul_plain
    from dbcsr_tpu_torch.mm.panel import tile_stack_matmul_panel_plain

    a_in, b_in = a_data.to(plan.in_dtype), b_data.to(plan.in_dtype)
    if plan.route == "panel":
        return tile_stack_matmul_panel_plain(
            a_in, b_in, plan.panel.plan, out_dtype=torch.float32)
    return tile_stack_matmul_plain(a_in, b_in, plan.stack, out_dtype=torch.float32)


def sampled_f64_check(plan, out, c_index, a_data, b_data, n_samples=64, seed=1):
    """float64 host recomputation of sampled C tiles from the kernel's own
    inputs (so the bound is float32 accumulation only)."""
    import torch

    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import tile_align_map

    tp = plan.tile_plan
    stack = tp.stack
    c_ptr = np.searchsorted(stack[:, 0], np.arange(tp.n_c_tiles + 1))
    c_keys = store_layout(c_index, a_data.shape[1]).tile_keys()
    pos_of = tile_align_map(tp.c_tile_keys, c_keys)  # product tile -> C slot
    present = np.flatnonzero(pos_of >= 0)
    rng = np.random.default_rng(seed)
    worst = 0.0
    scale = 0.0
    for s in rng.choice(present, size=min(n_samples, len(present)), replace=False):
        e0, e1 = int(c_ptr[s]), int(c_ptr[s + 1])
        ai = torch.as_tensor(stack[e0:e1, 1].astype(np.int64), device=a_data.device)
        bi = torch.as_tensor(stack[e0:e1, 2].astype(np.int64), device=a_data.device)
        ga = a_data.index_select(0, ai).to(plan.in_dtype).double().cpu()
        gb = b_data.index_select(0, bi).to(plan.in_dtype).double().cpu()
        ref = torch.bmm(ga, gb).sum(0)
        got = out[int(pos_of[s])].double().cpu()
        worst = max(worst, float((got - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    return worst, worst / (scale or 1.0)


def phase_main_path(dev, nrows: int):
    import torch

    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch.block.store import store_layout
    from dbcsr_tpu_torch.block.tileops import take_tiles, tile_align_map
    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul
    from dbcsr_tpu_torch.mm.panel import tile_stack_matmul_panel

    t0 = time.perf_counter()
    a, b = banded_scf_matrices(nrows, dev)
    sync(dev)
    log(f"  banded SCF shape: {nrows} rows, {a.nblkrows} block rows, "
        f"{a.nblks} blocks, A/B {a.data.shape[0]} tiles of 128² "
        f"({a.data.numel() * 4 / 1e9:.2f} GB f32 each); set-up {time.perf_counter() - t0:.1f} s")

    execs = {}
    for prec in ("highest", "default"):
        for driver in ("auto", "stack"):
            t0 = time.perf_counter()
            with dt.config_override(matmul_precision=prec, mm_driver=driver):
                fn, c_index, eff = dt.build_multiply_executor("N", "N", a, b)
            tp = fn.plan.tile_plan
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

    errs = {}
    for key, (fn, c_index, _) in execs.items():
        out = outs[key]
        n_c = store_layout(c_index, 128).n_tiles
        if tuple(out.shape) != (n_c, 128, 128) or out.dtype != torch.float32:
            fail(f"{key}: output {tuple(out.shape)} {out.dtype}, expected ({n_c}, 128, 128) f32")
        # the product tiles, aligned to C's tiles as the executor aligns them
        ref = take_tiles(
            plain_of(fn.plan, a.data, b.data),
            tile_align_map(store_layout(c_index, 128).tile_keys(), fn.plan.prod_keys),
            128,
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
    return a, b, execs, launches, errs


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

def phase_times(a, b, execs, card: str) -> dict:
    import torch

    from dbcsr_tpu_torch.mm.kernels import tile_stack_matmul
    from dbcsr_tpu_torch.mm.panel import tile_stack_matmul_panel

    rows = {}
    log(f"  card: {card}")
    log(f"  {'executor':16s} {'exec ms':>9s} {'kernel ms':>10s} {'plain ms':>9s} "
        f"{'eff GF/s':>9s} {'hw GF/s':>9s} {'plain hw GF/s':>13s}")
    for (prec, driver), (fn, _, eff) in execs.items():
        plan = fn.plan
        hw = plan.hw_flops
        a_in, b_in = a.data.to(plan.in_dtype), b.data.to(plan.in_dtype)
        if plan.route == "panel":
            def kernel():
                tile_stack_matmul_panel(a_in, b_in, plan.panel, out_dtype=torch.float32)
        else:
            def kernel():
                tile_stack_matmul(a_in, b_in, plan.stack, out_dtype=torch.float32)
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
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1, 2, 3 and 5 only: build and check the kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "dbcsr_tpu_torch", "csrc")):
        fail("run from a checkout: dbcsr_tpu_torch/csrc is missing")
    sys.path.insert(0, REPO)
    import dbcsr_tpu_torch as dt
    from dbcsr_tpu_torch import _build

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {name}")
    dev = torch.device("cuda", 0)
    dt.init_lib()

    # 2. build
    info = _build.build_kernels(verbose=True)
    log(f"[2] built {os.path.relpath(info.path, REPO)} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log("    " + line.strip())
    from dbcsr_tpu_torch.native import native_available
    log(f"    native host planner: {'built' if native_available() else 'numpy fallback'}")

    # 3. kernels against their plain versions
    log("[3] kernels vs plain versions on the card")
    phase_kernels(dev)
    if args.quick:
        log("[5] one-shot multiply through the dense path")
        phase_dense(dev)
        log("quick mode: phases 1, 2, 3 and 5 passed")
        return 0

    # 4. main path
    log("[4] main path: banded SCF shape through build_multiply_executor")
    a, b, execs, launches, errs = phase_main_path(dev, MAIN_ROWS)

    # 5. dense one-shot multiply
    log("[5] one-shot multiply through the dense path")
    phase_dense(dev)

    # 6. times
    log("[6] times (CUDA-event medians)")
    rows = phase_times(a, b, execs, card)
    log(f"    peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    def entry(kname, source, replaces, key, route_key):
        r = rows[("highest", route_key)]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": max(errs[("highest", route_key)], errs[("default", route_key)]),
                "ms": round(r["kernel_ms"], 4), "plain_ms": round(r["plain_ms"], 4)}

    print(json.dumps({"kernels": [
        entry("stack_matmul (K1)", "dbcsr_tpu_torch/csrc/stack_matmul.cu",
              "dbcsr_tpu/mm/kernels.py:76", "K1", "stack"),
        entry("panel_matmul (K2)", "dbcsr_tpu_torch/csrc/panel_matmul.cu",
              "dbcsr_tpu/mm/panel.py:297", "K2", "auto"),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
