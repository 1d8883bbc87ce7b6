"""Performance driver: runs ``.perf`` benchmark recipes on a device.

Port of ``dbcsr_tpu/perf.py`` (the reference's ``dbcsr_perf`` executable,
``tests/dbcsr_performance_driver.F`` + ``dbcsr_performance_multiply.F:
66-450``): the same input format (``tests/input.perf:1-40`` — grid, RMA
flag, operation, M/N/K, sparsities, transposes, symmetries, data type,
alpha/beta, limits, retain-sparsity, nrep, block-size recipes, optional
checksum references), parsed by this module's own copy of the parser, and
the same report: per-rep flop rates, mean/std/best wall time and the
position-weighted checksum (``perf_multiply``, ``:452-640``).

Each rep is one ``multiply`` on the device, timed on the host clock up to
``torch.cuda.synchronize``; the steady-state leg times the plan-once
executor of the plain product ``op(A)·op(B)`` (``autotune.
steady_state_time``: CUDA events on a CUDA device). It runs where
``build_multiply_executor`` takes the recipe's operands, and its failure
fails the run. One process drives one device (``n_devices`` is 1); the
grid and RMA fields select nothing. Complex recipes (data types 5 and 7:
complex64, complex128) take complex ``alpha``/``beta``, as the JAX package
reads them; real recipes keep their real parts.

The checksum references in ``tests/inputs/*.perf`` were recorded by the
JAX package on a TPU: a CUDA run prints whether it matches them, and gates
nothing on it.

Run: ``python -m dbcsr_tpu_torch.perf tests/inputs/H2O.perf [seed]
[--device cuda|cpu] [--emit-checksum]`` (the default device is ``cuda``;
without CUDA it fails unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PerfConfig", "parse_perf", "perf_operands", "run_perf", "main"]

_DTYPES = {1: torch.float32, 3: torch.float64, 5: torch.complex64, 7: torch.complex128}


@dataclass
class PerfConfig:
    npcols: int = 0
    use_rma: bool = False
    operation: str = "dbcsr_multiply"
    m: int = 0
    n: int = 0
    k: int = 0
    sparsity_a: float = 0.0
    sparsity_b: float = 0.0
    sparsity_c: float = 0.0
    transa: str = "N"
    transb: str = "N"
    sym_a: str = "N"
    sym_b: str = "N"
    sym_c: str = "N"
    data_type: int = 3
    alpha: complex = 1.0
    beta: complex = 1.0
    lim_row: Tuple[int, int] = (0, 0)
    lim_col: Tuple[int, int] = (0, 0)
    lim_k: Tuple[int, int] = (0, 0)
    retain_sparsity: bool = False
    nrep: int = 1
    m_blocks: List[Tuple[int, int]] = field(default_factory=list)
    n_blocks: List[Tuple[int, int]] = field(default_factory=list)
    k_blocks: List[Tuple[int, int]] = field(default_factory=list)
    check_checksum: bool = False
    checksum_threshold: float = 0.0
    checksum_refs: List[float] = field(default_factory=list)


def _f(tok: str) -> float:
    return float(tok.lower().replace("d", "e"))


def _b(tok: str) -> bool:
    return tok.strip().upper().startswith("T")


def parse_perf(path: str) -> PerfConfig:
    """Parse the reference's ``.perf`` input format (values-only lines;
    ``#`` comments; fixed field order — ``tests/input.perf``)."""
    with open(path) as fh:
        toks = [
            line.strip()
            for line in fh
            if line.strip() and not line.strip().startswith("#")
        ]
    it = iter(toks)
    nxt = lambda: next(it)  # noqa: E731
    cfg = PerfConfig()
    cfg.npcols = int(nxt())
    cfg.use_rma = _b(nxt())
    cfg.operation = nxt()
    cfg.m, cfg.n, cfg.k = int(nxt()), int(nxt()), int(nxt())
    cfg.sparsity_a, cfg.sparsity_b, cfg.sparsity_c = _f(nxt()), _f(nxt()), _f(nxt())
    cfg.transa, cfg.transb = nxt().upper(), nxt().upper()
    cfg.sym_a, cfg.sym_b, cfg.sym_c = nxt().upper(), nxt().upper(), nxt().upper()
    cfg.data_type = int(nxt())
    cfg.alpha = complex(_f(nxt()), _f(nxt()))
    cfg.beta = complex(_f(nxt()), _f(nxt()))
    cfg.lim_row = (int(nxt()), int(nxt()))
    cfg.lim_col = (int(nxt()), int(nxt()))
    cfg.lim_k = (int(nxt()), int(nxt()))
    cfg.retain_sparsity = _b(nxt())
    cfg.nrep = int(nxt())
    nm, nn, nk = int(nxt()), int(nxt()), int(nxt())
    cfg.m_blocks = [(int(nxt()), int(nxt())) for _ in range(nm)]
    cfg.n_blocks = [(int(nxt()), int(nxt())) for _ in range(nn)]
    cfg.k_blocks = [(int(nxt()), int(nxt())) for _ in range(nk)]
    cfg.check_checksum = _b(nxt())
    if cfg.check_checksum:
        cfg.checksum_threshold = _f(nxt())
        for tok in it:
            cfg.checksum_refs.append(_f(tok))
    return cfg


def _block_sizes(total: int, recipe: List[Tuple[int, int]]) -> np.ndarray:
    """Expand a (multiplicity, size) recipe cyclically until ``total`` full
    rows are covered (the reference's block-size generation,
    ``tests/input.perf`` block comments)."""
    sizes: List[int] = []
    covered = 0
    while covered < total:
        for mult, size in recipe:
            for _ in range(mult):
                take = min(size, total - covered)
                if take <= 0:
                    break
                sizes.append(take)
                covered += take
            if covered >= total:
                break
    return np.asarray(sizes, dtype=np.int32)


def _elem_to_block_range(
    lim: Tuple[int, int], sizes: np.ndarray
) -> Optional[Tuple[int, int]]:
    """Element limits (1-based inclusive, 0=full) → half-open block range."""
    lo, hi = lim
    if lo == 0 and hi == 0:
        return None
    off = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    b0 = int(np.searchsorted(off, lo - 1))
    b1 = int(np.searchsorted(off, hi))
    if off[b0] != lo - 1 or off[b1] != hi:
        raise ValueError(f"limits {lim} not aligned with block boundaries")
    return (b0, b1)


def executor_takes(a, b) -> bool:
    """Whether ``build_multiply_executor`` plans A·B: one type, one tile
    edge and one device for both operands (what its planner asserts)."""
    return a.dtype == b.dtype and a.tile == b.tile and a.device == b.device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def perf_operands(cfg: PerfConfig, *, device, seed: int = 0):
    """The recipe's matrices on ``device``, drawn from ``seed`` as the JAX
    package draws them: ``(A, B, C or None, limits or None)``. The draws are
    made on the host, so every device gets the same values."""
    from .ops.random import random_matrix

    if cfg.data_type not in _DTYPES:
        raise ValueError(f"unknown .perf data type {cfg.data_type}")
    dtype = _DTYPES[cfg.data_type]
    rng = np.random.default_rng(seed)
    mbs = _block_sizes(cfg.m, cfg.m_blocks)
    nbs = _block_sizes(cfg.n, cfg.n_blocks)
    kbs = _block_sizes(cfg.k, cfg.k_blocks)

    occ_a, occ_b, occ_c = (
        1.0 - cfg.sparsity_a, 1.0 - cfg.sparsity_b, 1.0 - cfg.sparsity_c,
    )
    ta = cfg.transa in ("T", "C")
    tb = cfg.transb in ("T", "C")
    a = random_matrix(
        kbs if ta else mbs, mbs if ta else kbs, occ_a, rng,
        dtype=dtype, sym=cfg.sym_a, name="A", device=device,
    )
    b = random_matrix(
        nbs if tb else kbs, kbs if tb else nbs, occ_b, rng,
        dtype=dtype, sym=cfg.sym_b, name="B", device=device,
    )
    c = None
    if cfg.beta != 0.0 or cfg.retain_sparsity:
        c = random_matrix(mbs, nbs, occ_c, rng, dtype=dtype, name="C", device=device)

    limits = {}
    for key, lim, sizes in (
        ("rows", cfg.lim_row, mbs), ("cols", cfg.lim_col, nbs),
        ("k", cfg.lim_k, kbs),
    ):
        rng_blocks = _elem_to_block_range(lim, sizes)
        if rng_blocks is not None:
            limits[key] = rng_blocks
    return a, b, c, limits or None


def run_perf(cfg: PerfConfig, *, device, seed: int = 0, verbose: bool = True) -> dict:
    """Run one recipe on ``device``: ``nrep`` one-shot multiplies, then the
    steady-state executor leg. Returns the report as a dict."""
    from .autotune import steady_state_time
    from .mm.engine import build_multiply_executor, multiply
    from .ops.io import checksum

    device = torch.device(device)
    a, b, c, limits = perf_operands(cfg, device=device, seed=seed)
    if cfg.use_rma and verbose:
        print("# note: RMA flag ignored (one process drives one device)")

    if a.dtype.is_complex:
        alpha, beta = cfg.alpha, cfg.beta
    else:
        alpha, beta = cfg.alpha.real, cfg.beta.real
    times = []
    flops = 0.0
    out = None
    for _ in range(cfg.nrep):
        t0 = time.perf_counter()
        out, fl = multiply(
            cfg.transa, cfg.transb, alpha, a, b, beta, c,
            retain_sparsity=cfg.retain_sparsity,
            limits=limits,
            return_flops=True,
        )
        _sync(device)
        times.append(time.perf_counter() - t0)
        flops = fl
    times = np.asarray(times)
    mean_t = float(times.mean())
    std_t = float(times.std())
    best_t = float(times.min())
    cks = checksum(out, pos=True)
    result = {
        "operation": cfg.operation,
        "mnk": [cfg.m, cfg.n, cfg.k],
        "nrep": cfg.nrep,
        "device": str(device),
        "eff_flops_per_mult": flops,
        "mean_time_s": mean_t,
        "std_time_s": std_t,
        "best_time_s": best_t,
        "flops_per_s_mean": flops / mean_t if mean_t else 0.0,
        "flops_per_s_best": flops / best_t if best_t else 0.0,
        "flops_per_device": flops / mean_t if mean_t else 0.0,
        "n_devices": 1,
        "checksum": cks,
    }
    if cfg.check_checksum and cfg.checksum_refs:
        result["checksum_match"] = any(
            abs(cks - ref) <= cfg.checksum_threshold * max(abs(ref), 1.0)
            for ref in cfg.checksum_refs
        )

    # steady-state device rate of the plain product (plan-once executor; the
    # per-rep numbers above include host planning and dispatch, which the
    # reference's driver also measures)
    result["route"] = None
    result["steady_time_s"] = None
    result["flops_per_s_steady"] = None
    if executor_takes(a, b):
        fn, _, eff_x = build_multiply_executor(cfg.transa, cfg.transb, a, b)
        t_steady = steady_state_time(fn, (a.data, b.data))
        result["route"] = fn.plan.route
        result["steady_time_s"] = t_steady
        result["flops_per_s_steady"] = eff_x / t_steady if t_steady else 0.0

    if verbose:
        print(f" multiplies {cfg.nrep}   mean {mean_t*1e3:9.3f} ms  "
              f"std {std_t*1e3:7.3f} ms  best {best_t*1e3:9.3f} ms")
        print(f" eff flops/mult {flops:.4E}   "
              f"GFLOP/s mean {result['flops_per_s_mean']/1e9:9.2f}  "
              f"best {result['flops_per_s_best']/1e9:9.2f}")
        if result["flops_per_s_steady"] is not None:
            print(f" steady-state executor ({result['route']})  "
                  f"GFLOP/s {result['flops_per_s_steady']/1e9:9.2f}")
        print(f" checksum {cks:.15E}")
        print(json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dbcsr_tpu_torch.perf",
        description="Run a .perf multiply recipe on one device.")
    ap.add_argument("recipe", help="a .perf input file")
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--emit-checksum", action="store_true",
                    help="print checksum reference lines for this input")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("dbcsr_tpu_torch.perf: CUDA is not available; pass --device cpu "
              "to run on the CPU", file=sys.stderr)
        return 2
    from .core.lib import init_lib

    init_lib()
    cfg = parse_perf(args.recipe)
    res = run_perf(cfg, device=device, seed=args.seed)
    if args.emit_checksum:
        print("# checksum reference lines for this input "
              "(append after '# checksum' -> T):")
        print("T")
        print("1.0E-6")
        print(f"{res['checksum']:.15E}")
    if cfg.check_checksum and cfg.checksum_refs:
        ok = res["checksum_match"]
        print(f"checksum check: {'OK' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
