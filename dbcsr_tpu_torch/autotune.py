"""Autotuning: sweep the engine's drivers and knobs per workload class on
the card, store the winners in a JSON parameter table keyed by the card's
name, and look them up when a product is planned.

Port of ``dbcsr_tpu/autotune.py`` (the reference's
``src/acc/libsmm_acc/tune/tune_setup.py`` + per-GPU
``parameters/parameters_*.json``, selection logic
``kernels/smm_acc_predict.py``). The sweep times every driver's knob grid
on each workload class (block-size profile × occupancy × scale) with CUDA
events; ``tuned_stack_params`` gives the engine the winner of the class
nearest to a product in normalised feature space, for the knobs the user
left at their defaults (``mm/engine.py``: ``_tuned_driver``,
``_panel_knobs``). The table is keyed by the device a product runs on: a
CUDA device reads ``params/<torch.cuda.get_device_name>.json``; a CPU
device has no table, so CPU products keep the untuned choices.

Usage:
  python -m dbcsr_tpu_torch.autotune --device cuda --out dbcsr_tpu_torch/params/<device>.json
  python -m dbcsr_tpu_torch.autotune --merge --workloads banded_fine   # one class into the table
  dbcsr_tpu_torch.autotune.apply_tuned("banded_fine")   # adopt a class's winner globally
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .block.bcsr import BCSRMatrix
from .block.index import build_index
from .block.store import store_layout
from .block.tileops import valid_mask
from .core.config import config_override, get_config, set_config
from .core.errors import DbcsrError
from .ops.random import random_block_sizes, random_matrix

__all__ = [
    "BANDED_GATE",
    "WORKLOADS",
    "DRIVER_GRIDS",
    "coords_bandedness",
    "index_features",
    "workload_features",
    "workload_class",
    "nearest_class",
    "tuned_stack_params",
    "steady_state_time",
    "sweep",
    "save_params",
    "load_params",
    "apply_tuned",
]

#: the port's own tables; it never reads ``dbcsr_tpu/params/``
PARAMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params")

#: default sweep: per-driver sub-grids (a flat cartesian product would
#: waste most of its combos on knobs the driver ignores). Keys are config
#: parameters; every row records its ``mm_driver`` and the route it took.
#: The JAX grids' ``stack_e_batch``, ``max_stack_size`` and
#: ``panel_unroll`` are TPU launch knobs (Pallas grid batching, the stack
#: chunk of one launch, the unroll of the panel kernel's dot loop) with no
#: counterpart in the port's kernels, so they are not swept here.
DRIVER_GRIDS = {
    "dense": {
        "tile_size": [128, 256],
        "matmul_precision": ["default", "highest"],
    },
    "stack": {
        "matmul_precision": ["default", "highest"],
        "stack_bf16_inputs": [False, True],
    },
    "panel": {
        "panel_c_win": [8, 16, 32, 64],
        "panel_cache": [48, 96, 192, 320],
        "panel_chunk": [8, 16],
        # run fusion length (0 = the per-entry plan and K2; 3 = K3)
        "panel_runlen": [0, 3],
        "panel_bf16_inputs": [False, True],
        "matmul_precision": ["default", "highest"],
    },
    "grouped": {
        "matmul_precision": ["default", "highest"],
        "stack_bf16_inputs": [False, True],
    },
    "band": {
        "matmul_precision": ["default", "highest"],
    },
}


def panel_plan_fingerprint(plan) -> Optional[tuple]:
    """Launch-shape fingerprint of a realised panel plan (a ``PanelPlan`` or
    ``PanelRunPlan``; None: no panel plan). For fixed non-cache knobs,
    planning is deterministic and ``panel_cache`` enters only as the
    admission cap (plus the chunk halving of the span padding), so two plans
    agreeing on this tuple are the same launch: the sweep measures each
    distinct fingerprint once per cache-free knob key."""
    if plan is None:
        return None
    return (
        type(plan).__name__,
        int(plan.chunk),
        int(plan.a_cap),
        int(plan.b_cap),
        int(plan.c_win),
        int(plan.n_groups),
        int(getattr(plan, "runlen", 0)),
        int(plan.loaded_tiles),
    )


def _combo_ok(combo: dict) -> bool:
    """Prune sweep points that are redundant: bf16 kernel inputs take
    effect only at matmul_precision "default" (at "highest" the knob is a
    no-op, and measuring it twice wastes card time). The JAX sweep also
    drops panel cache/c_win combos past the TPU's VMEM budget; K2 and K3
    stream their slabs through a ``cp.async`` ring and keep no panel cache
    in shared memory (``csrc/panel_matmul.cu``), so on this card
    ``panel_cache`` only caps the span a group may load (admission)."""
    prec = combo.get("matmul_precision", "default")
    return not any(
        combo.get(knob) and prec != "default"
        for knob in ("panel_bf16_inputs", "stack_bf16_inputs")
    )


# --- workload classes --------------------------------------------------------
#
# Each builder takes (seed, device) and returns (A, B). Indices come from
# numpy draws in the JAX builders' order, so one seed gives both packages
# the same patterns.

def _mk_workload(block_sizes, occupancy):
    def build(seed: int, device):
        rng = np.random.default_rng(seed)
        rbs = random_block_sizes(1500, block_sizes, rng)
        a = random_matrix(rbs, rbs, occupancy, rng, device=device,
                          dtype=np.float32, name="A")
        b = random_matrix(rbs, rbs, occupancy, rng, device=device,
                          dtype=np.float32, name="B")
        return a, b

    return build


def _mk_banded(nrows: int = 12000, bandwidth: int = 12):
    """Banded fine-blocked pattern (the linear-scaling SCF shape: blocks of
    5/13/23, a ±``bandwidth``-block band at 50% fill). Data is made in store
    form on the device from a torch generator seeded with ``seed``; B is
    A·0.5."""

    def build(seed: int, device):
        rng = np.random.default_rng(seed)
        rbs = random_block_sizes(nrows, [5, 13, 23], rng)
        n = len(rbs)
        w = 2 * bandwidth + 1
        i = np.repeat(np.arange(n, dtype=np.int64), w)
        j = i + np.tile(np.arange(-bandwidth, bandwidth + 1, dtype=np.int64), n)
        keep = (j >= 0) & (j < n) & (rng.random(len(j)) < 0.5)
        idx, _ = build_index(i[keep], j[keep], rbs, rbs)
        t = get_config().tile_size
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        data = torch.randn(
            (store_layout(idx, t).n_tiles, t, t), generator=gen, device=device,
            dtype=torch.float32,
        ) * valid_mask(idx, t, device)
        a = BCSRMatrix(name="A", index=idx, data=data)
        b = BCSRMatrix(name="B", index=idx, data=data * 0.5)
        return a, b

    return build


#: the JAX package's five classes (uniform 23³ dense-blocked, uniform 5×5
#: sparse, mixed 5/13/23, banded fine-blocked at 12,000 and 40,000 rows),
#: and the banded shape at 400,000 rows: at 40,000 rows A is 99 MB, at
#: 400,000 it is 15,018 tiles (0.98 GB), the size the port's main path is
#: measured at (``chip_smoke.py`` phase 4)
WORKLOADS: Dict[str, Callable] = {
    "block23_dense": _mk_workload([23], 1.0),
    "block5_sparse10": _mk_workload([5], 0.10),
    "mixed_5_13_23_sparse20": _mk_workload([5, 13, 23], 0.20),
    "banded_fine": _mk_banded(),
    "banded_fine_large": _mk_banded(40000),
    "banded_scf_400k": _mk_banded(400000),
}


def workload_class(block_sizes, occupancy: float) -> str:
    """Coarse rule-based classification (fallback when the parameter table
    carries no feature vectors)."""
    mean_bs = float(np.mean(block_sizes))
    if occupancy > 0.6:
        return "block23_dense"
    if occupancy < 0.02:
        return "banded_fine"
    if mean_bs <= 8:
        return "block5_sparse10"
    return "mixed_5_13_23_sparse20"


# --- feature-based classification (smm_acc_predict analog) -------------------
#
# Every tuned class stores the FEATURE VECTOR of its swept workload; a
# product looks up the nearest class in normalised feature space.

#: feature names, scales chosen so one unit ~ one "meaningful" step
_FEATURES = (
    "log_mean_bs",      # log2 mean block edge
    "bs_cv",            # block-size coefficient of variation
    "log_occupancy",    # log10 block-level occupancy
    "bandedness",       # 1 - normalized mean |i - j| spread of blocks
    "log_nblkrows",     # log10 problem scale
)

#: bandedness below this can never make the panel plan admissible
BANDED_GATE = 0.05


def coords_bandedness(rows, cols, n: int) -> float:
    """``1 - 3 * normalized mean |i - j|`` of a coordinate pattern: ~1 for
    banded/clustered, ~0 for uniform-random (whose spread is ~n/3). Empty
    patterns score 1.0."""
    if len(rows) == 0:
        return 1.0
    spread = float(
        np.abs(
            np.asarray(rows, dtype=np.float64)
            - np.asarray(cols, dtype=np.float64)
        ).mean()
    ) / max(n, 1)
    return max(0.0, 1.0 - 3.0 * spread)


def index_features(index) -> np.ndarray:
    """Feature vector of one matrix index (pure metadata, O(nblks)):
    log2 mean block edge, block-size variation, log10 occupancy,
    bandedness, log10 block rows."""
    sizes = np.concatenate(
        [index.row_block_sizes, index.col_block_sizes]
    ).astype(np.float64)
    mean_bs = max(float(sizes.mean()), 1.0)
    cv = float(sizes.std() / mean_bs)
    occ = index.nblks / max(index.nblkrows * index.nblkcols, 1)
    bandedness = coords_bandedness(
        index.blk_rows, index.col_idx,
        max(index.nblkrows, index.nblkcols, 1),
    )
    return np.array(
        [
            np.log2(mean_bs),
            cv,
            np.log10(max(occ, 1e-6)),
            bandedness,
            np.log10(max(index.nblkrows, 1)),
        ]
    )


def workload_features(a_index, b_index) -> np.ndarray:
    return 0.5 * (index_features(a_index) + index_features(b_index))


#: per-feature normalization: one unit of distance per entry
_FEATURE_SCALE = np.array([1.0, 0.3, 0.7, 0.35, 0.8])


def nearest_class(features: np.ndarray, table: dict):
    """(class name, distance) of the nearest tuned class by normalized
    feature distance; None if the table has no feature vectors."""
    best = None
    best_d = np.inf
    for cls, res in table.get("results", {}).items():
        fv = res.get("features")
        if fv is None:
            continue
        d = float(
            np.linalg.norm((np.asarray(fv) - features) / _FEATURE_SCALE)
        )
        if d < best_d:
            best, best_d = cls, d
    if best is None:
        return None
    return best, best_d


# --- the parameter table -----------------------------------------------------

def device_kind(device) -> str:
    """The name a device's table is filed under: the CUDA device's name
    (``torch.cuda.get_device_name``), else the device type."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _table_path(kind: str) -> str:
    safe = kind.replace(" ", "_").replace("/", "_")
    return os.path.join(PARAMS_DIR, f"{safe}.json")


#: device name -> its table (None: no table), loaded once a process. A
#: process that must run untuned on a card with a table sets its entry to
#: None; deleting the entry loads the file again.
_TABLE_CACHE: Dict[str, Optional[dict]] = {}


def _cached_table(device) -> Optional[dict]:
    """The table of the CUDA device a product runs on; None for no device
    or a CPU device, which have no table."""
    if device is None or torch.device(device).type != "cuda":
        return None
    kind = device_kind(device)
    if kind not in _TABLE_CACHE:
        _TABLE_CACHE[kind] = load_params(kind)
    return _TABLE_CACHE[kind]


def tuned_stack_params(a_index, b_index, device=None) -> Optional[dict]:
    """The tuned row (``best``) of the class nearest to this product in the
    table of ``device``, the device the product runs on; None without a
    table (a CPU device, ``device=None``, or a card that was never swept).
    The engine applies it to the knobs the user left at their defaults."""
    table = _cached_table(device)
    if table is None:
        return None
    hit = nearest_class(workload_features(a_index, b_index), table)
    if hit is not None:
        cls, _ = hit
    else:  # a table without feature vectors
        occ_a = a_index.nblks / max(a_index.nblkrows * a_index.nblkcols, 1)
        occ_b = b_index.nblks / max(b_index.nblkrows * b_index.nblkcols, 1)
        sizes = np.concatenate(
            [a_index.row_block_sizes, b_index.col_block_sizes]
        )
        cls = workload_class(sizes, 0.5 * (occ_a + occ_b))
    return table["results"].get(cls, {}).get("best")


def save_params(table: dict, path: Optional[str] = None) -> str:
    if path is None:
        os.makedirs(PARAMS_DIR, exist_ok=True)
        path = _table_path(table["device_kind"])
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    return path


def load_params(device_kind: Optional[str] = None) -> Optional[dict]:
    """The stored table of the named device (default: CUDA device 0); None
    if there is none, or no name and no CUDA device."""
    if device_kind is None:
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    path = _table_path(device_kind)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


#: keys of a table row that are results, not config parameters
_RESULT_KEYS = ("route", "gflops")


def apply_tuned(
    workload: Optional[str] = None, *, table: Optional[dict] = None
) -> bool:
    """Adopt a class's stored winner as the global config (the first class
    without ``workload``). Returns True if a tuned config was applied."""
    table = table or load_params()
    if table is None:
        return False
    classes = table["results"]
    w = workload or next(iter(classes))
    best = classes.get(w, {}).get("best")
    if not best:
        return False
    set_config(**{k: v for k, v in best.items() if k not in _RESULT_KEYS})
    return True


# --- the sweep ---------------------------------------------------------------

def steady_state_time(fn, args, *, reps: int = 10, warmup: int = 2) -> float:
    """Per-call time (s) of ``fn(*args)`` in steady state: the median over
    ``reps`` calls after ``warmup``. On a CUDA device each call is timed by
    CUDA events recorded around it (device time, the launch queue kept
    full); elsewhere by the host clock around the call. The JAX package
    takes the marginal time of a dependent device loop instead, because its
    dispatch jitter hid fast calls; CUDA events need no such loop."""
    dev = args[0].device
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(*args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) * 1e-3)
        else:
            s0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - s0)
    return float(np.median(times))


def _sweep_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DbcsrError(
            "the sweep measures on a CUDA device and none is available "
            "(--device cpu sweeps the kernels' plain versions on the CPU)"
        )
    return dev


def _dense_fits(a, b, tile: int, device: torch.device) -> bool:
    """Whether the dense driver's padded float32 panels (A, B, the product
    and its tile copy) fit in the device's free memory; always on the CPU."""
    if device.type != "cuda":
        return True
    m, k, n = (
        -(-int(s.sum()) // tile) * tile
        for s in (a.index.row_block_sizes, a.index.col_block_sizes,
                  b.index.col_block_sizes)
    )
    need = 4 * (m * k + k * n + 2 * m * n)
    return need <= torch.cuda.mem_get_info(device)[0]


def sweep(
    *,
    grid: Optional[Dict[str, list]] = None,
    workloads: Optional[List[str]] = None,
    drivers: Optional[List[str]] = None,
    seed: int = 0,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Time every config combo on every workload class on ``device`` (a
    CUDA device unless the caller asks for the CPU); returns
    ``{device_kind, results: {class: {best, features, all}}}``."""
    from .mm.engine import build_multiply_executor

    dev = _sweep_device(device)
    if grid is not None:
        names = list(grid)
        combos = [
            dict(zip(names, c))
            for c in itertools.product(*(grid[n] for n in names))
        ]
    else:  # default: per-driver sub-grids
        combos = []
        for drv, g in DRIVER_GRIDS.items():
            if drivers is not None and drv not in drivers:
                continue
            names = list(g)
            for c in itertools.product(*(g[n] for n in names)):
                combo = {"mm_driver": drv, **dict(zip(names, c))}
                if _combo_ok(combo):
                    combos.append(combo)
    # panel_cache only gates ADMISSION, so different cache values often
    # realise the same plan: iterate caches ascending and skip a combo
    # whose cache-free key already measured the same realised plan (the
    # planning is host work; the dedup saves card time). Keyed on the plan
    # fingerprint, not mere admission: a small cache can admit with a
    # halved chunk where a larger one admits at the full chunk.
    combos.sort(key=lambda c: c.get("panel_cache") or 0)

    def _panel_dedup_key(cfg):
        if cfg.get("mm_driver") != "panel":
            return None
        return tuple(
            (k, v) for k, v in sorted(cfg.items()) if k != "panel_cache"
        )

    def say(msg):
        if verbose:
            print(msg, flush=True)

    results: Dict[str, dict] = {}
    for wname in workloads or list(WORKLOADS):
        # tile_size binds at construction (the store layout), so the
        # workload is rebuilt per swept tile size from the same seed
        built: Dict[int, tuple] = {}

        def mats(ts):
            if ts not in built:
                with config_override(tile_size=ts):
                    built[ts] = WORKLOADS[wname](seed, dev)
            return built[ts]

        rows = []
        measured: Dict[tuple, set] = {}
        for cfg in combos:
            dkey = _panel_dedup_key(cfg)
            ts = cfg.get("tile_size", get_config().tile_size)
            if cfg.get("mm_driver") == "dense":
                fa, fb = mats(get_config().tile_size)
                if not _dense_fits(fa, fb, ts, dev):
                    say(f"  {wname} {cfg}: declined (the padded dense panels "
                        "exceed free device memory)")
                    continue
            try:
                a, b = mats(ts)
                with config_override(**cfg):
                    fn, _, eff_flops = build_multiply_executor(
                        "N", "N", a, b, driver=cfg.get("mm_driver")
                    )
                    if dkey is not None:
                        panel = fn.plan.panel
                        fp = panel_plan_fingerprint(
                            panel.plan if panel is not None else None
                        )
                        seen = measured.setdefault(dkey, set())
                        if fp in seen:
                            continue  # identical realised launch measured
                        seen.add(fp)
                    dt_per = steady_state_time(fn, (a.data, b.data))
            except Exception as e:  # a combo the port declines: the sweep goes on
                msg = str(e).splitlines()[0][:160] if str(e) else ""
                say(f"  {wname} {cfg}: failed ({type(e).__name__}: {msg})")
                continue
            gflops = eff_flops / dt_per / 1e9
            rows.append({**cfg, "route": fn.plan.route, "gflops": round(gflops, 2)})
            say(f"  {wname} {cfg}: {fn.plan.route}, {dt_per * 1e3:.3f} ms, "
                f"{gflops:9.1f} GFLOP/s")
            del fn
        rows.sort(key=lambda r: -r["gflops"])
        # the feature vector of the swept workload: the key of the
        # nearest-class lookup
        fa, fb = mats(get_config().tile_size)
        feats = [
            round(float(x), 4) for x in workload_features(fa.index, fb.index)
        ]
        results[wname] = {
            "best": rows[0] if rows else None,
            "features": feats,
            "all": rows,
        }
        del built, fa, fb
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"device_kind": device_kind(dev), "results": results}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="dbcsr_tpu_torch autotuner")
    p.add_argument("--out", default=None,
                   help="output JSON path (default: params/<device name>.json)")
    p.add_argument("--workloads", nargs="*", default=None,
                   choices=list(WORKLOADS))
    p.add_argument("--drivers", nargs="*", default=None,
                   choices=list(DRIVER_GRIDS))
    p.add_argument(
        "--merge", action="store_true",
        help="merge swept classes into the existing device table",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to measure on (default cuda; cpu times the "
                        "plain versions)")
    args = p.parse_args(argv)
    try:
        table = sweep(workloads=args.workloads, drivers=args.drivers,
                      seed=args.seed, device=args.device)
    except DbcsrError as e:
        print(f"autotune: {e}", file=sys.stderr)
        return 2
    if args.merge:
        old = load_params(table["device_kind"])
        if old is not None:
            merged = dict(old["results"])
            for cls, res in table["results"].items():
                # a class whose sweep produced no measurement must not
                # clobber a measured entry with best=None
                if res.get("best") is None and merged.get(cls, {}).get(
                    "best"
                ) is not None:
                    print(f"merge: keeping existing {cls} entry "
                          "(new sweep has no successful measurement)")
                    continue
                merged[cls] = res
            table = {**old, **table, "results": merged}
    path = save_params(table, args.out)
    print(f"wrote {path}")
    for wname, res in table["results"].items():
        print(f"{wname}: best = {res['best']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
