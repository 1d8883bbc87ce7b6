"""Workload features and the tuned-parameter lookup.

The subset of ``dbcsr_tpu/autotune.py`` the engine's driver selection
reads: the bandedness gate of panel admission (``BANDED_GATE``,
``coords_bandedness``, ``workload_features``) and ``tuned_stack_params``;
and ``steady_state_time``, the per-call time of a plan-once executor that
the ``.perf`` driver reports.
There is no tuned table for this card yet, so the lookup returns None and
every knob keeps its configured value: under ``mm_driver="auto"`` the
grouped driver is never chosen (it needs a tuned preference) and the band
driver only by its flop rule. The sweep that writes a table is ROADMAP
Queue 1 item 6.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

__all__ = [
    "BANDED_GATE",
    "coords_bandedness",
    "index_features",
    "workload_features",
    "tuned_stack_params",
    "steady_state_time",
]

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


def tuned_stack_params(a_index, b_index) -> Optional[dict]:
    """Per-workload-class tuned knobs for this device; None until a table
    measured on this card exists."""
    return None


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
