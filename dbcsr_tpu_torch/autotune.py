"""Workload features and the tuned-parameter lookup.

The subset of ``dbcsr_tpu/autotune.py`` the engine's driver selection
reads: the bandedness gate of panel admission (``BANDED_GATE``,
``coords_bandedness``, ``workload_features``) and ``tuned_stack_params``.
There is no tuned table for this card yet, so the lookup returns None and
every knob keeps its configured value; the sweep that writes a table is
ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "BANDED_GATE",
    "coords_bandedness",
    "index_features",
    "workload_features",
    "tuned_stack_params",
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
