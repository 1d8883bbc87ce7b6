"""Random matrix / block-size generators for tests and benchmarks.

Port of ``dbcsr_tpu/ops/random.py`` (reference
``src/ops/dbcsr_test_methods.F``). Randomness comes only from the numpy
``Generator`` the caller passes, consumed in exactly the JAX package's
order, so one seed gives both packages bit-identical matrices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..block.bcsr import BCSRMatrix, SYM_NONE, _host_dtype, torch_dtype

__all__ = ["random_block_sizes", "random_matrix", "random_dist_vector"]


def random_block_sizes(
    total: int, size_choices: Sequence[int], rng: np.random.Generator
) -> np.ndarray:
    """Partition ``total`` full rows/cols into blocks drawn from
    ``size_choices`` (``dbcsr_make_random_block_sizes``)."""
    sizes = []
    left = total
    choices = np.asarray(size_choices, dtype=np.int64)
    while left > 0:
        s = int(rng.choice(choices))
        s = min(s, left)
        sizes.append(s)
        left -= s
    return np.asarray(sizes, dtype=np.int32)


def random_matrix(
    row_block_sizes,
    col_block_sizes,
    occupancy: float,
    rng: np.random.Generator,
    *,
    device,
    name: str = "random",
    dtype=np.float32,
    sym: str = SYM_NONE,
    tile=None,
    dist=None,
) -> BCSRMatrix:
    """Random block-sparse matrix with the given block occupancy
    (``dbcsr_make_random_matrix``), its tile store on ``device``. A
    bfloat16 ``dtype`` draws float32 blocks and rounds the store once; a
    complex ``dtype`` draws each block's imaginary part right after its
    real part."""
    tdt = torch_dtype(dtype)
    hdt = _host_dtype(tdt)
    rbs = np.asarray(row_block_sizes, dtype=np.int32)
    cbs = np.asarray(col_block_sizes, dtype=np.int32)
    nbr, nbc = len(rbs), len(cbs)
    mask = rng.random((nbr, nbc)) < occupancy
    if sym != SYM_NONE:
        mask = np.triu(mask)
    rows, cols = np.nonzero(mask)
    blocks = []
    for i, j in zip(rows, cols):
        blk = rng.standard_normal((rbs[i], cbs[j]))
        if tdt.is_complex:
            blk = blk + 1j * rng.standard_normal((rbs[i], cbs[j]))
        if sym != SYM_NONE and i == j:
            if sym == "S":
                blk = 0.5 * (blk + blk.T)
            elif sym == "A":
                blk = 0.5 * (blk - blk.T)
            elif sym == "H":
                blk = 0.5 * (blk + np.conj(blk.T))
        blocks.append(blk.astype(hdt))
    return BCSRMatrix.from_blocks(
        rows.astype(np.int32), cols.astype(np.int32), blocks, rbs, cbs,
        name=name, sym=sym, dtype=tdt, device=device, tile=tile, dist=dist,
    )


def random_dist_vector(
    n: int, nbins: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Random row/col → bin map (``dbcsr_random_dist``)."""
    rng = rng or np.random.default_rng(0)
    return rng.integers(0, nbins, size=n).astype(np.int32)
