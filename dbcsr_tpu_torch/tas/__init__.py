"""Tall-and-skinny (TAS) matrix layer.

Port of ``dbcsr_tpu/tas/`` (SURVEY.md §2.6): matrices where one dimension
is much larger than the other (tensor unfoldings). The long dimension is
partitioned into ``nsplit`` groups; multiplication extracts each group's
blocks, reuses the small operand, runs an ordinary multiply per group, and
merges/sums the results (``dbcsr_tas_multiply``,
``src/tas/dbcsr_tas_mm.F:79-782``). ``tas_multiply_parallel`` and
``tas_multiply_subgrid`` (``tas/parallel.py``) run the groups on ranks of
a process grid, one stack-kernel launch per group.
"""
from .matrix import (
    TASMatrix,
    extract_block_subset,
    merge_col_groups,
    merge_row_groups,
    tas_from_matrix,
)
from .mm import (
    BatchedTAS,
    result_index_estimate,
    split_factor_estimate,
    tas_multiply,
)
from .parallel import tas_multiply_parallel, tas_multiply_subgrid
from .split import COLSPLIT, ROWSPLIT, TASSplit

__all__ = [
    "TASMatrix",
    "TASSplit",
    "ROWSPLIT",
    "COLSPLIT",
    "tas_from_matrix",
    "tas_multiply",
    "split_factor_estimate",
    "result_index_estimate",
    "extract_block_subset",
    "merge_row_groups",
    "merge_col_groups",
    "BatchedTAS",
    "tas_multiply_parallel",
    "tas_multiply_subgrid",
]
