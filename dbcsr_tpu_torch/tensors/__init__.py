"""Block-sparse tensor framework (rank 2..4+).

Port of ``dbcsr_tpu/tensors/`` (SURVEY.md §2.7): tensors fold to 2-D
block-sparse matrices via an nd→2d mapping; contraction aligns operand
layouts and runs the folded product through the TAS layer on the operands'
device. ``TensorPGrid`` and ``default_pgrid_dims`` (``tensors/pgrid.py``)
lay an nd process grid over the port's ``ProcessGrid``; ``contract(...,
dist=...)`` runs the folded product over it.
"""
from .contract import BatchedContract, contract, contraction_layouts, copy_tensor
from .index import NDMapping, fold_indices, grouped_block_sizes, unfold_indices
from .pgrid import TensorPGrid, default_pgrid_dims
from .tensor import (
    Tensor,
    TensorBuilder,
    matrix_from_tensor,
    split_blocks,
    tensor_from_matrix,
)

__all__ = [
    "Tensor",
    "TensorBuilder",
    "NDMapping",
    "contract",
    "contraction_layouts",
    "copy_tensor",
    "split_blocks",
    "BatchedContract",
    "tensor_from_matrix",
    "matrix_from_tensor",
    "fold_indices",
    "unfold_indices",
    "grouped_block_sizes",
    "TensorPGrid",
    "default_pgrid_dims",
]
