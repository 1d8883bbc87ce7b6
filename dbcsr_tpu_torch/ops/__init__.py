from .arithmetic import (
    ELEMENT_FUNCTIONS,
    add,
    add_on_diag,
    crop,
    dot,
    filter_blocks,
    function_of_elements,
    get_block_diag,
    get_diag,
    hadamard_product,
    scale,
    scale_by_vector,
    set_diag,
    set_value,
    trace,
    triu,
    zero,
)
from .norms import (
    block_norms,
    block_norms_sq,
    norm_column,
    norm_frobenius,
    norm_gershgorin,
    norm_maxabs,
)
from .random import random_block_sizes, random_matrix
from .transform import (
    copy,
    desymmetrize,
    fold_symmetric,
    make_dense,
    make_undense,
    transpose,
)

__all__ = [
    "ELEMENT_FUNCTIONS", "add", "add_on_diag", "crop", "dot", "filter_blocks",
    "function_of_elements", "get_block_diag", "get_diag", "hadamard_product",
    "scale", "scale_by_vector", "set_diag", "set_value", "trace", "triu",
    "zero", "block_norms", "block_norms_sq", "norm_column", "norm_frobenius",
    "norm_gershgorin", "norm_maxabs", "random_block_sizes", "random_matrix",
    "copy", "desymmetrize", "fold_symmetric", "make_dense", "make_undense",
    "transpose",
]
