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
from .csr import csr_write, from_csr, to_csr, to_csr_filter
from .io import (
    binary_read,
    binary_write,
    checksum,
    get_info,
    get_stored_coordinates,
    print_block_sum,
    print_matrix,
    verify_matrix,
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
    may_be_dense,
    retile,
    transpose,
)

__all__ = [
    "ELEMENT_FUNCTIONS", "add", "add_on_diag", "crop", "dot", "filter_blocks",
    "function_of_elements", "get_block_diag", "get_diag", "hadamard_product",
    "scale", "scale_by_vector", "set_diag", "set_value", "trace", "triu",
    "zero", "block_norms", "block_norms_sq", "norm_column", "norm_frobenius",
    "norm_gershgorin", "norm_maxabs", "random_block_sizes", "random_matrix",
    "copy", "desymmetrize", "fold_symmetric", "make_dense", "make_undense",
    "may_be_dense", "retile", "transpose", "csr_write", "from_csr", "to_csr",
    "to_csr_filter", "binary_read", "binary_write", "checksum", "get_info",
    "get_stored_coordinates", "print_block_sum", "print_matrix",
    "verify_matrix",
]
