from .random import random_block_sizes, random_matrix
from .transform import desymmetrize, make_dense, make_undense

__all__ = [
    "random_block_sizes", "random_matrix", "desymmetrize", "make_dense",
    "make_undense",
]
