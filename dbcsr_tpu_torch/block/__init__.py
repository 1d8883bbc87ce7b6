from .bcsr import (
    BCSRBuilder,
    BCSRMatrix,
    SYM_ANTISYMMETRIC,
    SYM_HERMITIAN,
    SYM_NONE,
    SYM_SYMMETRIC,
)
from .index import (
    BCSRIndex,
    build_index,
    convert_offsets_to_sizes,
    convert_sizes_to_offsets,
    merge_index,
)
from .store import StoreLayout, store_layout

__all__ = [
    "BCSRBuilder", "BCSRMatrix", "SYM_ANTISYMMETRIC", "SYM_HERMITIAN",
    "SYM_NONE", "SYM_SYMMETRIC", "BCSRIndex", "build_index",
    "convert_offsets_to_sizes", "convert_sizes_to_offsets", "merge_index",
    "StoreLayout", "store_layout",
]
