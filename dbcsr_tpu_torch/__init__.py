"""dbcsr_tpu_torch — the PyTorch/CUDA port of dbcsr_tpu for NVIDIA Hopper.

A second package beside ``dbcsr_tpu`` (the JAX reference, which stays as it
is): block-sparse matrices kept at rest as T×T tile stores in torch
tensors, host symbolic planning in numpy, and the local sparse multiply
``C := alpha·op(A)·op(B) + beta·C`` whose stack products run through
hand-written CUDA kernels on an H100 (``csrc/``, built with nvcc at first
use). Plain PyTorch versions of the kernels serve CPU tensors and are the
cross-check. The package imports torch, numpy and scipy, never jax.
"""
from .block.bcsr import (
    BCSRBuilder,
    BCSRMatrix,
    SYM_ANTISYMMETRIC,
    SYM_HERMITIAN,
    SYM_NONE,
    SYM_SYMMETRIC,
)
from .block.index import (
    BCSRIndex,
    build_index,
    convert_offsets_to_sizes,
    convert_sizes_to_offsets,
    merge_index,
)
from .core import (
    Config,
    DbcsrError,
    config_override,
    finalize_lib,
    get_config,
    init_lib,
    print_config,
    print_statistics,
    reset_config,
    set_config,
    timed,
    timer_report,
)
from .mm.engine import build_multiply_executor, multiply
from .ops.random import random_block_sizes, random_matrix
from .ops.transform import desymmetrize, make_dense, make_undense
from . import testing

__version__ = "0.1.0"
