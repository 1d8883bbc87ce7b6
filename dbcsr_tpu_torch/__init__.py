"""dbcsr_tpu_torch — the PyTorch/CUDA port of dbcsr_tpu for NVIDIA Hopper.

A second package beside ``dbcsr_tpu`` (the JAX reference, which stays as it
is): block-sparse matrices kept at rest as T×T tile stores in torch
tensors, host symbolic planning in numpy, and the local sparse multiply
``C := alpha·op(A)·op(B) + beta·C`` — eps-filtered, one-shot or planned
once (``build_filtered_executor``), with the matrix ops of an SCF loop —
whose stack products run through hand-written CUDA kernels on an H100
(``csrc/``, built with nvcc at first use; float32/bfloat16, float64,
complex64 and complex128);
over it, the tall-and-skinny layer (``tas/``) and block-sparse tensor
contraction (``tensors/``); the distributed multiply over a grid of
ranks (``dist/``: Cannon, SUMMA, 2.5D, the sharded at-rest form), driven
by one process or, after ``init_lib(distributed=True)``, by the processes
of a ``torch.distributed`` world.
Plain PyTorch versions of the kernels serve CPU tensors and are the
cross-check. Around the multiply: sub-matrix windows (``limits``),
binary checkpoints and CSR exchange (``ops/io.py``, ``ops/csr.py``),
``retile``, the ``.perf`` driver (``python -m dbcsr_tpu_torch.perf``) and
the built-in self-tests (``testing.run_tests``). The package imports torch,
numpy and scipy, never jax.
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
from .mm.engine import build_distributed_executor, build_multiply_executor, multiply
from .mm.filtered import FilteredExecutor, build_filtered_executor
from .mm.reorder import locality_block_permutation, permute_blocks
from .ops.arithmetic import (
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
from .ops.norms import (
    block_norms,
    block_norms_sq,
    norm_column,
    norm_frobenius,
    norm_gershgorin,
    norm_maxabs,
)
from .ops.csr import csr_write, from_csr, to_csr, to_csr_filter
from .ops.io import (
    binary_read,
    binary_write,
    checksum,
    get_info,
    get_stored_coordinates,
    print_block_sum,
    print_matrix,
    verify_matrix,
)
from .ops.random import random_block_sizes, random_dist_vector, random_matrix
from .ops.transform import (
    copy,
    desymmetrize,
    distribute,
    fold_symmetric,
    make_dense,
    make_undense,
    may_be_dense,
    redistribute,
    replicate_all,
    retile,
    sum_replicated,
    transpose,
)
from . import dist, tas, tensors, testing
from .tas import TASMatrix, tas_multiply
from .tensors import NDMapping, Tensor, TensorBuilder, contract

__version__ = "0.1.0"
