"""The reference-parity C API over dbcsr_tpu_torch (Python side).

Port of ``dbcsr_tpu/capi/himpl.py``. Backs the ``c_dbcsr_*`` and
``c_dbcsr_t_*`` surface of ``dbcsr_tpu.h`` (the reference's ``src/dbcsr.h``,
100 matrix functions, and ``src/tensors/dbcsr_tensor.h``, 54 tensor
functions) with the reference's MUTATING handle semantics: a handle is a
:class:`Cell` whose contents the calls rebind (``c_dbcsr_multiply_d`` writes
into the C handle, ``c_dbcsr_add_d`` updates A in place, ...). The legacy
value-returning surface in ``helpers.py`` sits beside it.

Typed families (``_d/_s/_z/_c``) share one implementation parameterized by
the type char (d, s, z, c: float64, float32, complex128, complex64);
complex scalars arrive as (re, im) doubles, complex buffers as interleaved
re/im pairs of the real type, viewed as complex numpy arrays.

The device rule: :func:`init_lib` reads ``DBCSR_CAPI_DEVICE`` (``cuda``, the
default, ``cuda:N`` or ``cpu``) and fails when it names a CUDA device that
is not there; nothing falls back to the CPU. Every matrix, tensor, grid and
read checkpoint the shim makes lives on that device.

Deviations from the reference, documented here once:
- communicator arguments are accepted and ignored; ``distribution_new``
  builds a ``ProcessGrid`` of p×q virtual ranks on the shim's device, and a
  multiply over distributed handles runs the port's distributed executor;
- pointer returns (``get_block_p``, ``get_data``, the iterators) copy into
  the caller's buffer from a per-handle host mirror that the call refreshes:
  a CPU copy of the device data, taken after the device has finished. No
  pointer into a torch storage is ever handed out.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import replace
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..block.bcsr import BCSRBuilder, BCSRMatrix
from ..core.errors import DbcsrError
from ..core.lib import finalize_lib as _finalize_lib
from ..core.lib import init_lib as _init_lib
from ..mm.engine import multiply as _multiply
from ..ops import arithmetic as _ar
from ..ops import io as _io
from ..ops import norms as _norms
from ..ops import transform as _tr

#: the environment variable that names the shim's device
DEVICE_ENV = "DBCSR_CAPI_DEVICE"

# --- type classes ----------------------------------------------------------

#: host (marshalling) dtype of each type class
_DTYPES = {
    "d": np.float64,
    "s": np.float32,
    "z": np.complex128,
    "c": np.complex64,
}
#: reference data_type constants (dbcsr.h:17-20)
_DTYPE_CONST = {1: torch.float32, 3: torch.float64, 5: torch.complex64,
                7: torch.complex128}
_CONST_OF_DTYPE = {v: k for k, v in _DTYPE_CONST.items()}
_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
                torch.complex64: np.complex64, torch.complex128: np.complex128}

_CTYPES = {
    "d": ctypes.c_double,
    "s": ctypes.c_float,
    # complex marshalled as interleaved re/im pairs of the base real type
    "z": ctypes.c_double,
    "c": ctypes.c_float,
}


def _scalar(typ: str, re: float, im: float):
    if typ in ("z", "c"):
        return complex(re, im)
    return float(re)


def _buf(typ: str, addr: int, n: int) -> np.ndarray:
    """View ``n`` elements of type class ``typ`` at ``addr`` (no copy)."""
    base = _CTYPES[typ]
    mult = 2 if typ in ("z", "c") else 1
    raw = (base * (n * mult)).from_address(addr)
    arr = np.frombuffer(raw, dtype=base)
    if mult == 2:
        return arr.view(_DTYPES[typ])
    return arr


def _i32buf(addr: int, n: int) -> np.ndarray:
    return np.frombuffer(
        (ctypes.c_int32 * n).from_address(addr), dtype=np.int32
    ).copy()


def _i32out(addr: int, n: int) -> np.ndarray:
    """WRITABLE int32 view of the caller's buffer (``_i32buf`` copies)."""
    return np.frombuffer(
        (ctypes.c_int32 * n).from_address(addr), dtype=np.int32
    )


class Cell:
    """Mutable handle target: matrices/tensors rebind ``obj`` in place."""

    __slots__ = ("obj", "mirror")

    def __init__(self, obj: Any = None):
        self.obj = obj
        self.mirror: Optional[np.ndarray] = None  # host mirror of pointer returns


def _refresh_mirror(cell: Cell, flat: np.ndarray) -> np.ndarray:
    """Make ``flat`` (a host copy, complete once ``.cpu()`` returned) the
    handle's host mirror and return it."""
    cell.mirror = flat
    return flat


def _mat(cell: Cell) -> BCSRMatrix:
    o = cell.obj
    if isinstance(o, BCSRBuilder):
        # implicit finalize mirrors the reference's forgiving access order
        cell.obj = o.finalize()
        return cell.obj
    if not isinstance(o, BCSRMatrix):
        raise DbcsrError("handle is not a matrix")
    return o


def _bld(cell: Cell) -> BCSRBuilder:
    o = cell.obj
    if isinstance(o, BCSRBuilder):
        return o
    if isinstance(o, BCSRMatrix):
        # reopen for mutation: seed a builder with the existing blocks
        b = BCSRBuilder(
            o.index.row_block_sizes, o.index.col_block_sizes, name=o.name,
            dtype=o.dtype, sym=o.sym, dist=o.dist, tile=o.tile, device=o.device,
        )
        for r, c, blk in o.iter_blocks():
            b.put_block(r, c, blk)
        cell.obj = b
        return b
    raise DbcsrError("handle is not a matrix")


# --- lifecycle and the device ----------------------------------------------

_device: Optional[torch.device] = None


def device_from_env() -> torch.device:
    """The device ``DBCSR_CAPI_DEVICE`` names (default ``cuda``); raises
    when it is malformed or names a CUDA device that is not there."""
    name = os.environ.get(DEVICE_ENV, "cuda").strip() or "cuda"
    try:
        dev = torch.device(name)
    except RuntimeError:
        raise DbcsrError(
            f"{DEVICE_ENV}={name!r} is not a device (cuda, cuda:N or cpu)"
        ) from None
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DbcsrError(f"{DEVICE_ENV}={name!r}: the shim runs on cuda or cpu")
    if not torch.cuda.is_available():
        raise DbcsrError(
            f"{DEVICE_ENV}={name!r} but torch finds no CUDA device; set "
            f"{DEVICE_ENV}=cpu to run the C API on the CPU"
        )
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise DbcsrError(
            f"{DEVICE_ENV}={name!r}: only {torch.cuda.device_count()} CUDA devices"
        )
    return torch.device("cuda", index)


def device() -> torch.device:
    """The shim's device (set by :func:`init_lib`)."""
    if _device is None:
        raise DbcsrError("c_dbcsr_init_lib has not been called (or failed)")
    return _device


def init_lib(comm: int, io_unit: int) -> None:
    global _device
    del comm, io_unit  # ranks come from distributions; io from logging
    _device = device_from_env()
    _init_lib()


def finalize_lib() -> None:
    _finalize_lib()


def clear_mempools() -> None:
    if _device is not None and _device.type == "cuda":
        torch.cuda.empty_cache()


def mp_grid_setup(dist_cell: Cell) -> None:
    # grids are carried by the Distribution itself here
    del dist_cell


def print_statistics(print_timers: int, callgraph_filename: str) -> None:
    from ..core.stats import print_statistics as ps
    from ..core.timing import timer_report, timings_report_callgraph

    print(ps())
    if print_timers:
        print(timer_report())
    if callgraph_filename:
        timings_report_callgraph(callgraph_filename)


# --- distribution ----------------------------------------------------------

def distribution_new(
    comm: int, rd_addr: int, n_rd: int, cd_addr: int, n_cd: int
) -> Cell:
    """A p×q grid of virtual ranks on the shim's device, p and q from the
    largest entries of the maps (the grid asked for, however large)."""
    from ..dist import Distribution, ProcessGrid

    del comm
    row_dist = _i32buf(rd_addr, n_rd)
    col_dist = _i32buf(cd_addr, n_cd)
    p = int(row_dist.max(initial=0)) + 1
    q = int(col_dist.max(initial=0)) + 1
    grid = ProcessGrid.make(p, q, devices=[device()] * (p * q))
    return Cell(Distribution(grid=grid, row_dist=row_dist, col_dist=col_dist))


def distribution_hold(cell: Cell) -> None:
    del cell  # handle table owns one reference; C-side hold is a no-op


def distribution_get(cell: Cell) -> Tuple[int, int, int, int]:
    d = cell.obj
    return (d.grid.nprow, d.grid.npcol, len(d.row_dist), len(d.col_dist))


# --- create / assembly -----------------------------------------------------

def create_new(
    name: str,
    dist_cell: Optional[Cell],
    matrix_type: str,
    rs_addr: int,
    n_rs: int,
    cs_addr: int,
    n_cs: int,
    data_type: int,
) -> Cell:
    dtype = _DTYPE_CONST.get(data_type, torch.float64)
    sym = matrix_type if matrix_type in ("N", "S", "A", "H") else "N"
    dist = dist_cell.obj if dist_cell is not None else None
    return Cell(BCSRBuilder(
        _i32buf(rs_addr, n_rs), _i32buf(cs_addr, n_cs), name=name,
        dtype=dtype, sym=sym, dist=dist, device=device(),
    ))


def create_template(
    template_cell: Cell,
    name: str,
    dist_cell: Optional[Cell],
    matrix_type: str,
    data_type: int,
) -> Cell:
    t = _mat(template_cell)
    dtype = _DTYPE_CONST.get(data_type, t.dtype)
    sym = matrix_type if matrix_type in ("N", "S", "A", "H") else t.sym
    dist = dist_cell.obj if dist_cell is not None else t.dist
    return Cell(BCSRBuilder(
        t.index.row_block_sizes, t.index.col_block_sizes,
        name=name or t.name, dtype=dtype, sym=sym, dist=dist, tile=t.tile,
        device=device(),
    ))


def finalize(cell: Cell) -> None:
    if isinstance(cell.obj, BCSRBuilder):
        cell.obj = cell.obj.finalize()


def put_block2d(
    cell: Cell, typ: str, row: int, col: int, addr: int, m: int, n: int,
    summation: int,
) -> None:
    # astype copies: the builder must not keep the caller's memory
    blk = _buf(typ, addr, m * n).reshape(m, n).astype(_DTYPES[typ])
    _bld(cell).put_block(row, col, blk, sum=bool(summation))


def reserve_block2d(cell: Cell, row: int, col: int) -> None:
    _bld(cell).reserve_block(row, col)


def reserve_blocks(cell: Cell, rows_addr: int, cols_addr: int, n: int) -> None:
    _bld(cell).reserve_blocks(_i32buf(rows_addr, n), _i32buf(cols_addr, n))


def reserve_all_blocks(cell: Cell) -> None:
    _bld(cell).reserve_all_blocks()


def reserve_diag_blocks(cell: Cell) -> None:
    _bld(cell).reserve_diag_blocks()


# --- block access ----------------------------------------------------------

def get_block_p(
    cell: Cell, typ: str, row: int, col: int, out_addr: int
) -> Tuple[int, int, int]:
    """(found, m, n); copies into out_addr when nonzero."""
    blk = _mat(cell).get_block(row, col)
    if blk is None:
        return (0, 0, 0)
    blk = _refresh_mirror(cell, np.asarray(blk, dtype=_DTYPES[typ]))
    if out_addr:
        _buf(typ, out_addr, blk.size)[:] = blk.reshape(-1)
    return (1, blk.shape[0], blk.shape[1])


def get_stored_coordinates(cell: Cell, row: int, col: int) -> int:
    v = _io.get_stored_coordinates(_mat(cell), row, col)
    return -1 if v is None else int(v)


def get_block_diag(cell: Cell) -> Cell:
    return Cell(_ar.get_block_diag(_mat(cell)))


def get_diag(cell: Cell, typ: str, out_addr: int, n: int) -> None:
    d = _ar.get_diag(_mat(cell)).cpu().numpy().astype(_DTYPES[typ])
    k = min(n, len(d))
    _buf(typ, out_addr, n)[:k] = d[:k]


def set_diag(cell: Cell, typ: str, addr: int, n: int) -> None:
    cell.obj = _ar.set_diag(_mat(cell), _buf(typ, addr, n).astype(_DTYPES[typ]))


def add_on_diag(cell: Cell, typ: str, re: float, im: float) -> None:
    cell.obj = _ar.add_on_diag(_mat(cell), _scalar(typ, re, im))


# --- iterators -------------------------------------------------------------

class _Iter:
    def __init__(self, m: BCSRMatrix):
        # one host transfer: the iterator's blocks are views of this copy
        self.blocks = list(m.iter_blocks())
        self.pos = 0


def iterator_start(cell: Cell) -> Cell:
    return Cell(_Iter(_mat(cell)))


def iterator_blocks_left(it_cell: Cell) -> int:
    it = it_cell.obj
    return int(it.pos < len(it.blocks))


def iterator_next_block_index(it_cell: Cell) -> Tuple[int, int, int]:
    """(row, col, blk_size); advances."""
    it = it_cell.obj
    r, c, blk = it.blocks[it.pos]
    it.pos += 1
    return (int(r), int(c), int(blk.size))


def iterator_next_2d_block(
    it_cell: Cell, typ: str, out_addr: int
) -> Tuple[int, int, int, int]:
    """(row, col, m, n); copies block data when out_addr != 0."""
    it = it_cell.obj
    r, c, blk = it.blocks[it.pos]
    it.pos += 1
    blk = np.asarray(blk, dtype=_DTYPES[typ])
    if out_addr:
        _buf(typ, out_addr, blk.size)[:] = blk.reshape(-1)
    return (int(r), int(c), blk.shape[0], blk.shape[1])


def iterator_stop(it_cell: Cell) -> None:
    it_cell.obj = None


# --- info / properties -----------------------------------------------------

def get_info(cell: Cell) -> Tuple[int, int, int, int, int]:
    m = _mat(cell)
    return (m.nblkrows, m.nblkcols, m.shape[0], m.shape[1], m.nblks)


def get_name(cell: Cell) -> str:
    return _mat(cell).name


def setname(cell: Cell, name: str) -> None:
    cell.obj = replace(_mat(cell), name=name)


def get_matrix_type(cell: Cell) -> str:
    return _mat(cell).sym


def has_symmetry(cell: Cell) -> int:
    return int(_mat(cell).sym != "N")


def get_data_type(cell: Cell) -> int:
    return _CONST_OF_DTYPE[_mat(cell).dtype]


def get_data_size(cell: Cell) -> int:
    return int(_mat(cell).index.nelems)


def get_data(cell: Cell, typ: str, out_addr: int, n: int) -> int:
    """Copy the flat block data (reference data_area layout) into the
    caller's buffer; returns the element count."""
    flat = _refresh_mirror(cell, _mat(cell).flat_host().astype(_DTYPES[typ]))
    if out_addr:
        k = min(n, flat.size)
        _buf(typ, out_addr, k)[:] = flat[:k]
    return int(flat.size)


def get_num_blocks(cell: Cell) -> int:
    return _mat(cell).nblks


def nblkrows_total(cell: Cell) -> int:
    return _mat(cell).nblkrows


def nblkcols_total(cell: Cell) -> int:
    return _mat(cell).nblkcols


def nblkrows_local(cell: Cell) -> int:
    return _mat(cell).nblkrows  # one controller: local == total


def nblkcols_local(cell: Cell) -> int:
    return _mat(cell).nblkcols


def nfullrows_total(cell: Cell) -> int:
    return _mat(cell).shape[0]


def nfullcols_total(cell: Cell) -> int:
    return _mat(cell).shape[1]


def get_infovar(cell: Cell, which: str, out_addr: int, size: int) -> None:
    """One of the reference's ``c_dbcsr_get_${var}$`` info arrays
    (``src/dbcsr.h:282-287``) copied into the caller's int buffer (first
    ``min(size, len)`` entries). The reference's C API returns
    ``local_rows``/``local_cols``/``row_blk_offset``/``col_blk_offset``
    0-based (``src/dbcsr_api_c.F:1373-1380``), and so does this. Local
    rows/cols == all rows/cols on one controller; proc dists are ranks,
    all-zero for undistributed matrices."""
    m = _mat(cell)
    ix = m.index
    if which == "local_rows":
        arr = np.arange(ix.nblkrows, dtype=np.int32)
    elif which == "local_cols":
        arr = np.arange(ix.nblkcols, dtype=np.int32)
    elif which == "proc_row_dist":
        arr = m.dist.row_dist if m.dist is not None else np.zeros(ix.nblkrows, np.int32)
    elif which == "proc_col_dist":
        arr = m.dist.col_dist if m.dist is not None else np.zeros(ix.nblkcols, np.int32)
    elif which == "row_blk_size":
        arr = ix.row_block_sizes
    elif which == "col_blk_size":
        arr = ix.col_block_sizes
    elif which == "row_blk_offset":
        arr = ix.row_offsets[:-1]
    elif which == "col_blk_offset":
        arr = ix.col_offsets[:-1]
    else:
        raise DbcsrError(f"unknown info var {which!r}")
    arr = np.asarray(arr, dtype=np.int32)
    n = min(int(size), len(arr))
    if n > 0:
        _i32out(out_addr, n)[:] = arr[:n]


def get_occupation(cell: Cell) -> float:
    return float(_mat(cell).occupation())


def valid_index(cell: Cell) -> int:
    return int(isinstance(cell.obj, BCSRMatrix))


def get_distribution(cell: Cell) -> Cell:
    return Cell(_mat(cell).dist)


def get_group(cell: Cell) -> int:
    return 0  # communicator handle: one controller


# --- primitive ops (typed) -------------------------------------------------

def set_value(cell: Cell, typ: str, re: float, im: float) -> None:
    cell.obj = _ar.set_value(_mat(cell), _scalar(typ, re, im))


def clear(cell: Cell) -> None:
    cell.obj = _ar.zero(_mat(cell))


def add(cell_a: Cell, cell_b: Cell, typ: str, ar: float, ai: float,
        br: float, bi: float) -> None:
    """A <- alpha*A + beta*B (mutates A, the reference's signature)."""
    cell_a.obj = _ar.add(
        _scalar(typ, ar, ai), _mat(cell_a), _scalar(typ, br, bi), _mat(cell_b),
    )


def scale(cell: Cell, typ: str, re: float, im: float) -> None:
    cell.obj = _ar.scale(_mat(cell), _scalar(typ, re, im))


def scale_by_vector(
    cell: Cell, typ: str, addr: int, n: int, side: str
) -> None:
    vec = _buf(typ, addr, n).astype(_DTYPES[typ])
    cell.obj = _ar.scale_by_vector(_mat(cell), vec, side)


def multiply(
    typ: str, transa: str, transb: str, ar: float, ai: float,
    cell_a: Cell, cell_b: Cell, br: float, bi: float, cell_c: Cell,
    retain_sparsity: int, filter_eps: float,
) -> float:
    """C <- alpha*op(A)op(B) + beta*C into the C handle; returns flops. A
    distribution on C (else on A) runs the product over its grid."""
    c_in = cell_c.obj if isinstance(cell_c.obj, BCSRMatrix) else None
    out, fl = _multiply(
        transa, transb, _scalar(typ, ar, ai), _mat(cell_a), _mat(cell_b),
        _scalar(typ, br, bi), c_in,
        filter_eps=None if filter_eps < 0 else filter_eps,
        retain_sparsity=bool(retain_sparsity), return_flops=True,
    )
    cell_c.obj = out
    return float(fl)


def trace(cell: Cell) -> complex:
    return complex(_ar.trace(_mat(cell)))


def dot(cell_a: Cell, cell_b: Cell) -> complex:
    return complex(_ar.dot(_mat(cell_a), _mat(cell_b)))


def filter_matrix(cell: Cell, eps: float) -> None:
    cell.obj = _ar.filter_blocks(_mat(cell), eps)


#: reference dbcsr_func_* constants (dbcsr.h:29-41)
_ELEMENT_FUNCTIONS = {
    0: "inverse", 1: "tanh", 2: "dtanh", 3: "ddtanh", 4: "artanh",
    5: "inverse_special", 7: "sin", 11: "cos",
}


def function_of_elements(cell: Cell, func: int, a0: float, a1: float,
                         a2: float) -> None:
    if func not in _ELEMENT_FUNCTIONS:
        raise DbcsrError(f"unsupported element function id {func}")
    del a0, a1, a2
    cell.obj = _ar.function_of_elements(_mat(cell), _ELEMENT_FUNCTIONS[func])


def hadamard_product(cell_a: Cell, cell_b: Cell, cell_c: Cell) -> None:
    cell_c.obj = _ar.hadamard_product(_mat(cell_a), _mat(cell_b))


def triu(cell: Cell) -> None:
    cell.obj = _ar.triu(_mat(cell))


#: seed of ``c_dbcsr_init_random`` (the JAX package's ``default_seed``)
_RANDOM_SEED = 0


def init_random(cell: Cell, keep_sparsity: int) -> None:
    from ..ops.random import random_matrix

    m = _mat(cell)
    rng = np.random.default_rng(_RANDOM_SEED)
    if keep_sparsity and m.nblks:
        flat = rng.standard_normal(m.index.nelems)
        if m.dtype.is_complex:
            flat = flat + 1j * rng.standard_normal(m.index.nelems)
        cell.obj = m.with_flat(flat.astype(_NP_OF_TORCH[m.dtype]))
    else:
        cell.obj = random_matrix(
            m.index.row_block_sizes, m.index.col_block_sizes, 0.5, rng,
            dtype=m.dtype, sym=m.sym, device=m.device, tile=m.tile,
        )


# --- transformations -------------------------------------------------------

def copy(cell_to: Cell, cell_from: Cell, name: str) -> None:
    cell_to.obj = _tr.copy(_mat(cell_from), name=name or None)


def copy_into_existing(cell_to: Cell, cell_from: Cell) -> None:
    """Copy FROM's values into TO, RETAINING TO's sparsity
    (``dbcsr_copy_into_existing``, ``src/ops/dbcsr_operations.F:1335``):
    the result keeps exactly TO's block pattern, with values taken from
    FROM where it has blocks and zero elsewhere."""
    to = _mat(cell_to)
    frm = _mat(cell_from)
    inter = _ar.hadamard_product(frm, _ar.set_value(to, 1.0))
    # union with 0*TO restores TO-only blocks (as zeros) -> TO's pattern
    cell_to.obj = _ar.add(1.0, inter, 0.0, to)


def desymmetrize(cell: Cell) -> Cell:
    return Cell(_tr.desymmetrize(_mat(cell)))


def transposed(cell: Cell) -> Cell:
    return Cell(_tr.transpose(_mat(cell)))


def complete_redistribute(cell: Cell, dist_cell: Cell) -> Cell:
    return Cell(_tr.complete_redistribute(_mat(cell), dist_cell.obj))


def distribute(cell: Cell, dist_cell: Optional[Cell]) -> None:
    cell.obj = _tr.distribute(
        _mat(cell), dist_cell.obj if dist_cell is not None else None
    )


def replicate_all(cell: Cell) -> None:
    cell.obj = _tr.replicate_all(_mat(cell))


def sum_replicated(cell: Cell) -> None:
    # one controller: the replicas are already one store (parity no-op)
    _mat(cell)


# --- norms / io ------------------------------------------------------------

def frobenius_norm(cell: Cell) -> float:
    return float(_norms.norm_frobenius(_mat(cell)))


def gershgorin_norm(cell: Cell) -> float:
    return float(_norms.norm_gershgorin(_mat(cell)))


def maxabs(cell: Cell) -> float:
    return float(_norms.norm_maxabs(_mat(cell)))


_NORMS = {1: _norms.norm_frobenius, 2: _norms.norm_maxabs,
          3: _norms.norm_gershgorin, 4: _norms.norm_column}


def norm_scalar(cell: Cell, which: int) -> float:
    if which not in _NORMS:
        raise DbcsrError(f"unknown norm kind {which}")
    return float(_NORMS[which](_mat(cell)))


def checksum(cell: Cell, pos: int) -> float:
    return float(_io.checksum(_mat(cell), pos=bool(pos)))


def print_matrix(cell: Cell) -> None:
    _io.print_matrix(_mat(cell))


def print_block_sum(cell: Cell) -> None:
    _io.print_block_sum(_mat(cell))


def binary_write(cell: Cell, path: str) -> None:
    _io.binary_write(_mat(cell), path)


def binary_read(path: str) -> Cell:
    return Cell(_io.binary_read(path, device=device()))


# ===========================================================================
# tensor C API (c_dbcsr_t_*, src/tensors/dbcsr_tensor.h)
# ===========================================================================

from ..tensors import (  # noqa: E402
    BatchedContract,
    NDMapping,
    Tensor,
    TensorBuilder,
    TensorPGrid,
    contract as t_contract_py,
    copy_tensor,
    matrix_from_tensor,
    split_blocks,
    tensor_from_matrix,
)


def t_pgrid_create(ndim: int, dims_addr: int) -> Cell:
    """An nd pgrid of virtual ranks on the shim's device: ``dims`` as given,
    else one rank."""
    dims = _i32buf(dims_addr, ndim) if dims_addr else None
    if dims is None or (dims <= 0).any():
        return Cell(TensorPGrid.make(ndim, devices=[device()]))
    nranks = int(np.prod(dims))
    return Cell(TensorPGrid.make(ndim, dims=tuple(int(x) for x in dims),
                                 devices=[device()] * nranks))


def t_pgrid_destroy(cell: Cell) -> None:
    cell.obj = None


def t_distribution_new(pgrid_cell: Optional[Cell], ndim: int) -> Cell:
    # distribution vectors are derived per tensor here (load-balanced
    # default, dbcsr_t_default_distvec); the handle carries the pgrid
    return Cell(pgrid_cell.obj if pgrid_cell is not None else None)


def t_distribution_destroy(cell: Cell) -> None:
    cell.obj = None


def t_create_new(
    name: str,
    ndim: int,
    nblk_addr: int,
    sizes_addrs: List[int],
    map1: List[int],
    map2: List[int],
    data_type: int,
) -> Cell:
    nblk = _i32buf(nblk_addr, ndim)
    block_sizes = [_i32buf(sizes_addrs[d], int(nblk[d])) for d in range(ndim)]
    mapping = NDMapping(ndim=ndim, map1=tuple(map1), map2=tuple(map2))
    return Cell(TensorBuilder(
        block_sizes, mapping, name=name,
        dtype=_DTYPE_CONST.get(data_type, torch.float64), device=device(),
    ))


def t_create_template(template_cell: Cell, name: str, data_type: int) -> Cell:
    t = _tensor(template_cell)
    return Cell(TensorBuilder(
        list(t.block_sizes), t.mapping, name=name,
        dtype=_DTYPE_CONST.get(data_type, t.dtype), device=device(),
    ))


def t_create_matrix(mat_cell: Cell, name: str) -> Cell:
    return Cell(tensor_from_matrix(_mat(mat_cell), name=name or None))


def _tensor(cell: Cell) -> Tensor:
    o = cell.obj
    if isinstance(o, TensorBuilder):
        cell.obj = o.finalize()
        return cell.obj
    if not isinstance(o, Tensor):
        raise DbcsrError("handle is not a tensor")
    return o


def _tbld(cell: Cell) -> TensorBuilder:
    o = cell.obj
    if isinstance(o, TensorBuilder):
        return o
    if isinstance(o, Tensor):
        tb = TensorBuilder(
            list(o.block_sizes), o.mapping, name=o.name, dtype=o.dtype,
            device=o.device,
        )
        for bi, blk in o.iter_blocks():
            tb.put_block(bi, blk)
        cell.obj = tb
        return tb
    raise DbcsrError("handle is not a tensor")


def t_destroy(cell: Cell) -> None:
    cell.obj = None


def t_finalize(cell: Cell) -> None:
    if isinstance(cell.obj, TensorBuilder):
        cell.obj = cell.obj.finalize()


def t_put_block(
    cell: Cell, typ: str, ndim: int, index_addr: int, sizes_addr: int,
    data_addr: int, summation: int,
) -> None:
    bi = tuple(int(x) for x in _i32buf(index_addr, ndim))
    shp = tuple(int(x) for x in _i32buf(sizes_addr, ndim))
    n = int(np.prod(shp)) if shp else 1
    blk = _buf(typ, data_addr, n).reshape(shp).astype(_DTYPES[typ])
    _tbld(cell).put_block(bi, blk, sum=bool(summation))


def t_get_block(
    cell: Cell, typ: str, ndim: int, index_addr: int, out_addr: int
) -> Tuple[int, List[int]]:
    bi = tuple(int(x) for x in _i32buf(index_addr, ndim))
    blk = _tensor(cell).get_block(bi)
    if blk is None:
        return (0, [0] * ndim)
    blk = _refresh_mirror(cell, np.asarray(blk, dtype=_DTYPES[typ]))
    if out_addr:
        _buf(typ, out_addr, blk.size)[:] = blk.reshape(-1)
    return (1, list(blk.shape))


def t_reserve_blocks_index(cell: Cell, n: int, index_addrs: List[int]) -> None:
    tb = _tbld(cell)
    ndim = len(index_addrs)
    cols = [_i32buf(index_addrs[d], n) for d in range(ndim)]
    for i in range(n):
        tb.reserve_block(tuple(int(cols[d][i]) for d in range(ndim)))


def t_reserve_blocks_template(cell_from: Cell, cell_to: Cell) -> None:
    src = _tensor(cell_from)
    tb = _tbld(cell_to)
    for bi in src.block_indices():
        tb.reserve_block(tuple(int(x) for x in bi))


def _contract_bounds(contract_1, notcontract_1, notcontract_2,
                     bounds_1, bounds_2, bounds_3) -> Optional[dict]:
    """The reference's ``bounds_1/2/3`` (contracted dims / notcontract_1 /
    notcontract_2), flattened [lo0, hi0, lo1, hi1, ...] as 0-based
    half-open element ranges, as :func:`contract`'s ``bounds``; (0, -1)
    means the whole range."""
    def unflatten(dims, flat):
        if not flat:
            return None
        out = {}
        for i, d in enumerate(dims):
            lo, hi = int(flat[2 * i]), int(flat[2 * i + 1])
            if (lo, hi) != (0, -1):
                out[int(d)] = (lo, hi)
        return out or None

    bounds = {}
    for key, dims, flat in (("contract", contract_1, bounds_1),
                            ("nc1", notcontract_1, bounds_2),
                            ("nc2", notcontract_2, bounds_3)):
        b = unflatten(dims, flat)
        if b:
            bounds[key] = b
    return bounds or None


def t_contract(
    typ: str, ar: float, ai: float, cell_a: Cell, cell_b: Cell,
    br: float, bi_: float, cell_c: Cell,
    contract_1: List[int], notcontract_1: List[int],
    contract_2: List[int], notcontract_2: List[int],
    map_1: List[int], map_2: List[int],
    filter_eps: float,
    bounds_1: Optional[List[int]] = None,
    bounds_2: Optional[List[int]] = None,
    bounds_3: Optional[List[int]] = None,
) -> float:
    """C <- alpha*contract(A,B) + beta*C; returns effective flops."""
    del map_1, map_2  # result layout is derived (optimize_dist analog)
    c_in = cell_c.obj if isinstance(cell_c.obj, Tensor) else None
    out, fl = t_contract_py(
        _scalar(typ, ar, ai), _tensor(cell_a), _tensor(cell_b),
        contract_1=tuple(contract_1), notcontract_1=tuple(notcontract_1),
        contract_2=tuple(contract_2), notcontract_2=tuple(notcontract_2),
        beta=_scalar(typ, br, bi_), c=c_in,
        filter_eps=None if filter_eps < 0 else filter_eps,
        bounds=_contract_bounds(contract_1, notcontract_1, notcontract_2,
                                bounds_1, bounds_2, bounds_3),
        return_flops=True,
    )
    cell_c.obj = out
    return float(fl)


def _contract_index(cell_a: Cell, cell_b: Cell, contract_1, notcontract_1,
                    contract_2, notcontract_2, filter_eps: float = -1.0) -> Tensor:
    return t_contract_py(
        1.0, _tensor(cell_a), _tensor(cell_b),
        contract_1=tuple(contract_1), notcontract_1=tuple(notcontract_1),
        contract_2=tuple(contract_2), notcontract_2=tuple(notcontract_2),
        filter_eps=None if filter_eps < 0 else filter_eps,
    )


def t_contract_index(
    cell_a: Cell, cell_b: Cell, cell_c: Cell,
    contract_1: List[int], notcontract_1: List[int],
    contract_2: List[int], notcontract_2: List[int],
) -> int:
    """Number of result blocks the contraction would produce (the
    reference's index-only estimate, c_dbcsr_t_contract_index)."""
    del cell_c
    return int(_contract_index(cell_a, cell_b, contract_1, notcontract_1,
                               contract_2, notcontract_2).nblks)


def t_contract_index_typed(
    typ: str, ar: float, ai: float, cell_a: Cell, cell_b: Cell,
    br: float, bi_: float, cell_c: Cell,
    contract_1: List[int], notcontract_1: List[int],
    contract_2: List[int], notcontract_2: List[int],
    filter_eps: float, result_index_addr: int, result_index_size: int,
) -> int:
    """Typed index-only contraction estimate (the reference's
    ``c_dbcsr_t_contract_index_${dsuffix}$``,
    ``src/tensors/dbcsr_tensor.h:82-87``): returns the result block count
    and writes the block coordinates (row-major ``[nblks, ndim_c]``,
    0-based) into the caller's int buffer, truncated to
    ``result_index_size`` ints. The index is dtype- and scale-independent:
    the typed alpha / beta exist for the reference's signature."""
    del typ, ar, ai, br, bi_, cell_c
    out = _contract_index(cell_a, cell_b, contract_1, notcontract_1,
                          contract_2, notcontract_2, filter_eps)
    idx = np.asarray(out.block_indices(), dtype=np.int32)
    if result_index_addr and result_index_size > 0:
        flat = idx.ravel()[: int(result_index_size)]
        if len(flat):
            _i32out(result_index_addr, len(flat))[:] = flat
    return int(out.nblks)


def t_copy(cell_from: Cell, cell_to: Cell, summation: int) -> None:
    src = _tensor(cell_from)
    dst = _tensor(cell_to)
    out = copy_tensor(src, mapping=dst.mapping)
    if summation:
        tb = _tbld(cell_to)
        for bi, blk in out.iter_blocks():
            tb.put_block(tuple(int(x) for x in bi), blk, sum=True)
        cell_to.obj = tb.finalize()
    else:
        cell_to.obj = out


def t_copy_matrix_to_tensor(mat_cell: Cell, t_cell: Cell) -> None:
    t_cell.obj = tensor_from_matrix(_mat(mat_cell))


def t_copy_tensor_to_matrix(t_cell: Cell, mat_cell: Cell) -> None:
    mat_cell.obj = matrix_from_tensor(_tensor(t_cell))


def _with_matrix(t: Tensor, m: BCSRMatrix) -> Tensor:
    return Tensor(name=t.name, block_sizes=t.block_sizes, mapping=t.mapping, matrix=m)


def t_filter(
    cell: Cell, eps: float, method: int = 1, use_absolute: int = 0
) -> None:
    """Frobenius block filter. ``method`` must be 1 (the reference's
    ``dbcsr_filter_frobenius``, its only supported method); passing
    ``use_absolute`` nonzero scales ``eps`` by the tensor's maxabs norm —
    the reference applies that scaling whenever the argument is PRESENT
    (``src/ops/dbcsr_operations.F:1912``)."""
    if method != 1:
        raise DbcsrError("only Frobenius filtering (method=1) is supported")
    t = _tensor(cell)
    # filter the folded 2-D representation: its blocks ARE the tensor
    # blocks element for element, so Frobenius norms agree at any rank
    m = t.matrix
    if use_absolute:
        eps = eps * _norms.norm_maxabs(m)
    cell.obj = _with_matrix(t, _ar.filter_blocks(m, eps))


def t_scale(cell: Cell, typ: str, re: float, im: float) -> None:
    t = _tensor(cell)
    cell.obj = _with_matrix(t, _ar.scale(t.matrix, _scalar(typ, re, im)))


def t_set(cell: Cell, typ: str, re: float, im: float) -> None:
    t = _tensor(cell)
    cell.obj = _with_matrix(t, _ar.set_value(t.matrix, _scalar(typ, re, im)))


def t_clear(cell: Cell) -> None:
    t = _tensor(cell)
    cell.obj = _with_matrix(t, _ar.zero(t.matrix))


class _TIter:
    def __init__(self, t: Tensor):
        self.blocks = list(t.iter_blocks())
        self.pos = 0


def t_iterator_start(cell: Cell) -> Cell:
    return Cell(_TIter(_tensor(cell)))


def t_iterator_blocks_left(it_cell: Cell) -> int:
    it = it_cell.obj
    return int(it.pos < len(it.blocks))


def t_iterator_next_block(
    it_cell: Cell, typ: str, out_addr: int
) -> Tuple[List[int], List[int]]:
    """(block index, block shape); copies data when out_addr != 0."""
    it = it_cell.obj
    bi, blk = it.blocks[it.pos]
    it.pos += 1
    blk = np.asarray(blk, dtype=_DTYPES[typ])
    if out_addr:
        _buf(typ, out_addr, blk.size)[:] = blk.reshape(-1)
    return ([int(x) for x in bi], list(blk.shape))


def t_iterator_stop(it_cell: Cell) -> None:
    it_cell.obj = None


# --- tensor info -----------------------------------------------------------

def t_ndims(cell: Cell) -> int:
    return _tensor(cell).ndim


def t_dims(cell: Cell) -> List[int]:
    return [int(x) for x in _tensor(cell).shape]


def t_nblks_total(cell: Cell, dim: int) -> int:
    return int(_tensor(cell).nblk_per_dim[dim])


def t_nblks_local(cell: Cell, dim: int) -> int:
    return int(_tensor(cell).nblk_per_dim[dim])


def t_max_nblks_local(cell: Cell) -> int:
    return int(max(_tensor(cell).nblk_per_dim))


def t_get_num_blocks(cell: Cell) -> int:
    return int(_tensor(cell).nblks)


def t_get_num_blocks_total(cell: Cell) -> int:
    return int(_tensor(cell).nblks)


def t_get_nze(cell: Cell) -> int:
    return int(_tensor(cell).matrix.index.nelems)


def t_get_nze_total(cell: Cell) -> int:
    return int(_tensor(cell).matrix.index.nelems)


def t_get_stored_coordinates(cell: Cell, ndim: int, index_addr: int) -> int:
    t = _tensor(cell)
    m = t.matrix
    if m.dist is None:
        return 0
    bi = tuple(int(x) for x in _i32buf(index_addr, ndim))
    rows, cols = t.mapping.fold(
        np.asarray([bi], dtype=np.int64),
        np.asarray([len(b) for b in t.block_sizes], dtype=np.int64),
    )
    v = _io.get_stored_coordinates(m, int(rows[0]), int(cols[0]))
    return -1 if v is None else int(v)


def t_get_mapping_info(cell: Cell) -> Tuple[List[int], List[int]]:
    mp = _tensor(cell).mapping
    return (list(mp.map1), list(mp.map2))


def t_ndims_matrix_row(cell: Cell) -> int:
    return len(_tensor(cell).mapping.map1)


def t_ndims_matrix_column(cell: Cell) -> int:
    return len(_tensor(cell).mapping.map2)


def t_get_nd_index(cell: Cell) -> List[int]:
    return [int(x) for x in _tensor(cell).shape]


def t_get_nd_index_blk(cell: Cell) -> List[int]:
    return [int(x) for x in _tensor(cell).nblk_per_dim]


def t_split_blocks(cell: Cell, ndim: int, factors_addr: int) -> None:
    t = _tensor(cell)
    facs = _i32buf(factors_addr, ndim)
    new_sizes = []
    for d in range(ndim):
        f = max(int(facs[d]), 1)
        out = []
        for s in t.block_sizes[d]:
            s = int(s)
            base = s // f
            rests = s - base * f
            parts = [base + (1 if i < rests else 0) for i in range(f)]
            out.extend(p for p in parts if p > 0)
        new_sizes.append(np.asarray(out, dtype=np.int32))
    cell.obj = split_blocks(t, new_sizes)


def t_batched_contract_init(cell: Cell) -> Cell:
    del cell
    return Cell(BatchedContract())


def t_batched_contract_finalize(state_cell: Cell) -> None:
    if state_cell.obj is not None:
        state_cell.obj.finalize()
        state_cell.obj = None


def t_get_info(cell: Cell) -> Tuple[int, List[int], List[int], int]:
    t = _tensor(cell)
    return (
        t.ndim,
        [int(x) for x in t.shape],
        [int(x) for x in t.nblk_per_dim],
        _CONST_OF_DTYPE[t.dtype],
    )


def t_get_data_p(cell: Cell, typ: str, out_addr: int, n: int) -> int:
    flat = _refresh_mirror(cell, _tensor(cell).matrix.flat_host().astype(_DTYPES[typ]))
    if out_addr:
        k = min(n, flat.size)
        _buf(typ, out_addr, k)[:] = flat[:k]
    return int(flat.size)
