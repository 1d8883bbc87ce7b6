"""Python side of the legacy C API surface (see ``capi.c`` / ``dbcsr_tpu.h``).

Port of ``dbcsr_tpu/capi/helpers.py``: the C layer passes raw buffer
ADDRESSES (int64) plus shapes; this module marshals them to and from numpy
and calls ``dbcsr_tpu_torch`` on the shim's device (``himpl.device()``, set
by ``c_dbcsr_init_lib`` from ``DBCSR_CAPI_DEVICE``). The analog of the
reference's ``src/dbcsr_api_c.F`` glue, with ctypes standing in for
ISO_C_BINDING.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..block.bcsr import BCSRBuilder
from ..mm.engine import multiply as _multiply
from ..ops import arithmetic as _ar
from ..ops import io as _io
from ..ops import norms as _norms
from ..ops import transform as _tr
from . import himpl
from .himpl import Cell, _mat


def _i32(addr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_int32 * n).from_address(addr)
    return np.frombuffer(buf, dtype=np.int32).copy()


def _f64(addr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_double * n).from_address(addr)
    return np.frombuffer(buf, dtype=np.float64)


def init_lib():
    """``c_dbcsr_init_lib``: pick the device (raises without it) and
    initialize the library."""
    himpl.init_lib(0, 0)


def finalize_lib():
    himpl.finalize_lib()


def create(name: str, rs_addr: int, nbr: int, cs_addr: int, nbc: int):
    return Cell(BCSRBuilder(
        _i32(rs_addr, nbr), _i32(cs_addr, nbc), name=name, dtype=np.float64,
        device=himpl.device(),
    ))


def put_block(builder, row: int, col: int, addr: int, m: int, n: int,
              sum: int):
    builder.obj.put_block(
        row, col, _f64(addr, m * n).reshape(m, n).copy(), sum=bool(sum)
    )


def reserve_diag_blocks(builder):
    builder.obj.reserve_diag_blocks()


def finalize(builder):
    return Cell(builder.obj.finalize())


def get_block(matrix, row: int, col: int, out_addr: int):
    blk = _mat(matrix).get_block(row, col)
    if blk is None:
        return (0, 0, 0)
    blk = np.asarray(blk, dtype=np.float64)
    if out_addr:
        _f64(out_addr, blk.size)[:] = blk.reshape(-1)
    return (1, blk.shape[0], blk.shape[1])


def get_nblks(matrix) -> int:
    return int(_mat(matrix).nblks)


def get_occupation(matrix) -> float:
    return float(_mat(matrix).occupation())


def multiply(transa: str, transb: str, alpha: float, a, b, beta: float,
             c, filter_eps: float, retain_sparsity: int):
    return Cell(_multiply(
        transa, transb, alpha, _mat(a), _mat(b), beta,
        None if c is None else _mat(c),
        filter_eps=None if filter_eps < 0 else filter_eps,
        retain_sparsity=bool(retain_sparsity),
    ))


def add(alpha: float, a, beta: float, b):
    return Cell(_ar.add(alpha, _mat(a), beta, _mat(b)))


def scale(a, alpha: float):
    return Cell(_ar.scale(_mat(a), alpha))


def filter_blocks(a, eps: float):
    return Cell(_ar.filter_blocks(_mat(a), eps))


def transpose(a):
    return Cell(_tr.transpose(_mat(a)))


def trace(a) -> float:
    return float(_ar.trace(_mat(a)))


def dot(a, b) -> float:
    return float(_ar.dot(_mat(a), _mat(b)))


def norm_frobenius(a) -> float:
    return float(_norms.norm_frobenius(_mat(a)))


def maxabs(a) -> float:
    return float(_norms.norm_maxabs(_mat(a)))


def checksum(a) -> float:
    return float(_io.checksum(_mat(a)))


def binary_write(a, path: str):
    _io.binary_write(_mat(a), path)


def binary_read(path: str):
    return Cell(_io.binary_read(path, device=himpl.device()))
