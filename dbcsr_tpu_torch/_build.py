"""Builds the port's native code at first use and loads it with ctypes.

The CUDA kernels in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds): one ``nvcc -c`` per source, all started together,
then one link. Nothing prebuilt ships with the package: the library
is built from the sources on first use into ``_build/`` inside the package
(git-ignored), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. A missing ``nvcc`` or a
failed build raises; there is no other route to the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "BUILD_DIR", "build_dir", "BuildInfo", "build_kernels", "kernels",
    "check_launch",
]

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
_CSRC = os.path.join(_PKG, "csrc")


def _csrc_files(suffix: str) -> tuple:
    return tuple(sorted(f for f in os.listdir(_CSRC) if f.endswith(suffix)))


#: every translation unit and every header under ``csrc/``, from the
#: directory itself: a file that is there is compiled (or hashed), so a new
#: header cannot be left out of the library's name
_SOURCES = _csrc_files(".cu")
_HEADERS = _csrc_files(".cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


@dataclass(frozen=True)
class BuildInfo:
    path: str  # the shared library
    seconds: float  # nvcc wall time (0.0 when the library was already built)
    log: str  # compiler output (register/shared-memory report when verbose)


def build_dir() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "dbcsr_tpu_torch/csrc at first use"
    )


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _HEADERS + _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return os.path.join(build_dir(), f"libdbcsr_torch_{h.hexdigest()[:12]}.so")


def build_kernels(*, verbose: bool = False) -> BuildInfo:
    """Compile the kernels unless the library for these sources exists.
    ``verbose`` adds ptxas's per-kernel register and shared-memory report
    to the log (and forces a rebuild so there is one)."""
    so = _library_path()
    if os.path.exists(so) and not verbose:
        return BuildInfo(path=so, seconds=0.0, log="")
    nvcc = _nvcc()
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.splitext(src)[0]}.o" for src in _SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", os.path.join(_CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_SOURCES, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"[{src}]\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(
                f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(logs)
            )
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)
    return BuildInfo(path=so, seconds=time.perf_counter() - t0, log="\n".join(logs))


def kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_kernels().path)
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.dbcsr_torch_stack_matmul.restype = i32
            # (a, b, c, c_ptr, a_idx, b_idx, n_c, tile, dtype, device, stream)
            lib.dbcsr_torch_stack_matmul.argtypes = [
                vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp,
            ]
            lib.dbcsr_torch_stack_matmul_f64.restype = i32
            # (a, b, c, c_ptr, a_idx, b_idx, a_chunks, b_chunks, seg_ptr,
            #  seg_out, ws, n_c, n_seg, tile, device, stream); the chunk masks
            #  and the segment table may be null
            lib.dbcsr_torch_stack_matmul_f64.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, vp,
            ]
            # its fix-up: (c, ws, red_c, red_ptr, n_split, tile, device, stream)
            lib.dbcsr_torch_segment_sum_f64.restype = i32
            lib.dbcsr_torch_segment_sum_f64.argtypes = [vp, vp, vp, vp, i64, i32, i32, vp]
            # KC1 and KC2, the complex64 / complex128 flat stack kernels:
            # (a, b, c, c_ptr, a_idx, b_idx, n_c, tile, device, stream)
            for fn in (lib.dbcsr_torch_stack_matmul_c64, lib.dbcsr_torch_stack_matmul_c128):
                fn.restype = i32
                fn.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32, i32, vp]
            lib.dbcsr_torch_panel_matmul.restype = i32
            # (a, b, c, gstart, a_lo, b_lo, obounds, entries, n_slots, c_win,
            #  tile, dtype, device, stream)
            lib.dbcsr_torch_panel_matmul.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, vp,
            ]
            lib.dbcsr_torch_band_matmul.restype = i32
            # (a, b, c, a_pack, b_pack, c_unpack, n_c, wa, wb, mt, kt, off_a,
            #  tile, dtype, device, stream)
            lib.dbcsr_torch_band_matmul.argtypes = [
                vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32,
                i32, i32, vp,
            ]
            lib.dbcsr_torch_grouped_matmul.restype = i32
            # (a, b, c, lbounds, abounds, aload, entries, out_slot, n_rows,
            #  group, tile, dtype, device, stream)
            lib.dbcsr_torch_grouped_matmul.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, vp,
            ]
            lib.dbcsr_torch_panel_runs_matmul.restype = i32
            # (a, b, c, gstart, a_lo, b_lo, obq, qent, obp, pent, obs, sent,
            #  cm_perm, n_cells, c_win, runlen, tile, dtype, device, stream)
            lib.dbcsr_torch_panel_runs_matmul.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i32,
                i32, i32, i32, i32, vp,
            ]
            # the eps filter's passes (block_filter.cu); dtype: a code of
            # block/tileops.py's FILTER_DTYPES
            lib.dbcsr_torch_block_sumsq.restype = i32
            # (store, z, rows, cols, rseg, cseg, bid_p1, n_tiles, amax, bmax,
            #  tile, dtype, device, stream)
            lib.dbcsr_torch_block_sumsq.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, vp,
            ]
            lib.dbcsr_torch_keep_blocks.restype = i32
            # (store, nsq, keep, rows, cols, rseg, cseg, bid_p1, n_tiles,
            #  n_blocks, amax, bmax, thr, tile, dtype, device, stream)
            lib.dbcsr_torch_keep_blocks.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, ctypes.c_float,
                i32, i32, i32, vp,
            ]
            # the tensor refold (block_refold.cu)
            lib.dbcsr_torch_block_refold.restype = i32
            # (src, dst, meta, dims, src_lut, dst_lut, src_ntc, dst_ntc,
            #  n_blocks, old_nrow, new_nrow, old_packed, new_packed, tshift,
            #  elem_bytes, device, stream)
            lib.dbcsr_torch_block_refold.argtypes = [
                vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32, vp,
            ]
            lib.dbcsr_torch_error_string.restype = ctypes.c_char_p
            lib.dbcsr_torch_error_string.argtypes = [i32]
            _LIB = lib
        return _LIB


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after the launch)."""
    if code != 0:
        msg = lib.dbcsr_torch_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
