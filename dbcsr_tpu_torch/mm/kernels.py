"""K1, the flat tile-stack kernel: wrapper, plain version and CUDA binding.

``tile_stack_matmul`` computes ``C[c] = Σ A[a]·B[b]`` over a stack of
(c, a, b) tile triples sorted by c — the port of
``dbcsr_tpu/mm/kernels.py:tile_stack_matmul_pallas``. For CUDA tensors it
launches the hand-written kernel in ``csrc/stack_matmul.cu`` (one block per
C sub-tile walking that tile's run of entries in stack order; f32
accumulation; each C tile written once, no atomics) or raises. For CPU
tensors, and only for them, it runs the plain version
``tile_stack_matmul_plain``: ``index_select`` + ``bmm`` + a sorted-segment
reduction that adds each run's products in stack order.

Precision is fixed by the input dtype, never by ambient torch state:
float32 inputs are multiplied in IEEE float32 (the kernel runs FFMA; the
plain version turns TF32 off around its ``bmm``); bfloat16 inputs are
widened to float32 first, so every product is exact and only the float32
sums round. float64 stacks take their own kernel (``f64_stack.py``); the
plain version here sums float64 in float64.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

__all__ = [
    "KERNEL_TILES",
    "DeviceStack",
    "device_stack",
    "tf32_matmul",
    "tile_stack_matmul",
    "tile_stack_matmul_plain",
]

#: tile edges the CUDA kernels are instantiated for
KERNEL_TILES = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: stack entries gathered per step of the plain version (bounds its scratch:
#: 3 · 8192 · T² floats, 1.6 GB at T=128)
PLAIN_CHUNK = 8192


@contextmanager
def tf32_matmul(enabled: bool) -> Iterator[None]:
    """Pin torch's float32 matmul precision for the enclosed calls (TF32 on
    or off), restoring the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@dataclass(frozen=True)
class DeviceStack:
    """A c-sorted stack as the flat kernel reads it, resident on one
    device: run offsets ``c_ptr`` (C tile c owns entries
    ``[c_ptr[c], c_ptr[c+1])``) and the a/b columns. Built once per plan
    (``device_stack``) and reused by every call."""

    n_c: int
    c_ptr: torch.Tensor  # int32 [n_c+1]
    a_idx: torch.Tensor  # int32 [S]
    b_idx: torch.Tensor  # int32 [S]
    c_ptr_host: np.ndarray  # int64 [n_c+1]
    a_end: int  # 1 + largest a slot (0 when empty): A must hold this many
    b_end: int


def device_stack(stack_np: np.ndarray, n_c_tiles: int, device) -> DeviceStack:
    """Upload a host stack (int32 [S, 3], sorted by c, every c in
    [0, n_c_tiles)) for the flat kernel; validates it on the host."""
    stack = np.asarray(stack_np).reshape(-1, 3)
    s = len(stack)
    if s >= 2**31:
        raise ValueError("stack too large for int32 entry offsets")
    c = stack[:, 0].astype(np.int64)
    if s and (c.min() < 0 or c.max() >= n_c_tiles or np.any(np.diff(c) < 0)):
        raise ValueError("stack c column must be sorted and lie in [0, n_c_tiles)")
    if s and (stack[:, 1:].min() < 0):
        raise ValueError("negative tile slot in stack")
    c_ptr = np.searchsorted(c, np.arange(n_c_tiles + 1)).astype(np.int64)

    def col(j):
        return torch.as_tensor(
            np.ascontiguousarray(stack[:, j], dtype=np.int32), device=device
        )

    return DeviceStack(
        n_c=int(n_c_tiles),
        c_ptr=torch.as_tensor(c_ptr.astype(np.int32), device=device),
        a_idx=col(1),
        b_idx=col(2),
        c_ptr_host=c_ptr,
        a_end=int(stack[:, 1].max()) + 1 if s else 0,
        b_end=int(stack[:, 2].max()) + 1 if s else 0,
    )


def _check_stores(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    if a.dim() != 3 or b.dim() != 3 or a.shape[1] != a.shape[2] or (
        b.shape[1:] != a.shape[1:]
    ):
        raise ValueError(
            f"{what}: tile stores must be [n, T, T] with one T, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: A is {a.dtype}, B is {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{what}: A on {a.device}, B on {b.device}")
    return int(a.shape[1])


def check_cuda_operands(a, b, index_tensors, what: str, dtypes) -> int:
    """Checks shared by the CUDA wrappers: device, dtype (one of
    ``dtypes``), tile edge and contiguity of the stores and the plan
    arrays; returns the tile edge."""
    tile = _check_stores(a, b, what)
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    if a.dtype not in dtypes:
        hint = " (float64 stacks take mm/f64_stack.py)" if a.dtype == torch.float64 else ""
        raise TypeError(f"{what}: no kernel for dtype {a.dtype}{hint}")
    if tile not in KERNEL_TILES:
        raise ValueError(f"{what}: tile edge {tile} not in {KERNEL_TILES}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: tile stores must be contiguous")
    for t in index_tensors:
        if t.device != a.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{what}: plan arrays must be contiguous int32 on {a.device}"
            )
    return tile


def check_kernel_operands(a, b, index_tensors, out_dtype, what: str) -> int:
    """``check_cuda_operands`` for K1/K2 (float32 or bfloat16 inputs, float32
    or bfloat16 output); returns the kernel's dtype code."""
    check_cuda_operands(a, b, index_tensors, what, _DTYPE_CODE)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: output dtype {out_dtype} not supported")
    return _DTYPE_CODE[a.dtype]


def run_sums_plain(
    a: torch.Tensor, b: torch.Tensor, c_ptr: np.ndarray,
    a_idx: torch.Tensor, b_idx: torch.Tensor, out_dtype,
) -> torch.Tensor:
    """``out[c] = Σ_{e in [c_ptr[c], c_ptr[c+1])} a[a_idx[e]] @ b[b_idx[e]]``
    with each run summed left to right in stack order: ``index_select`` +
    ``bmm``, then for j = 0, 1, ... the j-th product of every run of length
    > j is added to its C tile. Destinations within one step are distinct,
    so the reduction is deterministic (no ``index_add_``). Entries are
    gathered ``PLAIN_CHUNK`` at a time, at C-run boundaries."""
    tile = a.shape[1]
    n_c = len(c_ptr) - 1
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    out = torch.zeros((n_c, tile, tile), dtype=acc, device=a.device)
    run_len = np.diff(c_ptr)
    c0 = 0
    with tf32_matmul(False):
        while c0 < n_c:
            c1 = int(np.searchsorted(c_ptr, c_ptr[c0] + PLAIN_CHUNK, side="right")) - 1
            c1 = min(max(c1, c0 + 1), n_c)
            e0, e1 = int(c_ptr[c0]), int(c_ptr[c1])
            if e1 > e0:
                prods = torch.bmm(
                    a.index_select(0, a_idx[e0:e1]).to(acc),
                    b.index_select(0, b_idx[e0:e1]).to(acc),
                )
                lens = run_len[c0:c1]
                starts = c_ptr[c0:c1] - e0
                for j in range(int(lens.max())):
                    cs = np.flatnonzero(lens > j)
                    dst = torch.as_tensor(c0 + cs, device=a.device)
                    src = torch.as_tensor(starts[cs] + j, device=a.device)
                    out[dst] += prods.index_select(0, src)
            c0 = c1
    return out.to(out_dtype)


def tile_stack_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack, *, out_dtype=None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): same sums, same order of
    runs; the kernel differs only in the order of each tile product's own
    k-sum."""
    _check_stores(a, b, "tile_stack_matmul_plain")
    return run_sums_plain(
        a, b, stack.c_ptr_host, stack.a_idx.to(a.device).long(),
        stack.b_idx.to(a.device).long(), out_dtype or a.dtype,
    )


def tile_stack_matmul(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack, *, out_dtype=None,
) -> torch.Tensor:
    """K1: ``[n_c, T, T]`` tile store of the stack product. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise (dtypes other
    than float32/bfloat16 — float64 has ``f64_stack.tile_stack_matmul_f64``
    — tile edges outside ``KERNEL_TILES``, non-contiguous stores:
    TypeError/ValueError)."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return tile_stack_matmul_plain(a, b, stack, out_dtype=out_dtype)
    code = check_kernel_operands(
        a, b, (stack.c_ptr, stack.a_idx, stack.b_idx), out_dtype,
        "tile_stack_matmul",
    )
    if stack.a_end > a.shape[0] or stack.b_end > b.shape[0]:
        raise IndexError("tile_stack_matmul: stack slot beyond the tile stores")
    from .._build import check_launch, kernels

    tile = a.shape[1]
    out = torch.empty((stack.n_c, tile, tile), dtype=torch.float32, device=a.device)
    if stack.n_c:
        lib = kernels()
        rc = lib.dbcsr_torch_stack_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), stack.c_ptr.data_ptr(),
            stack.a_idx.data_ptr(), stack.b_idx.data_ptr(), stack.n_c, tile,
            code, a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, "tile_stack_matmul")
        tile_stack_matmul.launches += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


#: launches of the K1 kernel since the last reset (set it to 0 to reset)
tile_stack_matmul.launches = 0
