"""The float64 stack product: the port of K6, with its plain version.

Counterparts in the JAX package: the fused Ozaki panel kernel
``dbcsr_tpu/mm/ozaki_panel.py`` (``_ozaki_panel_kernel``, K6) and its XLA
twin ``dbcsr_tpu/ops/f64_emu.py:194`` (``tile_stack_matmul_ozaki``). Both
emulate float64 with bf16 slices because the TPU has no float64 unit; the
H100 has one, so the port computes the same stack product
``C[c] = Σ A[a]·B[b]`` in native float64.

- ``tile_stack_matmul_f64`` is the wrapper of the hand-written kernel in
  ``csrc/stack_matmul_f64.cu``: it takes the same ``DeviceStack`` as K1
  (``kernels.py``), every tile edge in ``KERNEL_TILES`` and runs of any
  length (K6 admits only T = 128 and at most 8 entries per C tile). CPU
  tensors run the plain version; CUDA tensors launch the kernel or raise.
- ``tile_stack_matmul_f64_plain`` is gather + float64 ``bmm`` + the ordered
  run sums of K1's plain version.

The route: ``engine._select_route`` sends every float64 sparse stack
product here, whatever the sparse driver ("auto", "stack" or "panel"), as
the JAX package never gives float64 to its f32 panel or flat kernels. Only
the dense class stays a plain float64 ``torch.mm``. ``f64_method`` selects
between the JAX package's emulations and has nothing to select here;
``f64_slices`` raises (``engine._check_config``).
"""
from __future__ import annotations

import torch

from .kernels import DeviceStack, _check_stores, check_cuda_operands, run_sums_plain

__all__ = ["tile_stack_matmul_f64", "tile_stack_matmul_f64_plain"]


def tile_stack_matmul_f64_plain(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """Plain PyTorch version of the float64 stack kernel (any device): the
    same sums in the same order of runs; the kernel differs only in the
    order of each tile product's own k-sum."""
    _check_stores(a, b, "tile_stack_matmul_f64_plain")
    if a.dtype != torch.float64:
        raise TypeError(f"tile_stack_matmul_f64_plain: needs float64, got {a.dtype}")
    return run_sums_plain(
        a, b, stack.c_ptr_host, stack.a_idx.to(a.device).long(),
        stack.b_idx.to(a.device).long(), torch.float64,
    )


def tile_stack_matmul_f64(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """``[n_c, T, T]`` float64 tile store of the stack product. CPU tensors
    run the plain version; CUDA tensors launch the kernel, or raise on
    another dtype (TypeError), a tile edge outside ``KERNEL_TILES``,
    non-contiguous stores, plan arrays elsewhere (ValueError) or stack
    slots beyond the stores (IndexError)."""
    what = "tile_stack_matmul_f64"
    if a.device.type == "cpu":
        return tile_stack_matmul_f64_plain(a, b, stack)
    tile = check_cuda_operands(
        a, b, (stack.c_ptr, stack.a_idx, stack.b_idx), what, (torch.float64,)
    )
    if stack.a_end > a.shape[0] or stack.b_end > b.shape[0]:
        raise IndexError(f"{what}: stack slot beyond the tile stores")
    from .._build import check_launch, kernels

    out = torch.empty((stack.n_c, tile, tile), dtype=torch.float64, device=a.device)
    if stack.n_c:
        lib = kernels()
        rc = lib.dbcsr_torch_stack_matmul_f64(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), stack.c_ptr.data_ptr(),
            stack.a_idx.data_ptr(), stack.b_idx.data_ptr(), stack.n_c, tile,
            a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, what)
        tile_stack_matmul_f64.launches += 1
    return out


#: launches of the float64 stack kernel since the last reset (set it to 0
#: to reset)
tile_stack_matmul_f64.launches = 0
