"""The complex stack product: KC1 (complex64) and KC2 (complex128), with
their plain version.

On the TPU the JAX package has no complex unit: ``ops/complex_emu.py``
(``emu_multiply``) splits each complex operand into real and imaginary
planes and makes four real products that share one plan, through K1/K2
for complex64 parts and K6 for complex128 parts, then adds them; on the CPU
it multiplies complex natively through its XLA stack
(``dbcsr_tpu/mm/engine.py``, ``use_pallas`` is false there). The H100
holds complex natively, so the port computes the same stack product
``C[c] = Σ A[a]·B[b]`` with fused complex kernels that read each
interleaved A and B tile once:

- ``tile_stack_matmul_c64`` / ``tile_stack_matmul_c128`` are the wrappers
  of the hand-written kernels in ``csrc/stack_matmul_c64.cu`` (KC1: FFMA,
  ``csrc/tile_product_c64.cuh``) and ``csrc/stack_matmul_c128.cu`` (KC2:
  FP64 tensor cores, ``csrc/tile_mma_c128.cuh``), each counting its
  launches; ``tile_stack_matmul_c`` picks one by dtype. Each takes the
  same ``DeviceStack`` as K1, every tile edge in ``KERNEL_TILES`` and runs
  of any length. CPU tensors
  run the plain version; CUDA tensors launch the kernel or raise. The
  kernels read raw memory, so a tensor carrying torch's lazy conjugation
  bit is resolved first (its pointer would give the unconjugated values),
  and the pointers are those of ``torch.view_as_real``.
- ``tile_stack_matmul_c_plain`` is gather + complex ``bmm`` + the ordered
  run sums of K1's plain version, summed in the stores' own complex type.

The route: ``engine._select_route`` sends every complex sparse stack
product here, whatever the sparse driver, as the JAX package's native
complex always takes its flat stack; its route name is ``"c_stack"``. The
dense class stays a complex ``torch.mm``.
"""
from __future__ import annotations

import torch

from .kernels import DeviceStack, _check_stores, check_cuda_operands, run_sums_plain

__all__ = [
    "COMPLEX_DTYPES", "tile_stack_matmul_c", "tile_stack_matmul_c64",
    "tile_stack_matmul_c128", "tile_stack_matmul_c_plain",
]

#: the complex store types, each with its kernel's C entry point
COMPLEX_DTYPES = {
    torch.complex64: "dbcsr_torch_stack_matmul_c64",
    torch.complex128: "dbcsr_torch_stack_matmul_c128",
}


def tile_stack_matmul_c_plain(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """Plain PyTorch version of KC1/KC2 (any device): the same sums in the
    same order of runs, in the stores' complex type; the kernels differ
    only in the order of each tile product's own k-sum."""
    _check_stores(a, b, "tile_stack_matmul_c_plain")
    if a.dtype not in COMPLEX_DTYPES:
        raise TypeError(f"tile_stack_matmul_c_plain: needs a complex dtype, got {a.dtype}")
    return run_sums_plain(
        a, b, stack.c_ptr_host, stack.a_idx.to(a.device).long(),
        stack.b_idx.to(a.device).long(), a.dtype,
    )


def _launch(a: torch.Tensor, b: torch.Tensor, stack: DeviceStack, dtype,
            what: str) -> torch.Tensor:
    """Checks and one launch of the kernel for ``dtype`` on CUDA stores."""
    # the kernels read raw memory: materialise a pending conjugation
    a, b = a.resolve_conj(), b.resolve_conj()
    tile = check_cuda_operands(
        a, b, (stack.c_ptr, stack.a_idx, stack.b_idx), what, (dtype,)
    )
    if stack.a_end > a.shape[0] or stack.b_end > b.shape[0]:
        raise IndexError(f"{what}: stack slot beyond the tile stores")
    from .._build import check_launch, kernels

    out = torch.empty((stack.n_c, tile, tile), dtype=dtype, device=a.device)
    if stack.n_c:
        lib = kernels()
        rc = getattr(lib, COMPLEX_DTYPES[dtype])(
            torch.view_as_real(a).data_ptr(), torch.view_as_real(b).data_ptr(),
            torch.view_as_real(out).data_ptr(), stack.c_ptr.data_ptr(),
            stack.a_idx.data_ptr(), stack.b_idx.data_ptr(), stack.n_c, tile,
            a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
        )
        check_launch(lib, rc, what)
    return out


def tile_stack_matmul_c64(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """KC1: ``[n_c, T, T]`` complex64 tile store of the stack product. CPU
    tensors run the plain version; CUDA tensors launch the kernel, or raise
    on another dtype (TypeError), a tile edge outside ``KERNEL_TILES``,
    non-contiguous or misaligned stores, plan arrays elsewhere (ValueError)
    or stack slots beyond the stores (IndexError)."""
    if a.device.type == "cpu":
        return tile_stack_matmul_c_plain(a, b, stack)
    out = _launch(a, b, stack, torch.complex64, "tile_stack_matmul_c64")
    if stack.n_c:
        tile_stack_matmul_c64.launches += 1
    return out


def tile_stack_matmul_c128(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """KC2: ``[n_c, T, T]`` complex128 tile store of the stack product, as
    ``tile_stack_matmul_c64`` for complex64."""
    if a.device.type == "cpu":
        return tile_stack_matmul_c_plain(a, b, stack)
    out = _launch(a, b, stack, torch.complex128, "tile_stack_matmul_c128")
    if stack.n_c:
        tile_stack_matmul_c128.launches += 1
    return out


#: launches of KC1 / KC2 since the last reset (set them to 0 to reset)
tile_stack_matmul_c64.launches = 0
tile_stack_matmul_c128.launches = 0


def tile_stack_matmul_c(
    a: torch.Tensor, b: torch.Tensor, stack: DeviceStack,
) -> torch.Tensor:
    """The complex stack product in the stores' type: KC1 for complex64,
    KC2 for complex128 (CPU tensors: the plain version)."""
    if a.dtype == torch.complex128:
        return tile_stack_matmul_c128(a, b, stack)
    if a.dtype == torch.complex64:
        return tile_stack_matmul_c64(a, b, stack)
    raise TypeError(f"tile_stack_matmul_c: needs a complex dtype, got {a.dtype}")
