// K1, the flat stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @ B[b_idx[e]].
//
// Replaces the TPU kernel dbcsr_tpu/mm/kernels.py:_stack_kernel (launched by
// _pallas_launch / tile_stack_matmul_pallas). The TPU walks the c-sorted
// stack as a sequential grid that revisits each output window, pads C runs to
// e_batch and chunks launches at max_chunk; none of that carries over. Here
// the host passes the run offsets c_ptr[n_c+1] (a searchsorted over the
// sorted c column, once per plan) and the a/b columns (StackJob of
// tile_kernel.cuh), and one block of 256 threads per C tile walks its run
// [c_ptr[c], c_ptr[c+1]) in stack order and writes the tile once: no atomics,
// two launches bitwise equal.
//
// What bounds it on an H100: each stack entry reads one A and one B tile and
// does 2·T³ flops — at T=128 in f32, 128 KB for 4.2 MFLOP, 32 flop/byte even
// when both tiles come from HBM, above the ~20 flop/byte ridge of FFMA
// (67 TFLOP/s over 3.35 TB/s); bf16 inputs halve the bytes. So the kernel is
// bound by operations at the IEEE FFMA rate (float32 at "highest" has no
// tensor-core route, and bf16 inputs are widened to float32 so that every
// product is exact). Neighbouring C tiles of a banded stack share A and B
// tiles, which the 50 MB L2 serves; on a pattern without locality (a
// scrambled numbering) every entry's tiles come from HBM, still above the
// ridge.
//
// T = 128 and T = 64, float32 and bf16, run the register-blocked, pipelined
// routine of tile_product_f32.cuh, the one K2 (panel_matmul.cu) runs: an 8×8
// (T = 64: 4×4) micro-tile a thread read with 128-bit shared-memory loads, K
// chunks of 32 brought by cp.async into a three-slot ring of dynamic shared
// memory that runs across the entries of the run (104,448 bytes in float32
// at T = 128, 55,296 in bf16), two blocks an SM. One block owns the whole C
// tile, so each A and B tile of the run is read once. T = 16 and T = 32 keep
// tile_run of tile_product.cuh. Either way every C element is one FFMA chain
// over the run in stack order and ascending k, so K1 and K2 agree bitwise on
// the same stack, as do K1 and any other kernel on a stack that lists the
// same products in the same order. What is left on the table is the
// routine's: its inner loop keeps the shared-memory pipe as busy as the FFMA
// pipe (tile_product_f32.cuh says why).
#include "tile_kernel.cuh"

extern "C" int dbcsr_torch_stack_matmul(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, long long n_c, int tile, int dtype,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const StackJob job{static_cast<const int*>(c_ptr), static_cast<const int*>(a_idx),
                       static_cast<const int*>(b_idx)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<false>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<In, T>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<float*>(c), n_c, job, s);
    });
}

extern "C" const char* dbcsr_torch_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
