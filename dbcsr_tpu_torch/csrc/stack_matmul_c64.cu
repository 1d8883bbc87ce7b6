// KC1, the complex64 flat stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @
// B[b_idx[e]] with complex64 tiles, complex64 products and complex64 sums.
//
// Replaces what the TPU runs for complex64: dbcsr_tpu/ops/complex_emu.py
// (emu_multiply, :177-258) splits each operand into real and imaginary
// float32 planes and makes four real products sharing one plan through the
// TPU kernel dbcsr_tpu/mm/kernels.py:_stack_kernel (K1) or the panel kernel
// (K2), then adds them. The H100 holds complex64 natively, so this kernel
// computes the same stack product fused: each A and B tile is read once, as
// the interleaved (re, im) store torch keeps, with no split planes, no four
// launches and no combining adds. It reads the same c-sorted stack as K1
// (run offsets c_ptr[n_c+1], a/b columns; StackJob of tile_kernel.cuh): one
// block per C tile walks its run in stack order and writes it once, no
// atomics, two launches bitwise equal.
//
// What bounds it on an H100: a complex entry does 8·T³ real flops on 2·T²
// complex inputs, at T = 128 64 flop/byte, so operations at the FFMA rate
// (67 TFLOP/s). T = 128 and T = 64 run the blocked routine of
// tile_product_c64.cuh (an 8×8 complex micro-tile a thread at T = 128, a
// four-slot cp.async ring across the run; the header has the design and the
// fixed order of the four fused multiply-adds of a complex step), T = 16
// and T = 32 tile_run's complex64 instantiation (tile_product.cuh).
#include "tile_kernel.cuh"

namespace dbcsr_torch {

// the flat stack of K1 over complex64 tiles; its own name, so that the
// ptxas report says whose instantiations these are
struct C64StackJob : StackJob {};

}  // namespace dbcsr_torch

extern "C" int dbcsr_torch_stack_matmul_c64(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, long long n_c, int tile,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const C64StackJob job{{static_cast<const int*>(c_ptr), static_cast<const int*>(a_idx),
                           static_cast<const int*>(b_idx)}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_tile<float2>(tile, [&](auto, auto tile_tag) {
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<float2, T>(
            static_cast<const float2*>(a), static_cast<const float2*>(b),
            static_cast<float2*>(c), n_c, job, s);
    });
}
