// KC2, the complex128 flat stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @
// B[b_idx[e]] with complex128 tiles, complex128 products and sums.
//
// Replaces what the TPU runs for complex128: dbcsr_tpu/ops/complex_emu.py
// (emu_multiply, :177-258) splits each operand into real and imaginary
// float64 planes and makes four real products sharing one plan through the
// TPU kernel dbcsr_tpu/mm/ozaki_panel.py:_ozaki_panel_kernel (K6, float64 as
// bf16 slices), then adds them. The H100 computes float64 natively and holds
// complex128, so this kernel computes the same stack product fused: each A
// and B tile is read once, interleaved, and the four real products of a k
// step are issued from the same fragments. It reads the same c-sorted stack
// as K1 and the float64 stack kernel (StackJob of tile_kernel.cuh); the
// blocks of a C tile walk its run in stack order and write their rows once,
// no atomics, two launches bitwise equal.
//
// What bounds it on an H100: a complex entry does 8·T³ real flops on 2·T²
// complex128 inputs, at T = 128 32 flop/byte, above the FP64 tensor cores'
// ridge, so operations at the FP64 tensor-core rate (67 TFLOP/s). T = 128
// and T = 64 run tile_mma_c128.cuh (mma.sync m16n8k8 f64, four real mma a
// complex k step in a fixed order, a block on 64 rows of the C tile; the
// header has the fragment mapping), T = 16 and T = 32 tile_run's complex128
// instantiation (tile_product.cuh, DFMA).
#include "tile_kernel.cuh"

namespace dbcsr_torch {

// the flat stack of K1 over complex128 tiles; its own name, so that the
// ptxas report says whose instantiations these are
struct C128StackJob : StackJob {};

}  // namespace dbcsr_torch

extern "C" int dbcsr_torch_stack_matmul_c128(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, long long n_c, int tile,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const C128StackJob job{{static_cast<const int*>(c_ptr), static_cast<const int*>(a_idx),
                            static_cast<const int*>(b_idx)}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_tile<double2>(tile, [&](auto, auto tile_tag) {
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<double2, T>(
            static_cast<const double2*>(a), static_cast<const double2*>(b),
            static_cast<double2*>(c), n_c, job, s);
    });
}
