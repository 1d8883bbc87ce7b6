// The float64 stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @ B[b_idx[e]]
// with float64 inputs, float64 products and float64 sums (IEEE DFMA).
//
// Replaces the TPU kernel dbcsr_tpu/mm/ozaki_panel.py:_ozaki_panel_kernel
// (launched by _ozaki_panel_launch / tile_stack_matmul_ozaki_panel), and with
// it the XLA twin that the JAX package takes where that kernel is not
// admitted (dbcsr_tpu/ops/f64_emu.py:tile_stack_matmul_ozaki). The TPU has no
// float64 unit, so K6 cuts each operand into 8 bf16 slices of 7 bits, runs
// 36 slice-pair dots that are exact in f32 and folds them with a TwoSum
// cascade into three f32 planes; that scheme admits only T = 128 and at most
// 8 entries per C tile (the f32 exactness bound). The H100 computes float64
// natively, so none of the slicing carries over: this kernel reads the same
// c-sorted stack as K1 (run offsets c_ptr[n_c+1], a/b columns) and one block
// per (C tile, BM×BM sub-tile) walks its whole run in stack order through the
// shared routine in tile_product.cuh, instantiated for double. It takes every
// T in KERNEL_TILES and runs of any length. Each C element is summed by one
// thread in stack order and written once, with no atomics, so the result is
// bitwise deterministic.
//
// What bounds it on an H100: each stack entry reads one A and one B tile and
// does 2·T³ flops — at T=128 in f64, 256 KB for 4.2 MFLOP, 16 flop/byte
// from HBM (above the ~10 flop/byte ridge of DFMA, 34 TFLOP/s over
// 3.35 TB/s), and neighbouring C tiles of a banded stack share their tiles
// through the 50 MB L2. So it is compute-bound, and with this design the
// inner loop is bound by DFMA issue and the shared-memory reads feeding it:
// per k step a thread reads 4 + 4 doubles for 16 DFMAs (64×64 sub-tile,
// 256 threads, 4×4 micro-tile strided by 16, 16 double accumulators =
// 32 registers, 16.6 KB of shared memory per block). The K1/K2 design is
// kept so the three kernels share one routine; the f64 staging doubles the
// shared-memory bytes per k step, which is what a later kernel removes:
// FP64 tensor cores (mma.sync.aligned.m8n8k4.row.col.f64, 67 TFLOP/s dense)
// fed by cp.async/TMA double buffering.
#include "tile_product.cuh"

namespace dbcsr_torch {

template <int T>
__global__ void __launch_bounds__(kThreads)
stack_matmul_f64_kernel(const double* __restrict__ A, const double* __restrict__ B,
                        double* __restrict__ C, const int* __restrict__ c_ptr,
                        const int* __restrict__ a_idx, const int* __restrict__ b_idx)
{
    using S = SubTile<T>;
    constexpr int NS = T / S::BM;
    const int64_t c = blockIdx.x / S::kPerTile;
    const int sub = blockIdx.x % S::kPerTile;
    const int r0 = (sub / NS) * S::BM, c0 = (sub % NS) * S::BM;
    // 64-bit tile offset: c·T² crosses 2³¹ doubles past 131,072 tiles at T=128
    tile_run<double, T, S::BM>(
        A, B, C + c * (T * T), r0, c0, c_ptr[c], c_ptr[c + 1],
        [=](int e) { return make_int2(a_idx[e], b_idx[e]); });
}

}  // namespace dbcsr_torch

extern "C" int dbcsr_torch_stack_matmul_f64(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, long long n_c, int tile,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const double* A = static_cast<const double*>(a);
    const double* B = static_cast<const double*>(b);
    double* C = static_cast<double*>(c);
    const int* cp = static_cast<const int*>(c_ptr);
    const int* ai = static_cast<const int*>(a_idx);
    const int* bi = static_cast<const int*>(b_idx);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_tile<double>(tile, [&](auto, auto tile_tag) {
        constexpr int T = decltype(tile_tag)::value;
        const unsigned blocks = tile_grid<T>(n_c);
        if (!blocks) return (int)cudaErrorInvalidConfiguration;
        stack_matmul_f64_kernel<T><<<blocks, kThreads, 0, s>>>(A, B, C, cp, ai, bi);
        return (int)cudaGetLastError();
    });
}
