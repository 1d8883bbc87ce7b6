// The float64 stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @ B[b_idx[e]]
// with float64 inputs, float64 products and float64 sums.
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
// c-sorted stack as K1 (run offsets c_ptr[n_c+1], a/b columns), takes every
// T in KERNEL_TILES and runs of any length. One block owns its output
// region, walks its run in stack order and writes it once, with no atomics:
// two launches are bitwise equal.
//
// What bounds it on an H100: each stack entry reads one A and one B tile and
// does 2·T³ flops — at T=128 in f64, 256 KB for 4.2 MFLOP, 16 flop/byte.
// That is under the tensor cores' HBM ridge (67 TFLOP/s over 3.35 TB/s = 20
// flop/byte), but neighbouring C tiles of a banded stack share their tiles
// through the 50 MB L2, and reading each tile once takes half the time of
// the operations. So it is bound by operations at the FP64 tensor-core rate,
// and next by what L2 can deliver (4 TB/s at that rate).
//
// T = 128 and T = 64 run on the FP64 tensor cores: one block of 256 threads
// per C tile, mma.sync m16n8k8 over 64×32 (T = 64: 32×16) warp tiles held in
// registers, K chunks of 16 brought by cp.async into a four-slot ring of
// dynamic shared memory that runs across the entries of the run
// (tile_mma_f64.cuh has the layout; T = 128: 164,864 bytes, 218 registers
// a thread and one block an SM, T = 64: 82,944 bytes, 91 registers and two;
// no spills). Sums inside one mma are taken in the
// hardware's order, so the result agrees with a DFMA chain to rounding
// (1e-12 of the largest entry), not bitwise.
//
// T = 16 and T = 32 keep the DFMA routine tile_run<double> of
// tile_product.cuh (one block per tile, 16×16 threads, a 1×1 or 2×2
// micro-tile): a 16-row mma tile spread over 8 warps reuses nothing there.
#include "tile_kernel.cuh"

extern "C" int dbcsr_torch_stack_matmul_f64(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, long long n_c, int tile,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const StackJob job{static_cast<const int*>(c_ptr), static_cast<const int*>(a_idx),
                       static_cast<const int*>(b_idx)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_tile<double>(tile, [&](auto, auto tile_tag) {
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<double, T>(
            static_cast<const double*>(a), static_cast<const double*>(b),
            static_cast<double*>(c), n_c, job, s);
    });
}
