// K1, the flat stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @ B[b_idx[e]].
//
// Replaces the TPU kernel dbcsr_tpu/mm/kernels.py:_stack_kernel (launched by
// _pallas_launch / tile_stack_matmul_pallas). The TPU walks the c-sorted
// stack as a sequential grid that revisits each output window, pads C runs to
// e_batch and chunks launches at max_chunk; none of that carries over. Here
// the host passes the run offsets c_ptr[n_c+1] (a searchsorted over the
// sorted c column, once per plan) and the a/b columns, and one block per
// (C tile, BM×BM sub-tile) walks its run [c_ptr[c], c_ptr[c+1]) in stack
// order through the shared routine in tile_product.cuh.
//
// What bounds it on an H100: each stack entry reads one A and one B tile and
// does 2·T³ flops — at T=128 in f32, 128 KB for 4.2 MFLOP, 32 flop/byte even
// when both tiles come from HBM, above the ~20 flop/byte ridge of FFMA
// (67 TFLOP/s over 3.35 TB/s); bf16 inputs halve the bytes. So the kernel is
// compute-bound, and this simple design is bound by FFMA issue and
// shared-memory reads in the micro-tile loop (no tensor cores, no TMA, no
// software pipelining). Neighbouring C tiles of a banded stack share A and B
// tiles, which the 50 MB L2 serves. Correctness first: tensor cores (wgmma),
// TMA rings and persistent blocks are later work.
#include "tile_product.cuh"

namespace dbcsr_torch {

template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
stack_matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
                    float* __restrict__ C, const int* __restrict__ c_ptr,
                    const int* __restrict__ a_idx, const int* __restrict__ b_idx)
{
    using S = SubTile<T>;
    constexpr int NS = T / S::BM;
    const int64_t c = blockIdx.x / S::kPerTile;
    const int sub = blockIdx.x % S::kPerTile;
    const int r0 = (sub / NS) * S::BM, c0 = (sub % NS) * S::BM;
    tile_run<In, T, S::BM>(
        A, B, C + c * (T * T), r0, c0, c_ptr[c], c_ptr[c + 1],
        [=](int e) { return make_int2(a_idx[e], b_idx[e]); });
}

template <typename In, int T>
static int launch(const void* a, const void* b, void* c, const int* c_ptr,
                  const int* a_idx, const int* b_idx, long long n_c,
                  cudaStream_t stream)
{
    const long long blocks = n_c * SubTile<T>::kPerTile;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    stack_matmul_kernel<In, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const In*>(a), static_cast<const In*>(b),
        static_cast<float*>(c), c_ptr, a_idx, b_idx);
    return (int)cudaGetLastError();
}

template <typename In>
static int dispatch_tile(int tile, const void* a, const void* b, void* c,
                         const int* c_ptr, const int* a_idx, const int* b_idx,
                         long long n_c, cudaStream_t s)
{
    switch (tile) {
        case 16: return launch<In, 16>(a, b, c, c_ptr, a_idx, b_idx, n_c, s);
        case 32: return launch<In, 32>(a, b, c, c_ptr, a_idx, b_idx, n_c, s);
        case 64: return launch<In, 64>(a, b, c, c_ptr, a_idx, b_idx, n_c, s);
        case 128: return launch<In, 128>(a, b, c, c_ptr, a_idx, b_idx, n_c, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace dbcsr_torch

extern "C" int dbcsr_torch_stack_matmul(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, long long n_c, int tile, int dtype,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const int* cp = static_cast<const int*>(c_ptr);
    const int* ai = static_cast<const int*>(a_idx);
    const int* bi = static_cast<const int*>(b_idx);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == kF32) return dispatch_tile<float>(tile, a, b, c, cp, ai, bi, n_c, s);
    if (dtype == kBF16) return dispatch_tile<__nv_bfloat16>(tile, a, b, c, cp, ai, bi, n_c, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* dbcsr_torch_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
