// The device routine of the stack kernels at the small tile edges: for one C
// tile, sum A[i]·B[j] over a contiguous run of (i, j) pairs, in run order,
// and write the sum once. A pair with a negative slot is an absent tile (a
// zero tile) and is skipped. Every stack kernel runs it at T = 16 and 32
// and takes a pipelined routine at T = 64 and 128 (tile_kernel.cuh picks).
//
// Tile stores are [n, T, T] row-major. A block of 256 threads owns one whole
// C tile: each is written exactly once, with no atomics, every element's sum
// in the same fixed order on every run (bitwise deterministic).
//
// Inside a block: K is staged through shared memory in chunks of 16 (A
// transposed, so a thread's rows are read with broadcast), each thread keeps
// a (T/16)×(T/16) micro-tile of accumulators in registers, strided by 16
// rows/cols so shared-memory reads are free of bank conflicts. f32 inputs run
// IEEE FFMA; bf16 inputs are widened to f32 in shared memory, so every product
// is exact and only the f32 sums round; f64 inputs accumulate in f64 (DFMA):
// the accumulator type follows the input type (AccOf). Complex tiles
// (float2 = complex64, double2 = complex128, interleaved re/im as torch
// stores them) accumulate in their own type: each complex multiply-add is
// the four fused multiply-adds of fma_acc, in its fixed order, so K1's
// complex64 instantiation (KC1) and the complex128 one (KC2) at T <= 32 sum
// every element in one fixed order too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dbcsr_torch {

constexpr int kThreads = 256;  // 16 × 16 thread grid over a tile
constexpr int kKC = 16;        // K chunk staged through shared memory

// accumulator (and shared-memory staging) type of an input type
template <typename In> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };
template <> struct AccOf<float2> { using type = float2; };
template <> struct AccOf<double2> { using type = double2; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float2 widen(float2 x) { return x; }
__device__ __forceinline__ double2 widen(double2 x) { return x; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// c += a·b for complex a = (ar, ai), b = (br, bi): four fused multiply-adds
// in this order, which fixes the complex kernels' bits (every routine that
// sums complex tiles, tile_product_c64.cuh's too, uses it):
//   re = fma(ar, br, re); re = fma(-ai, bi, re);
//   im = fma(ar, bi, im); im = fma(ai, br, im)
template <typename R>
__device__ __forceinline__ void cmac(R& re, R& im, R ar, R ai, R br, R bi)
{
    re = fma_acc(ar, br, re);
    re = fma_acc(-ai, bi, re);
    im = fma_acc(ar, bi, im);
    im = fma_acc(ai, br, im);
}

__device__ __forceinline__ float2 fma_acc(float2 a, float2 b, float2 c)
{
    cmac(c.x, c.y, a.x, a.y, b.x, b.y);
    return c;
}

__device__ __forceinline__ double2 fma_acc(double2 a, double2 b, double2 c)
{
    cmac(c.x, c.y, a.x, a.y, b.x, b.y);
    return c;
}

// The whole C tile `out` = Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)]; `pair(e)`
// returns (ia, ib) as int2, either negative for an absent tile (the same for
// every thread of the block).
template <typename In, int T, typename PairFn>
__device__ __forceinline__ void tile_run(
    const In* __restrict__ A, const In* __restrict__ B,
    typename AccOf<In>::type* __restrict__ out, int e0, int e1, PairFn pair)
{
    using Acc = typename AccOf<In>::type;
    static_assert(T % 16 == 0 && T % kKC == 0 && T <= 32, "tile shape");
    constexpr int TM = T / 16;                   // micro-tile edge
    constexpr int kLoads = T * kKC / kThreads;   // elements per thread per chunk
    __shared__ Acc As[kKC][T + 1];  // As[k][r] = A[r][k0 + k]
    __shared__ Acc Bs[kKC][T];      // Bs[k][c] = B[k0 + k][c]

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    Acc acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = Acc{};

    for (int e = e0; e < e1; ++e) {
        const int2 ij = pair(e);
        if (ij.x < 0 || ij.y < 0) continue;  // block-uniform: no barrier is split
        // 64-bit tile offsets: idx·T·T overflows int32 for a large store
        const In* a = A + (int64_t)ij.x * (T * T);
        const In* b = B + (int64_t)ij.y * (T * T);
        for (int k0 = 0; k0 < T; k0 += kKC) {
#pragma unroll
            for (int p = 0; p < kLoads; ++p) {
                const int idx = tid + p * kThreads;
                const int ar = idx / kKC, ak = idx % kKC;   // 16 threads read one row segment
                As[ak][ar] = widen(a[ar * T + k0 + ak]);
                const int bk = idx / T, bc = idx % T;       // consecutive threads, consecutive columns
                Bs[bk][bc] = widen(b[(k0 + bk) * T + bc]);
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < kKC; ++k) {
                Acc av[TM], bv[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < TM; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TM; ++j) acc[i][j] = fma_acc(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
            out[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
}

// input types of the entry points that take a dtype code (K6's port and the
// complex stack kernels have entry points of their own and take none)
enum DType : int { kF32 = 0, kBF16 = 1, kF64 = 2 };

// Tile-edge and input-type dispatch for entry points that take both as run
// time codes: `f(TypeTag<In>{}, TileTag<T>{})` is called with the matching
// instantiation and its int result (a cudaError_t) returned.
template <typename In> struct TypeTag { using type = In; };
template <int T> struct TileTag { static constexpr int value = T; };

template <typename In, typename F>
static int dispatch_tile(int tile, F&& f)
{
    switch (tile) {
        case 16: return f(TypeTag<In>{}, TileTag<16>{});
        case 32: return f(TypeTag<In>{}, TileTag<32>{});
        case 64: return f(TypeTag<In>{}, TileTag<64>{});
        case 128: return f(TypeTag<In>{}, TileTag<128>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool WithF64, typename F>
static int dispatch(int dtype, int tile, F&& f)
{
    if (dtype == kF32) return dispatch_tile<float>(tile, f);
    if (dtype == kBF16) return dispatch_tile<__nv_bfloat16>(tile, f);
    if constexpr (WithF64) {
        if (dtype == kF64) return dispatch_tile<double>(tile, f);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace dbcsr_torch

extern "C" const char* dbcsr_torch_error_string(int code);
