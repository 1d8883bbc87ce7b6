// One device routine shared by the stack kernels: for one C tile, sum
// A[i]·B[j] over a contiguous run of (i, j) pairs, in run order, and write
// the sum once. A pair with a negative slot is an absent tile (a zero tile)
// and is skipped. band_matmul.cu and panel_runs_matmul.cu run it at every
// tile edge; stack_matmul.cu, panel_matmul.cu, grouped_matmul.cu and
// stack_matmul_f64.cu run it at T = 16 and 32 and take the pipelined
// routines at T = 64 and 128 (tile_kernel.cuh picks).
//
// Tile stores are [n, T, T] row-major. A block of 256 threads owns one
// BM×BM sub-tile of one C tile (BM = min(T, 64)), so a C tile is (T/BM)²
// blocks and no two blocks touch the same output element: each C tile is
// written exactly once, with no atomics, and every element's sum is taken
// in the same fixed order on every run (bitwise deterministic).
//
// Inside a block: K is staged through shared memory in chunks of 16 (A
// transposed, so a thread's rows are read with broadcast), each thread
// keeps a (BM/16)×(BM/16) micro-tile of f32 accumulators in registers,
// strided by 16 rows/cols so shared-memory reads are free of bank
// conflicts. f32 inputs run IEEE FFMA; bf16 inputs are widened to f32 in
// shared memory, so every product is exact and only the f32 sums round.
// f64 inputs accumulate in f64 (DFMA): the accumulator type follows the
// input type (AccOf), so the f32/bf16 instantiations compile as before.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dbcsr_torch {

constexpr int kThreads = 256;  // 16 × 16 thread grid over a sub-tile
constexpr int kKC = 16;        // K chunk staged through shared memory

// accumulator (and shared-memory staging) type of an input type
template <typename In> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// BM×BM sub-tile (rows r0.., cols c0..) of one C tile `out`:
//   out[r0:r0+BM, c0:c0+BM] = Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)]
// restricted to those rows/cols; `pair(e)` returns (ia, ib) as int2, either
// negative for an absent tile (the same for every thread of the block).
template <typename In, int T, int BM, typename PairFn>
__device__ __forceinline__ void tile_run(
    const In* __restrict__ A, const In* __restrict__ B,
    typename AccOf<In>::type* __restrict__ out,
    int r0, int c0, int e0, int e1, PairFn pair)
{
    using Acc = typename AccOf<In>::type;
    static_assert(BM % 16 == 0 && T % BM == 0 && T % kKC == 0, "tile shape");
    constexpr int TM = BM / 16;                    // micro-tile edge
    constexpr int kLoads = BM * kKC / kThreads;    // elements per thread per chunk
    __shared__ Acc As[kKC][BM + 1];  // As[k][r] = A[r0 + r][k0 + k]
    __shared__ Acc Bs[kKC][BM];      // Bs[k][c] = B[k0 + k][c0 + c]

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    Acc acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = Acc(0);

    for (int e = e0; e < e1; ++e) {
        const int2 ij = pair(e);
        if (ij.x < 0 || ij.y < 0) continue;  // block-uniform: no barrier is split
        // 64-bit tile offsets: idx·T·T overflows int32 past 131,072 tiles at T=128
        const In* a = A + (int64_t)ij.x * (T * T) + (int64_t)r0 * T;
        const In* b = B + (int64_t)ij.y * (T * T) + c0;
        for (int k0 = 0; k0 < T; k0 += kKC) {
#pragma unroll
            for (int p = 0; p < kLoads; ++p) {
                const int idx = tid + p * kThreads;
                const int ar = idx / kKC, ak = idx % kKC;   // 16 threads read one row segment
                As[ak][ar] = widen(a[ar * T + k0 + ak]);
                const int bk = idx / BM, bc = idx % BM;     // consecutive threads, consecutive columns
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
            out[(int64_t)(r0 + ty + 16 * i) * T + c0 + tx + 16 * j] = acc[i][j];
}

// Sub-tile edge for a tile edge T.
template <int T>
struct SubTile {
    static constexpr int BM = T < 64 ? T : 64;
    static constexpr int kPerTile = (T / BM) * (T / BM);
};

// input types of the entry points that take a dtype code (K6's port has an
// entry point of its own and takes none)
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

// Grid of one block per (output tile, sub-tile); 0 blocks when it overflows.
template <int T>
static unsigned tile_grid(long long n_tiles)
{
    const long long blocks = n_tiles * SubTile<T>::kPerTile;
    return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

}  // namespace dbcsr_torch

extern "C" const char* dbcsr_torch_error_string(int code);
