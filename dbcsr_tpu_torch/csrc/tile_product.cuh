// One device routine shared by the two stack kernels (stack_matmul.cu,
// panel_matmul.cu): for one C tile, sum A[i]·B[j] over a contiguous run of
// (i, j) pairs, in run order, and write the sum once.
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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dbcsr_torch {

constexpr int kThreads = 256;  // 16 × 16 thread grid over a sub-tile
constexpr int kKC = 16;        // K chunk staged through shared memory

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// BM×BM sub-tile (rows r0.., cols c0..) of one C tile `out`:
//   out[r0:r0+BM, c0:c0+BM] = Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)]
// restricted to those rows/cols; `pair(e)` returns (ia, ib) as int2.
template <typename In, int T, int BM, typename PairFn>
__device__ __forceinline__ void tile_run(
    const In* __restrict__ A, const In* __restrict__ B, float* __restrict__ out,
    int r0, int c0, int e0, int e1, PairFn pair)
{
    static_assert(BM % 16 == 0 && T % BM == 0 && T % kKC == 0, "tile shape");
    constexpr int TM = BM / 16;                    // micro-tile edge
    constexpr int kLoads = BM * kKC / kThreads;    // elements per thread per chunk
    __shared__ float As[kKC][BM + 1];  // As[k][r] = A[r0 + r][k0 + k]
    __shared__ float Bs[kKC][BM];      // Bs[k][c] = B[k0 + k][c0 + c]

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

    for (int e = e0; e < e1; ++e) {
        const int2 ij = pair(e);
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
                float av[TM], bv[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < TM; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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

enum DType : int { kF32 = 0, kBF16 = 1 };

}  // namespace dbcsr_torch

extern "C" const char* dbcsr_torch_error_string(int code);
