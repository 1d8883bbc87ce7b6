// The register-blocked, pipelined float32 tile product of K1 to K5
// (stack_matmul.cu, panel_matmul.cu, panel_runs_matmul.cu, grouped_matmul.cu,
// band_matmul.cu), for T = 128 and T = 64: for one C tile, sum A[i]·B[j] over
// a run of (i, j) pairs in run order, in IEEE FFMA, and write the sum once.
// It computes what tile_run (tile_product.cuh) computes, bit for bit: every C
// element is one fmaf chain over the run in stack order and ascending k,
// whatever the blocking, so two kernels through it agree bitwise on the same
// stack. No split-K, no second partial accumulator, no fast-math.
//
// What bounded tile_run at these tile edges on an H100 and what this design
// does about it:
//  - shared-memory reads: a 4×4 micro-tile took 8 scalar LDS for 16 FFMA.
//    Here ONE block of 256 threads owns the whole C tile and a thread keeps
//    a TM×TM micro-tile, TM = T/16 (8×8 = 64 accumulators at T = 128, 4×4
//    at T = 64), read with 128-bit LDS: A stays row-major in shared memory
//    ([row][k], as cp.async delivers it) and a thread reads four consecutive
//    k of one row at once; B is [k][col] and a thread reads four consecutive
//    columns. Per four k steps at T = 128: 8 + 8 LDS.128 for 256 FFMA (one
//    LDS per 16 FFMA instead of one per 2). Rows and columns of a thread come
//    in groups of four, the groups T/2 apart (rows ty·4.., T/2 + ty·4..), so
//    a quarter-warp's B read is 128 contiguous bytes; A rows are padded by
//    16 bytes (LDA) so that the two rows a warp reads at once, four apart,
//    fall in different banks. No read conflicts.
//  - exposed latency: the K chunk (16) went global -> shared between two
//    barriers. Here chunks of KC = 32 arrive by cp.async (16 bytes a thread,
//    addressed from offsets computed once a block) into a ring of kStages = 3
//    slots in dynamic shared memory, carried across the entries of the run
//    (tile_ring.cuh), one barrier per chunk.
//  - L2 traffic: a C tile at T = 128 was four blocks, so each A and B tile
//    was read twice; one block per C tile reads each once.
//
// bf16 slabs ("default" precision) take the same routine: the chunk stays
// bf16 in shared memory (half the staging bytes) and is widened to float32
// at the fragment read, which is exact, so the products and the chain are
// those of tile_run's bf16 instantiation. T = 16 and T = 32 stay on tile_run
// (a 16×16 thread grid has nothing to block there).
//
// Resources at T = 128 (ptxas, sm_90a, CUDA 12.9): float32 3 × 34,816 =
// 104,448 bytes of dynamic shared memory a block, bf16 3 × 18,432 = 55,296;
// 128 registers, the cap of __launch_bounds__(256, 2), no spills with the
// chunk loop unrolled by 2. Two blocks share an SM, so one's prologue and
// epilogue (a 64 KB store) hide behind the other's arithmetic.
//
// What is left on the table: the inner loop runs at about 60% of the FFMA
// rate whatever the stages, chunk depth, unrolling or warp layout (all were
// tried). An 8×8 micro-tile needs four LDS.128 per 64 FFMA a warp; on this SM
// (128 FFMA lanes, one 128-byte shared-memory access a clock) that keeps the
// shared-memory pipe as busy as the FFMA pipe. More needs a larger register
// tile per warp than 128 registers a thread allow at two blocks an SM.
#pragma once

#include "tile_ring.cuh"

namespace dbcsr_torch {

// four consecutive elements from shared memory, widened to float32
__device__ __forceinline__ void load4(const float* p, float* out)
{
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out)
{
    // bf16 -> f32 is the bit pattern shifted into the high half (exact)
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <typename In, int T>
struct BlockedF32 {
    static_assert(T == 64 || T == 128, "blocked float32 routine: T = 64 or 128");
    static constexpr int kStages = 3;
    static constexpr int KC = 32;                   // K chunk (a multiple of 8)
    static constexpr int TM = T / 16;               // micro-tile edge
    static constexpr int NG = TM / 4;               // groups of four rows / columns
    static constexpr int GS = T / NG;               // distance between groups
    static constexpr int EPV = 16 / (int)sizeof(In);  // elements per 16-byte copy
    static constexpr int LDA = KC + EPV;            // A row stride: 16 bytes of padding
    static constexpr int LDB = T;
    static constexpr int kAElems = T * LDA;
    static constexpr int kStageElems = kAElems + KC * LDB;
    static constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(In);

    static constexpr int kAVecRow = KC / EPV, kAVecs = T * kAVecRow;  // 16-byte copies a chunk
    static constexpr int kBVecRow = T / EPV, kBVecs = KC * kBVecRow;
    static_assert(kThreads % kAVecRow == 0 && kThreads % kBVecRow == 0, "copies step by whole rows");

    // row of the micro-tile's i-th row, relative to the thread's first (ty·4)
    static __device__ __forceinline__ int row_of(int i) { return (i / 4) * GS + i % 4; }
    In* smem;
    int a_src, a_dst, b_src, b_dst;  // this thread's first copy of a chunk: global, shared offsets
    int a_frag, b_frag;              // this thread's first fragments in a ring slot
    int tid, tx, ty;
    float acc[TM][TM];

    __device__ __forceinline__ explicit BlockedF32(In* smem_)
        : smem(smem_), tid(threadIdx.x), tx(threadIdx.x % 16), ty(threadIdx.x / 16)
    {
        a_src = (tid / kAVecRow) * T + EPV * (tid % kAVecRow);
        a_dst = (tid / kAVecRow) * LDA + EPV * (tid % kAVecRow);
        b_src = (tid / kBVecRow) * T + EPV * (tid % kBVecRow);
        b_dst = kAElems + (tid / kBVecRow) * LDB + EPV * (tid % kBVecRow);
        a_frag = ty * 4 * LDA;
        b_frag = kAElems + tx * 4;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
    }

    // chunk [k0, k0+KC) of the tiles at a and b -> ring slot `stage`; a
    // thread's copies are whole rows apart, so only the first is addressed
    __device__ __forceinline__ void load(int stage, const In* a, const In* b, int k0)
    {
        In* slot = smem + stage * kStageElems;
        const In* ap = a + a_src + k0;
        const In* bp = b + b_src + k0 * T;
        constexpr int kARows = kThreads / kAVecRow, kBRows = kThreads / kBVecRow;
#pragma unroll
        for (int i = 0; i * kThreads < kAVecs; ++i)
            if (kAVecs % kThreads == 0 || i * kThreads + tid < kAVecs)
                cp_async16(slot + a_dst + i * kARows * LDA, ap + i * kARows * T);
#pragma unroll
        for (int i = 0; i * kThreads < kBVecs; ++i)
            if (kBVecs % kThreads == 0 || i * kThreads + tid < kBVecs)
                cp_async16(slot + b_dst + i * kBRows * LDB, bp + i * kBRows * T);
    }

    // acc += A chunk · B chunk, k ascending
    __device__ __forceinline__ void compute(int stage)
    {
        const In* As = smem + stage * kStageElems + a_frag;
        const In* Bs = smem + stage * kStageElems + b_frag;
        // unrolled by 2: a loop body of 8 k steps (512 FFMA) fits the 128
        // registers without spills; the full chunk unrolled does not
#pragma unroll 2
        for (int k4 = 0; k4 < KC; k4 += 4) {
            float av[TM][4];  // av[i][kk] = A[row i of the micro-tile][k4 + kk]
#pragma unroll
            for (int i = 0; i < TM; ++i)
                load4(As + row_of(i) * LDA + k4, av[i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float bv[TM];
#pragma unroll
                for (int g = 0; g < NG; ++g)
                    load4(Bs + (k4 + kk) * LDB + g * GS, bv + 4 * g);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TM; ++j)
                        acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
            }
        }
    }

    __device__ __forceinline__ void store(float* __restrict__ out) const
    {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            float* row = out + (int64_t)(ty * 4 + row_of(i)) * T;
#pragma unroll
            for (int g = 0; g < NG; ++g)
                *reinterpret_cast<float4*>(row + g * GS + tx * 4) = make_float4(
                    acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
        }
    }
};

// The whole C tile `out` = Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)], by one
// block of kThreads threads; `smem` is BlockedF32<In, T>::kSmemBytes of
// dynamic shared memory, 16-byte aligned.
template <typename In, int T, typename PairFn>
__device__ __forceinline__ void tile_run_blocked_f32(
    const In* __restrict__ A, const In* __restrict__ B, float* __restrict__ out,
    int e0, int e1, PairFn pair, In* smem)
{
    using Body = BlockedF32<In, T>;
    Body body(smem);
    ChunkCursor<In, T, Body::KC, PairFn> cur(A, B, e0, e1, pair);
    ring_run<Body::kStages>(cur, body);
    body.store(out);
}

}  // namespace dbcsr_torch
