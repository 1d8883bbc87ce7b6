// The register-blocked, pipelined complex64 tile product of KC1
// (stack_matmul_c64.cu), for T = 128 and T = 64: for one C tile, sum
// A[i]·B[j] over a run of (i, j) pairs in run order, in IEEE FFMA, and
// write the sum once.
//
// On the TPU the JAX package has no complex unit: ops/complex_emu.py splits
// each complex64 operand into a real and an imaginary float32 plane and runs
// four real products through K1/K2 (one plan, four launches), then adds
// them. The H100 holds complex64 natively, so this routine reads each
// interleaved (re, im) tile once and does all four real products of an
// element pair at the fragment: no split planes, no second launch, no
// combining pass.
//
// Summation order (it fixes the bits): every C element is one chain over
// the run in stack order and, within an entry, ascending k; each step is
// the complex multiply-add cmac of tile_product.cuh,
//   re = fma(ar, br, re); re = fma(-ai, bi, re);
//   im = fma(ar, bi, im); im = fma(ai, br, im),
// the same as tile_run's complex64 instantiation at T <= 32. No split-K,
// no second partial accumulator, no fast-math: two launches are bitwise
// equal.
//
// Design (what bounds it and what it does about it). A complex entry at
// T = 128 is 8·T³ = 16.8 MFLOP for 256 KB of A and B, 64 flop/byte: bound
// by operations at the FFMA rate, like K1, with twice K1's bytes and four
// times its flops a tile product. An 8×8 complex micro-tile a thread would
// be 128 float accumulators, so one block of 256 threads owns the whole C
// tile at one block an SM (__launch_bounds__(256, 1): up to 255 registers):
//  - thread (tx, ty) = (tid % 16, tid / 16) holds rows ty + 16·i and
//    columns 2·tx + 32·g + {0, 1} (i, g over the micro-tile): the 16 threads
//    of a half-warp read one A row (a broadcast) and 256 contiguous bytes of
//    a B row; C is written as 16-byte pairs of complex values;
//  - A stays [row][k] in shared memory as cp.async delivers it, a row padded
//    by 16 bytes (LDA = KC + 2 complex) so that the two rows a warp reads at
//    once fall in different banks; one 128-bit read gives two consecutive k
//    of a row (so the A reads of two k steps are TM loads), one 128-bit read
//    of B gives two consecutive columns; per two k steps a thread makes
//    TM + 2·TM/2 = 16 LDS.128 for 512 FFMA at T = 128 (K1's routine: one
//    per 16 FFMA);
//  - K chunks of KC = 16 complex (128 bytes of an A row) arrive by cp.async
//    into a ring of kStages = 4 slots carried across the run's entries
//    (tile_ring.cuh): 34,816 bytes a slot at T = 128 (as K1's float32 slot),
//    139,264 bytes in all; at T = 64 17,408 and 69,632, two blocks an SM
//    (a 4×4 complex micro-tile, 32 accumulators).
// Resources (ptxas, sm_90a, CUDA 12.9): 206 registers a thread at T = 128,
// 90 at T = 64, no spills; dynamic shared memory 139,264 / 69,632 bytes.
// chip_smoke.py's phase 2 prints registers and spills of every
// *_blocked_kernel and *_mma_kernel instantiation and fails on a spill.
#pragma once

#include "tile_ring.cuh"

namespace dbcsr_torch {

template <int T>
struct BlockedC64 {
    static_assert(T == 64 || T == 128, "blocked complex64 routine: T = 64 or 128");
    static constexpr int kStages = 4;
    static constexpr int KC = 16;                  // K chunk (complex elements)
    static constexpr int TM = T / 16;              // micro-tile edge (complex)
    static constexpr int NG = TM / 2;              // column pairs a thread
    static constexpr int LDA = KC + 2;             // A row stride: 16 bytes of padding
    static constexpr int LDB = T;
    static constexpr int kAElems = T * LDA;        // complex elements
    static constexpr int kStageElems = kAElems + KC * LDB;
    static constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(float2);

    static constexpr int kAVecRow = KC / 2, kAVecs = T * kAVecRow;  // 16-byte copies a chunk
    static constexpr int kBVecRow = T / 2, kBVecs = KC * kBVecRow;
    static_assert(kAVecs % kThreads == 0 && kBVecs % kThreads == 0, "whole copies");
    static_assert(kThreads % kAVecRow == 0 && kThreads % kBVecRow == 0, "copies step by whole rows");

    float2* smem;
    int a_src, a_dst, b_src, b_dst;  // this thread's first copy of a chunk: global, shared offsets
    int a_frag, b_frag;              // this thread's first fragments in a ring slot
    int tx, ty;
    float2 acc[TM][TM];

    __device__ __forceinline__ explicit BlockedC64(float2* smem_)
        : smem(smem_), tx(threadIdx.x % 16), ty(threadIdx.x / 16)
    {
        const int tid = threadIdx.x;
        a_src = (tid / kAVecRow) * T + 2 * (tid % kAVecRow);
        a_dst = (tid / kAVecRow) * LDA + 2 * (tid % kAVecRow);
        b_src = (tid / kBVecRow) * T + 2 * (tid % kBVecRow);
        b_dst = kAElems + (tid / kBVecRow) * LDB + 2 * (tid % kBVecRow);
        a_frag = ty * LDA;
        b_frag = kAElems + 2 * tx;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) acc[i][j] = make_float2(0.0f, 0.0f);
    }

    // chunk [k0, k0+KC) of the tiles at a and b -> ring slot `stage`; a
    // thread's copies are whole rows apart, so only the first is addressed
    __device__ __forceinline__ void load(int stage, const float2* a, const float2* b, int k0)
    {
        float2* slot = smem + stage * kStageElems;
        const float2* ap = a + a_src + k0;
        const float2* bp = b + b_src + k0 * T;
        constexpr int kARows = kThreads / kAVecRow, kBRows = kThreads / kBVecRow;
#pragma unroll
        for (int i = 0; i < kAVecs / kThreads; ++i)
            cp_async16(slot + a_dst + i * kARows * LDA, ap + i * kARows * T);
#pragma unroll
        for (int i = 0; i < kBVecs / kThreads; ++i)
            cp_async16(slot + b_dst + i * kBRows * LDB, bp + i * kBRows * T);
    }

    // acc += A chunk · B chunk, k ascending
    __device__ __forceinline__ void compute(int stage)
    {
        const float2* As = smem + stage * kStageElems + a_frag;
        const float2* Bs = smem + stage * kStageElems + b_frag;
#pragma unroll 1
        for (int k2 = 0; k2 < KC; k2 += 2) {
            float4 av[TM];  // row ty + 16·i at k2 (x, y) and k2 + 1 (z, w)
#pragma unroll
            for (int i = 0; i < TM; ++i)
                av[i] = *reinterpret_cast<const float4*>(As + 16 * i * LDA + k2);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                float4 bv[NG];  // columns 2·tx + 32·g (x, y) and + 1 (z, w) at k2 + kk
#pragma unroll
                for (int g = 0; g < NG; ++g)
                    bv[g] = *reinterpret_cast<const float4*>(Bs + (k2 + kk) * LDB + 32 * g);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float ar = kk ? av[i].z : av[i].x;
                    const float ai = kk ? av[i].w : av[i].y;
#pragma unroll
                    for (int g = 0; g < NG; ++g) {
                        cmac(acc[i][2 * g].x, acc[i][2 * g].y, ar, ai, bv[g].x, bv[g].y);
                        cmac(acc[i][2 * g + 1].x, acc[i][2 * g + 1].y, ar, ai, bv[g].z, bv[g].w);
                    }
                }
            }
        }
    }

    __device__ __forceinline__ void store(float2* __restrict__ out) const
    {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            float2* row = out + (int64_t)(ty + 16 * i) * T + 2 * tx;
#pragma unroll
            for (int g = 0; g < NG; ++g)
                *reinterpret_cast<float4*>(row + 32 * g) = make_float4(
                    acc[i][2 * g].x, acc[i][2 * g].y, acc[i][2 * g + 1].x, acc[i][2 * g + 1].y);
        }
    }
};

// The whole complex64 C tile `out` = Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)],
// by one block of kThreads threads; `smem` is BlockedC64<T>::kSmemBytes of
// dynamic shared memory, 16-byte aligned.
template <int T, typename PairFn>
__device__ __forceinline__ void tile_run_blocked_c64(
    const float2* __restrict__ A, const float2* __restrict__ B, float2* __restrict__ out,
    int e0, int e1, PairFn pair, float2* smem)
{
    using Body = BlockedC64<T>;
    Body body(smem);
    ChunkCursor<float2, T, Body::KC, PairFn> cur(A, B, e0, e1, pair);
    ring_run<Body::kStages>(cur, body);
    body.store(out);
}

}  // namespace dbcsr_torch
