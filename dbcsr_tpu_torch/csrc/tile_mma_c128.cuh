// The complex128 tile product of KC2 (stack_matmul_c128.cu) on the FP64
// tensor cores, for T = 128 and T = 64: for one C tile, sum A[i]·B[j] over a
// run of pairs in run order, written once.
//
// On the TPU the JAX package runs complex128 as four real float64 products
// through K6 (ops/complex_emu.py: split planes, one plan, four launches,
// then adds). The H100 holds complex128 natively, so this routine reads each
// interleaved (re, im) tile once and issues the four real products of a k
// step from the same fragments.
//
// What bounds it: a complex entry at T = 128 is 8·T³ = 16.8 MFLOP for 512 KB
// of A and B, 32 flop/byte: above the FP64 tensor cores' ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/byte), so operations bound it, as the float64
// kernel (tile_mma_f64.cuh), with twice its bytes and four times its flops a
// tile product.
//
// The design, and where it departs from tile_mma_f64.cuh:
//  - mma.sync.aligned.m16n8k8.row.col.f64, issued transposed as there
//    (Cᵀ += Bᵀ·Aᵀ: the mma's 16-row operand from the B chunk, its 8-column
//    operand from the A chunk). A complex k step is four real mma on the
//    same fragments, always in this order (it fixes the bits):
//      Crᵀ += Brᵀ·Arᵀ;  Crᵀ += Biᵀ·(-Ai)ᵀ;  Ciᵀ += Biᵀ·Arᵀ;  Ciᵀ += Brᵀ·Aiᵀ
//    (-Ai is negated in registers, exactly).
//  - Fragment mapping. tile_mma_f64.cuh takes ADJACENT chunk columns as the
//    mma's k pair so that one 128-bit read fills a register pair; with
//    interleaved complex data two adjacent doubles are the (re, im) of one
//    element, so that trick does not carry over. Here one 128-bit read IS
//    one element, and its re and im go to the real and the imaginary
//    fragment of the same position. The mapping is the natural one: mma
//    row m of a 16-row tile is C column m, mma k slot j is chunk k j, mma
//    column n is C row n. Thread (g = lane/4, t = lane%4) reads B[k t][col g],
//    B[k t][col g+8], B[k t+4][col g], B[k t+4][col g+8] (a0..a3) and
//    A[row g][k t], A[row g][k t+4] (b0, b1), and holds C rows 2t, 2t+1 by
//    columns g, g+8 of each 8×16 cell (d0..d3), written as 16-byte complex
//    values.
//  - cp.async moves 16 bytes, exactly one complex128: the chunks arrive as
//    stored (interleaved), and the split into re/im happens at the fragment
//    read, not in the copy.
//  - shared-memory rows are padded against bank conflicts for these reads:
//    A [row][k] has LDA = KC + 4 complex (a quarter-warp's eight 16-byte
//    reads, rows g, g+1 by k t, fall in eight different 16-byte bank
//    groups), B [k][col] LDB = T + 2 (rows t by columns g, g+1 likewise).
//  - register pressure: a whole 128² complex128 tile is 32,768 doubles,
//    half the SM's register file, so one block cannot hold it. A block owns
//    BR = 64 rows of the C tile (two blocks a C tile at T = 128, each
//    writing its own half: no atomics), 8 warps at 2 × 4 on them, a warp
//    tile of 32×32 complex at T = 128 (64 double accumulators, re and im)
//    and 32×16 at T = 64. Each block reads its 64 rows of A and all of B, so
//    at T = 128 B comes through L2 twice a C tile.
//  - K chunks of KC = 8 complex (one mma depth) into a ring of kStages = 4
//    slots carried across the run's entries (tile_ring.cuh): 28,928 bytes a
//    slot at T = 128 (115,712 in all), 20,736 at T = 64 (82,944).
// Resources (ptxas, sm_90a, CUDA 12.9): 238 registers a thread at T = 128
// and 166 at T = 64, no spills, so one block an SM (at T = 64 a cap of 128
// registers, two blocks an SM, spilled 128 bytes).
// chip_smoke.py's phase 2 prints them for every *_mma_kernel
// instantiation and fails on a spill.
//
// Determinism: every C element is summed by one thread, entries in stack
// order, K chunks ascending and the four products of a step in the order
// above, so two launches are bitwise equal. Inside one mma the order of the
// 8 products is the hardware's, so the result agrees with the plain version
// to rounding (1e-12 of the largest entry), not bitwise.
//
// T = 16 and T = 32 run tile_run's complex128 instantiation (tile_product.cuh).
#pragma once

#include "tile_ring.cuh"

namespace dbcsr_torch {

// D (16×8) += A (16×8, row) · B (8×8, col) in float64, fragments as scalars
// (the PTX ISA's .f64 layout, as tile_mma_f64.cuh states it)
__device__ __forceinline__ void mma_m16n8k8_f64(double (&d)[4], double a0, double a1,
                                                double a2, double a3, double b0, double b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

template <int T>
struct MmaC128 {
    static_assert(T == 64 || T == 128, "complex128 mma routine: T = 64 or 128");
    static constexpr int BR = 64;                // C rows a block owns
    static constexpr int kSplit = T / BR;        // blocks a C tile
    static constexpr int kStages = 4;
    static constexpr int KC = 8;                 // K chunk (complex): one mma depth
    static constexpr int kWarpsR = 2, kWarpsC = 4;
    static constexpr int WR = BR / kWarpsR;      // warp tile rows of C
    static constexpr int WC = T / kWarpsC;       // warp tile columns of C
    static constexpr int NT = WR / 8;            // mma n tiles a warp (8 rows of C each)
    static constexpr int MT = WC / 16;           // mma m tiles a warp (16 columns of C each)
    static constexpr int LDA = KC + 4;
    static constexpr int LDB = T + 2;
    static constexpr int kAElems = BR * LDA;     // complex elements
    static constexpr int kStageElems = kAElems + KC * LDB;
    static constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(double2);
    static constexpr int kAVecs = BR * KC, kBVecs = KC * T;  // 16-byte copies a chunk
    static_assert(kWarpsR * kWarpsC * 32 == kThreads, "8 warps");
    static_assert(kAVecs % kThreads == 0 && kBVecs % kThreads == 0, "whole copies");
    static_assert(kThreads % KC == 0 && kThreads % T == 0, "copies step by whole rows");

    double2* smem;
    int a_src, a_dst, b_src, b_dst;  // this thread's first copy of a chunk: global, shared offsets
    int a_frag, b_frag;              // this thread's first fragments in a ring slot
    int g, t, row0, col0;
    double acc_re[NT][MT][4];
    double acc_im[NT][MT][4];

    // `part` selects the block's rows of the C tile: [part·BR, part·BR + BR)
    __device__ __forceinline__ MmaC128(double2* smem_, int part) : smem(smem_)
    {
        const int tid = threadIdx.x, warp = tid / 32;
        g = (tid % 32) / 4;
        t = tid % 4;
        row0 = (warp / kWarpsC) * WR;
        col0 = (warp % kWarpsC) * WC;
        a_src = (part * BR + tid / KC) * T + tid % KC;
        a_dst = (tid / KC) * LDA + tid % KC;
        b_src = (tid / T) * T + tid % T;
        b_dst = kAElems + (tid / T) * LDB + tid % T;
        a_frag = (row0 + g) * LDA + t;
        b_frag = kAElems + t * LDB + col0 + g;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc_re[n][m][i] = acc_im[n][m][i] = 0.0;
    }

    // chunk [k0, k0+KC) of the tiles at a and b -> ring slot `stage`
    __device__ __forceinline__ void load(int stage, const double2* a, const double2* b, int k0)
    {
        double2* slot = smem + stage * kStageElems;
        const double2* ap = a + a_src + k0;
        const double2* bp = b + b_src + k0 * T;
        constexpr int kARows = kThreads / KC, kBRows = kThreads / T;
#pragma unroll
        for (int i = 0; i < kAVecs / kThreads; ++i)
            cp_async16(slot + a_dst + i * kARows * LDA, ap + i * kARows * T);
#pragma unroll
        for (int i = 0; i < kBVecs / kThreads; ++i)
            cp_async16(slot + b_dst + i * kBRows * LDB, bp + i * kBRows * T);
    }

    // acc += A chunk · B chunk: one mma depth, four real products
    __device__ __forceinline__ void compute(int stage)
    {
        const double2* slot = smem + stage * kStageElems;
        // B (the mma's 16-row operand) of m tile m: a0 (k t, col g), a1
        // (k t, col g+8), a2 (k t+4, col g), a3 (k t+4, col g+8)
        double br[MT][4], bi[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const double2 v = slot[b_frag + 16 * m + 8 * (i % 2) + 4 * (i / 2) * LDB];
                br[m][i] = v.x;
                bi[m][i] = v.y;
            }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            // A (the mma's 8-column operand) of n tile n: b0 (row g, k t), b1 (row g, k t+4)
            const double2 v0 = slot[a_frag + 8 * n * LDA];
            const double2 v1 = slot[a_frag + 8 * n * LDA + 4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                mma_m16n8k8_f64(acc_re[n][m], br[m][0], br[m][1], br[m][2], br[m][3], v0.x, v1.x);
                mma_m16n8k8_f64(acc_re[n][m], bi[m][0], bi[m][1], bi[m][2], bi[m][3], -v0.y, -v1.y);
                mma_m16n8k8_f64(acc_im[n][m], bi[m][0], bi[m][1], bi[m][2], bi[m][3], v0.x, v1.x);
                mma_m16n8k8_f64(acc_im[n][m], br[m][0], br[m][1], br[m][2], br[m][3], v0.y, v1.y);
            }
        }
    }

    // acc[n][m][i]: d0 (row 2t, col g), d1 (row 2t+1, col g), d2 (row 2t,
    // col g+8), d3 (row 2t+1, col g+8) of cell (8n, 16m) of the warp tile;
    // `out` is the block's first row
    __device__ __forceinline__ void store(double2* __restrict__ out) const
    {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = row0 + 8 * n + 2 * t + (i % 2);
                    const int c = col0 + 16 * m + g + 8 * (i / 2);
                    out[(int64_t)r * T + c] = make_double2(acc_re[n][m][i], acc_im[n][m][i]);
                }
    }
};

// Rows [part·BR, part·BR + BR) of the complex128 C tile `out` =
// Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)], by one block of kThreads threads;
// `smem` is MmaC128<T>::kSmemBytes of dynamic shared memory, 16-byte
// aligned.
template <int T, typename PairFn>
__device__ __forceinline__ void tile_run_mma_c128(
    const double2* __restrict__ A, const double2* __restrict__ B, double2* __restrict__ out,
    int e0, int e1, PairFn pair, double2* smem, int part)
{
    using Body = MmaC128<T>;
    Body body(smem, part);
    ChunkCursor<double2, T, Body::KC, PairFn> cur(A, B, e0, e1, pair);
    ring_run<Body::kStages>(cur, body);
    body.store(out + (int64_t)part * Body::BR * T);
}

}  // namespace dbcsr_torch
