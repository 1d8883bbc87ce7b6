// The float64 tile product of the float64 stack kernel (stack_matmul_f64.cu)
// and of the double instantiations of K4 (grouped_matmul.cu) and K5
// (band_matmul.cu) on the FP64 tensor cores, for T = 128 and T = 64: for one
// C tile, sum A[i]·B[j] over a run of pairs in run order, written once.
//
// What bounded the DFMA routine (tile_run instantiated for double) on an
// H100: the CUDA cores give 33.5 TFLOP/s in float64, the tensor cores 67, and
// the 4×4 micro-tile read 8 doubles from shared memory for 16 DFMA. At 16
// flop a byte (a 128² entry is 256 KB for 4.2 MFLOP) the product is
// compute-bound against HBM, but every entry's tiles come through L2, which
// at the tensor-core rate would have to deliver 4 TB/s: one block must own
// the whole C tile so that each A and B tile is read once per C tile.
//
// The design:
//  - mma.sync.aligned.m16n8k8.row.col.f64 in inline PTX. A Hopper shape, not
//    Ampere's m8n8k4: in register-only loops on an H100 the m16n8k4/k8/k16
//    shapes all reach the data-sheet rate and m8n8k4 half of it
//    (chip_smoke.py prints both for the card it runs on). Among the three,
//    k8 was taken: measured inside this kernel they are within 2%, and k8
//    needs the fewest live fragment registers for a whole 128-bit read.
//  - 8 warps (kThreads = 256) on the T×T block tile, 2 × 4 warps, a warp
//    tile of 64×32 at T = 128 (64 double accumulators = 128 registers a
//    thread) and 32×16 at T = 64. Each fragment read from shared memory
//    feeds 2 (A side) or 8 (B side) mma from registers.
//  - the product is issued transposed, Cᵀ += Bᵀ·Aᵀ: the mma's
//    16-row operand comes from the B chunk and its 8-column operand from the
//    A chunk. The k index inside one mma and the row index inside one m tile
//    are free to permute as long as both operands and the result agree, so
//    thread (g = lane/4, t = lane%4) takes as the mma's k pair (t, t+4) the
//    ADJACENT chunk columns 2t, 2t+1 and as its row pair (g, g+8) the
//    ADJACENT C columns 2g, 2g+1. Every fragment is then one 128-bit LDS that
//    lands in exactly the register pair the mma wants: (a0,a1) and
//    (a2,a3) from two rows of B, (b0,b1) from one row of A. (Issued the
//    straight way round, the same reads deliver (a0,a2) and (a1,a3), and
//    ptxas repairs that with a dozen and more register moves per mma.) In C
//    the thread holds rows 2t, 2t+1 by columns 2g, 2g+1 of each 8×16 cell:
//    two 16-byte stores.
//  - shared-memory rows are padded against bank conflicts: A [row][k] has
//    LDA = KC + 8 doubles (rows g and g+1 of a quarter-warp's read fall in
//    opposite halves of the 128-byte bank line), B [k][col] has LDB = T + 2
//    (the four rows 2t of a quarter-warp's read are 32 bytes apart modulo
//    128). Both strides are multiples of 16 bytes, as cp.async needs.
//  - K chunks of 16 arrive by cp.async (16 bytes a thread, 4 + 4 copies a
//    thread at T = 128, addressed from offsets computed once a block) into a
//    ring of kStages = 4 slots in dynamic shared memory, carried across the
//    entries of the run (tile_ring.cuh): at T = 128 a slot is 24,576 +
//    16,640 = 41,216 bytes, four slots 164,864 bytes, so one block an SM; at
//    T = 64 82,944 bytes and two blocks an SM. Registers (ptxas, sm_90a, CUDA
//    12.9): 218 a thread at T = 128, 91 at T = 64, no spills.
//
// What is left on the table: with one block an SM nothing hides a C tile's
// prologue (two chunk latencies) and epilogue (a 128 KB store), about 3 µs
// of the 35 µs a C tile of the banded SCF shape takes; a persistent block
// that carries the ring from one C tile into the next would.
//
// Determinism: every C element is summed by one thread, entries in stack
// order and K chunks ascending, so two launches are bitwise equal. Inside one
// mma the order of the 8 products is the hardware's, so the result is not
// bitwise that of a DFMA chain; it is held to 1e-12 against the plain
// version.
//
// T = 16 and T = 32 stay on tile_run<double> (a 16-row mma tile over 8 warps
// leaves nothing to reuse there).
#pragma once

#include "tile_ring.cuh"

namespace dbcsr_torch {

// D (16×8) += A (16×8, row) · B (8×8, col); fragments as the PTX ISA lays
// them out for .f64, with g = lane/4 and t = lane%4: a_i is row g + 8·(i%2),
// k t + 4·(i/2); b_i is k t + 4·i, column g; d_0..3 are (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_m16n8k8(double (&d)[4], double2 a01, double2 a23, double2 b01)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a01.x), "d"(a01.y), "d"(a23.x), "d"(a23.y), "d"(b01.x), "d"(b01.y));
}

template <int T>
struct MmaF64 {
    static_assert(T == 64 || T == 128, "float64 mma routine: T = 64 or 128");
    static constexpr int kStages = 4;
    static constexpr int KC = kKC;               // K chunk: two mma depths
    static constexpr int kWarpsR = 2, kWarpsC = 4;
    static constexpr int WR = T / kWarpsR;       // warp tile rows of C
    static constexpr int WC = T / kWarpsC;       // warp tile columns of C
    static constexpr int NT = WR / 8;            // mma n tiles a warp (8 rows of C each)
    static constexpr int MT = WC / 16;           // mma m tiles a warp (16 columns of C each)
    static constexpr int LDA = KC + 8;
    static constexpr int LDB = T + 2;
    static constexpr int kAElems = T * LDA;
    static constexpr int kStageElems = kAElems + KC * LDB;
    static constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(double);
    static constexpr int kAVecRow = KC / 2, kAVecs = T * kAVecRow;  // 16-byte copies a chunk
    static constexpr int kBVecRow = T / 2, kBVecs = KC * kBVecRow;
    static_assert(kWarpsR * kWarpsC * 32 == kThreads, "8 warps");
    static_assert(kAVecs % kThreads == 0 && kBVecs % kThreads == 0, "whole copies");
    static_assert(kThreads % kAVecRow == 0 && kThreads % kBVecRow == 0, "copies step by whole rows");

    double* smem;
    int a_src, a_dst, b_src, b_dst;  // this thread's first copy of a chunk: global, shared offsets
    int a_frag, b_frag;              // this thread's first fragments in a ring slot
    int g, t, row0, col0;
    double acc[NT][MT][4];

    __device__ __forceinline__ explicit MmaF64(double* smem_) : smem(smem_)
    {
        const int tid = threadIdx.x, warp = tid / 32;
        g = (tid % 32) / 4;
        t = tid % 4;
        row0 = (warp / kWarpsC) * WR;
        col0 = (warp % kWarpsC) * WC;
        a_src = (tid / kAVecRow) * T + 2 * (tid % kAVecRow);
        a_dst = (tid / kAVecRow) * LDA + 2 * (tid % kAVecRow);
        b_src = (tid / kBVecRow) * T + 2 * (tid % kBVecRow);
        b_dst = kAElems + (tid / kBVecRow) * LDB + 2 * (tid % kBVecRow);
        a_frag = (row0 + g) * LDA + 2 * t;
        b_frag = kAElems + 2 * t * LDB + col0 + 2 * g;
        zero();
    }

    __device__ __forceinline__ void zero()
    {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[n][m][i] = 0.0;
    }

    // chunk [k0, k0+KC) of the tiles at a and b -> ring slot `stage`
    __device__ __forceinline__ void load(int stage, const double* a, const double* b, int k0)
    {
        double* slot = smem + stage * kStageElems;
        const double* ap = a + a_src + k0;
        const double* bp = b + b_src + k0 * T;
        constexpr int kARows = kThreads / kAVecRow, kBRows = kThreads / kBVecRow;
#pragma unroll
        for (int i = 0; i < kAVecs / kThreads; ++i)
            cp_async16(slot + a_dst + i * kARows * LDA, ap + i * kARows * T);
#pragma unroll
        for (int i = 0; i < kBVecs / kThreads; ++i)
            cp_async16(slot + b_dst + i * kBRows * LDB, bp + i * kBRows * T);
    }

    // acc += A chunk · B chunk, as Cᵀ += Bᵀ·Aᵀ: the mma's 16-row operand is
    // read from the B chunk, its 8-column operand from the A chunk, so that
    // every 128-bit read lands in the register pair the mma wants.
    // The two depths of 8 are taken in ascending order.
    __device__ __forceinline__ void compute(int stage)
    {
        const double* slot = smem + stage * kStageElems;
#pragma unroll
        for (int h = 0; h < KC / 8; ++h) {
            // B rows 8h + 2t (mma k = t) and 8h + 2t + 1 (mma k = t + 4),
            // columns 2g, 2g + 1 of m tile m (mma rows g, g + 8)
            double2 bf[MT][2];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    bf[m][j] = *reinterpret_cast<const double2*>(
                        slot + b_frag + (8 * h + j) * LDB + 16 * m);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                // A row g of n tile n (mma column g), columns 8h + 2t, 8h + 2t + 1
                const double2 af = *reinterpret_cast<const double2*>(
                    slot + a_frag + 8 * n * LDA + 8 * h);
#pragma unroll
                for (int m = 0; m < MT; ++m) mma_m16n8k8(acc[n][m], bf[m][0], bf[m][1], af);
            }
        }
    }

    // acc[n][m] holds C rows 8n + 2t, 8n + 2t + 1 (mma columns) by columns
    // 16m + 2g, 16m + 2g + 1 (mma rows g, g + 8) of the warp tile
    __device__ __forceinline__ void store(double* __restrict__ out) const
    {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                double* p = out + (int64_t)(row0 + 8 * n + 2 * t) * T + col0 + 16 * m + 2 * g;
                *reinterpret_cast<double2*>(p) = make_double2(acc[n][m][0], acc[n][m][2]);
                *reinterpret_cast<double2*>(p + T) = make_double2(acc[n][m][1], acc[n][m][3]);
            }
    }
};

// The whole C tile `out` = Σ_{e in [e0, e1)} A[ia(e)] @ B[ib(e)], by one
// block of kThreads threads; `smem` is MmaF64<T>::kSmemBytes of dynamic
// shared memory, 16-byte aligned.
template <int T, typename PairFn>
__device__ __forceinline__ void tile_run_mma_f64(
    const double* __restrict__ A, const double* __restrict__ B, double* __restrict__ out,
    int e0, int e1, PairFn pair, double* smem)
{
    using Body = MmaF64<T>;
    Body body(smem);
    ChunkCursor<double, T, Body::KC, PairFn> cur(A, B, e0, e1, pair);
    ring_run<Body::kStages>(cur, body);
    body.store(out);
}

}  // namespace dbcsr_torch
