// The shared-memory ring of the pipelined routines (tile_product_f32.cuh
// under K1 to K5, tile_mma_f64.cuh under the float64 stack kernel and the
// double instantiations of K4 and K5, tile_product_c64.cuh under KC1 and
// tile_mma_c128.cuh under KC2): cp.async copies, a cursor that walks
// one C tile's run of (A tile, B tile) pairs K chunk by K chunk, and the loop
// that keeps NSTAGE-1 chunks in flight while one is multiplied.
//
// The ring runs across the entries of a run, not only inside one tile
// product: the step after the last K chunk of entry e is the first K chunk
// of entry e+1, so its copy overlaps entry e's arithmetic. That matters
// because the runs are short (2.7 entries a C tile on the banded SCF shape):
// a pipeline that drained at every entry would expose one L2 latency per
// entry. A pair with a negative slot is an absent tile (a hole in K5's
// band); the cursor steps over it (the same for every thread of the block),
// so it occupies no stage and the group count stays in step with the chunks.
#pragma once

#include "tile_product.cuh"

namespace dbcsr_torch {

// 16 bytes global -> shared, bypassing L1 (each byte of a chunk is used by
// this block once); both addresses must be 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src_global)
{
    const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst), "l"(src_global) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Walks entries [e0, e1) of a run: next() moves to the following K chunk of
// width KC, stepping to the next present entry after a tile's last chunk,
// and returns false when the run is exhausted. `pair(e)` returns (ia, ib)
// as int2, either negative for an absent tile. After a true next(), `a` and
// `b` are the bases of the entry's A and B tiles and `k0` the chunk start.
template <typename In, int T, int KC, typename PairFn>
struct ChunkCursor {
    const In* A;
    const In* B;
    int e, e1;
    PairFn pair;
    const In* a;
    const In* b;
    int k0;

    __device__ __forceinline__ ChunkCursor(const In* A_, const In* B_, int e0, int e1_, PairFn p)
        : A(A_), B(B_), e(e0), e1(e1_), pair(p), a(nullptr), b(nullptr), k0(T - KC) {}

    __device__ __forceinline__ bool next()
    {
        if (k0 + KC < T) {
            k0 += KC;
            return true;
        }
        while (e < e1) {
            const int2 ij = pair(e++);
            if (ij.x < 0 || ij.y < 0) continue;  // block-uniform
            // 64-bit tile offsets: idx·T·T overflows int32 past 131,072 tiles at T=128
            a = A + (int64_t)ij.x * (T * T);
            b = B + (int64_t)ij.y * (T * T);
            k0 = 0;
            return true;
        }
        return false;  // and again on every later call: k0 stays at T - KC
    }
};

// Drives `body` over every chunk the cursor yields, in order:
// body.load(stage, a, b, k0) issues the chunk's cp.async copies into ring
// slot `stage`, body.compute(stage) multiplies the chunk held there. Every
// thread of the block calls this with the same cursor state. One
// __syncthreads() per chunk: it publishes the chunk that has just landed and
// retires the slot that was multiplied in the previous turn, which is the
// slot the next copy overwrites. A group is committed every turn, empty when
// the run has no further chunk, so wait_group's count always names the same
// chunk.
template <int NSTAGE, typename Cursor, typename Body>
__device__ __forceinline__ void ring_run(Cursor& cur, Body& body)
{
    static_assert(NSTAGE >= 2, "the ring needs two slots");
    int issued = 0, done = 0;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (cur.next()) {
            body.load(s, cur.a, cur.b, cur.k0);
            ++issued;
        }
        cp_async_commit();
    }
    int rd = 0, wr = NSTAGE - 1;
    while (done < issued) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        if (cur.next()) {
            body.load(wr, cur.a, cur.b, cur.k0);
            ++issued;
        }
        cp_async_commit();
        body.compute(rd);
        ++done;
        rd = rd + 1 == NSTAGE ? 0 : rd + 1;
        wr = wr + 1 == NSTAGE ? 0 : wr + 1;
    }
    cp_async_wait<0>();
}

}  // namespace dbcsr_torch
