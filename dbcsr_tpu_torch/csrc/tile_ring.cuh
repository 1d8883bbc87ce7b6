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
//
// K occupancy (the float64 stack kernel only): a pair function may return an
// int3 whose z is the pair's occupancy mask, bit h set iff mma depth h
// (columns 8h..8h+7 of the A tile, the same rows of the B tile) may hold a
// nonzero product. The cursor then yields only the K chunks with a bit set
// and skips a pair whose mask is 0 as it skips an absent tile; ring_run
// hands the body each chunk's depth bits. A pair function that returns int2
// takes the plain cursor and loop, compiled as before the masks existed.
#pragma once

#include <type_traits>
#include <utility>

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
// as int2, either negative for an absent tile, or as int3 with the pair's
// K occupancy in z (above). After a true next(), `a` and `b` are the bases
// of the entry's A and B tiles, `k0` the chunk start and, with occupancy,
// `depths` the chunk's occupied mma depths (KC/8 bits).
template <typename In, int T, int KC, typename PairFn>
struct ChunkCursor {
    static constexpr bool kMasked =
        std::is_same_v<std::decay_t<decltype(std::declval<PairFn&>()(0))>, int3>;
    static constexpr int kDepths = KC / 8;                    // mma depths a chunk
    static constexpr unsigned kChunkBits = (1u << kDepths) - 1;
    static_assert(!kMasked || (T / 8 <= 32 && KC % 8 == 0), "one occupancy bit a depth, 32 at most");
    static constexpr unsigned kTileBits = T / 8 == 32 ? ~0u : (1u << (T / 8)) - 1;

    const In* A;
    const In* B;
    int e, e1;
    PairFn pair;
    const In* a;
    const In* b;
    int k0;
    unsigned live = 0;    // occupied depths of the entry's chunks not yet yielded
    unsigned depths = 0;  // occupied depths of the current chunk

    __device__ __forceinline__ ChunkCursor(const In* A_, const In* B_, int e0, int e1_, PairFn p)
        : A(A_), B(B_), e(e0), e1(e1_), pair(p), a(nullptr), b(nullptr), k0(T - KC) {}

    __device__ __forceinline__ bool next()
    {
        if constexpr (kMasked) {
            for (;;) {
                if (live) {  // block-uniform, as every branch here
                    const int c = (__ffs(live) - 1) / kDepths;
                    depths = (live >> (c * kDepths)) & kChunkBits;
                    live &= ~(kChunkBits << (c * kDepths));
                    k0 = c * KC;
                    return true;
                }
                if (e >= e1) return false;
                const int3 p = pair(e++);
                if (p.x < 0 || p.y < 0) continue;
                live = (unsigned)p.z & kTileBits;
                a = A + (int64_t)p.x * (T * T);
                b = B + (int64_t)p.y * (T * T);
            }
        } else {
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
    }
};

// Drives `body` over every chunk the cursor yields, in order:
// body.load(stage, a, b, k0) issues the chunk's cp.async copies into ring
// slot `stage`, body.compute(stage) multiplies the chunk held there (with
// occupancy, body.load(..., depths) and body.compute(stage, depths) copy and
// multiply its occupied depths alone). Every thread of the block calls this with the same cursor state.
// One __syncthreads() per chunk: it publishes the chunk that has just landed
// and retires the slot that was multiplied in the previous turn, which is
// the slot the next copy overwrites. A group is committed every turn, empty
// when the run has no further chunk, so wait_group's count always names the
// same chunk.
template <int NSTAGE, typename Cursor, typename Body>
__device__ __forceinline__ void ring_run(Cursor& cur, Body& body)
{
    static_assert(NSTAGE >= 2, "the ring needs two slots");
    constexpr int kD = Cursor::kDepths;
    static_assert(!Cursor::kMasked || NSTAGE * kD <= 32, "a slot's depth bits fit one word");
    unsigned held = 0;  // with occupancy: slot s's chunk's depths at bits kD·s
    auto issue = [&](int stage) {
        if constexpr (Cursor::kMasked) {
            body.load(stage, cur.a, cur.b, cur.k0, cur.depths);
            held = (held & ~(Cursor::kChunkBits << (kD * stage))) | (cur.depths << (kD * stage));
        } else {
            body.load(stage, cur.a, cur.b, cur.k0);
        }
    };
    auto multiply = [&](int stage) {
        if constexpr (Cursor::kMasked)
            body.compute(stage, (held >> (kD * stage)) & Cursor::kChunkBits);
        else
            body.compute(stage);
    };
    int issued = 0, done = 0;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (cur.next()) {
            issue(s);
            ++issued;
        }
        cp_async_commit();
    }
    int rd = 0, wr = NSTAGE - 1;
    while (done < issued) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        if (cur.next()) {
            issue(wr);
            ++issued;
        }
        cp_async_commit();
        multiply(rd);
        ++done;
        rd = rd + 1 == NSTAGE ? 0 : rd + 1;
        wr = wr + 1 == NSTAGE ? 0 : wr + 1;
    }
    cp_async_wait<0>();
}

}  // namespace dbcsr_torch
