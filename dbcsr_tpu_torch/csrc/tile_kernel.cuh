// The one place where a stack kernel picks its device routine, sizes its
// shared memory and is launched: every .cu file launches through here.
// Every one of these kernels is "for
// each output tile, sum A[i]·B[j] over a run of (i, j) pairs in run order and
// write the sum once"; they differ only in how an output tile finds its C
// slot, its run and its pairs. That part is the kernel's Job, a small struct
// of plan arrays passed by value:
//
//   template <typename Run>
//   __device__ void operator()(int64_t q, Run&& run) const;
//
// For output tile q (the block index) it calls run(slot, e0, e1, pair) once:
// C slot `slot` = Σ_{e in [e0, e1)} A[pair(e).x] @ B[pair(e).y], where
// pair(e) is an int2, either slot negative for an absent tile (or, for the
// float64 routine alone, an int3 that also carries the pair's K occupancy:
// SegmentStackJob, tile_ring.cuh). Every routine
// calls pair once for each e, ascending, from every thread of the block at
// the same point (so a pair function may hold a barrier). A Job that
// has nothing to write for q (a padding row, a slot another block owns)
// returns without calling run; that is block-uniform and comes before any
// barrier. A run with no present pair writes a zero tile. The masked float64
// stack comes cut into run segments (SegmentStackJob): a block then sums a
// run or part of one, into C or into a workspace tile, and
// tile_segment_sum_kernel adds the workspace tiles into C after.
//
// The routine follows from the input type and the tile edge alone, at compile
// time; there is no run-time switch between designs:
//   T <= 32             tile_run (tile_product.cuh), one block per tile, a
//                       16×16 thread grid has nothing to block there;
//   T >= 64, f32/bf16   tile_run_blocked_f32 (tile_product_f32.cuh): one block
//                       per C tile, register-blocked FFMA on a cp.async ring,
//                       two blocks an SM;
//   T >= 64, f64        tile_run_mma_f64 (tile_mma_f64.cuh): FP64 tensor
//                       cores, one block an SM at T = 128, two at T = 64;
//   T >= 64, complex64  tile_run_blocked_c64 (tile_product_c64.cuh): FFMA on
//   (float2)            a cp.async ring, one block a C tile, one block an SM
//                       at T = 128, two at T = 64;
//   T >= 64, complex128 tile_run_mma_c128 (tile_mma_c128.cuh): FP64 tensor
//   (double2)           cores, a block owns 64 rows of a C tile (two blocks
//                       a C tile at T = 128), registers uncapped below 255.
// T <= 32 takes tile_run for every input type, complex ones included.
// The pipelined routines take dynamic shared memory above the 48 KB static
// limit, so launch_tile_kernel opts in with cudaFuncSetAttribute (per device,
// so on every call) before it launches.
//
// The kernels are named *_blocked_kernel and *_mma_kernel so that a ptxas
// report can be searched for the pipelined instantiations; the Job's name in
// the mangled symbol says whose they are.
#pragma once

#include <type_traits>

#include "tile_mma_c128.cuh"
#include "tile_mma_f64.cuh"
#include "tile_product_c64.cuh"
#include "tile_product_f32.cuh"

namespace dbcsr_torch {

// The flat c-sorted stack (K1 and the float64 stack kernel): C tile c owns
// entries [c_ptr[c], c_ptr[c+1]) of the a/b columns.
struct StackJob {
    const int* c_ptr;
    const int* a_idx;
    const int* b_idx;

    template <typename Run>
    __device__ __forceinline__ void operator()(int64_t c, Run&& run) const
    {
        const int* ai = a_idx;
        const int* bi = b_idx;
        run(c, c_ptr[c], c_ptr[c + 1], [=](int e) { return make_int2(ai[e], bi[e]); });
    }
};

// For a Job whose pair function is costly (divisions, dependent loads, absent
// cells): thread t of the block evaluates expand(e0 + t) into a window of
// kStage pairs in static shared memory, and the pair function handed to the
// routine is one shared-memory read (the blocked float32 routine sits
// at its cap of 128 registers: work in the ring loop is paid in spills). A
// run longer than kStage refills the window. Called by every thread.
constexpr int kStage = 64;  // a power of 2

template <typename Expand>
__device__ __forceinline__ auto stage_pairs(int e0, int e1, Expand expand)
{
    __shared__ decltype(expand(e0)) window[kStage];
    auto fill = [=](int v0) {
        for (int v = v0 + (int)threadIdx.x; v < e1 && v < v0 + kStage; v += kThreads)
            window[v - v0] = expand(v);
    };
    fill(e0);
    __syncthreads();
    return [=](int v) {
        const int w = (v - e0) & (kStage - 1);
        if (w == 0 && v != e0) {
            __syncthreads();  // every thread has read the window's last pair
            fill(v);
            __syncthreads();
        }
        return window[w];
    };
}

// The float64 stack with the K occupancy of its tiles, cut into run
// segments (stack_matmul_f64.cu at T = 64 and 128). a_chunks[ia] has bit h
// set iff columns 8h..8h+7 of A tile ia hold a stored block, b_chunks[ib]
// the same for rows of B tile ib; a pair's occupancy is their AND
// (tile_ring.cuh). The pairs and their masks go through stage_pairs: the
// mask lookups depend on the slot loads, and a chain of two loads on every
// entry would stall the ring. Block q takes entries [seg_ptr[q],
// seg_ptr[q+1]), which lie in one run, and writes their sum to C tile
// seg_out[q] (the run's first segment; a run left whole is one segment)
// or, for seg_out[q] = -1 - w, to tile w of the workspace ws;
// tile_segment_sum_kernel then adds each split run's workspace tiles into
// its C tile.
struct SegmentStackJob {
    const int* seg_ptr;
    const int* seg_out;
    const int* a_idx;
    const int* b_idx;
    const int* a_chunks;
    const int* b_chunks;
    double* ws;

    template <typename Run>
    __device__ __forceinline__ void operator()(int64_t q, Run&& run) const
    {
        const int e0 = seg_ptr[q], e1 = seg_ptr[q + 1];
        run((int64_t)seg_out[q], e0, e1, stage_pairs(e0, e1, [job = *this](int e) {
            const int ia = job.a_idx[e], ib = job.b_idx[e];
            return make_int3(ia, ib, job.a_chunks[ia] & job.b_chunks[ib]);
        }));
    }
};

// Where a Job's slot lands: C's tile `slot`, or for a segmented stack a
// negative slot's workspace tile.
template <int T, typename Job>
__device__ __forceinline__ double* out_tile(const Job&, double* C, int64_t slot)
{
    return C + slot * (T * T);
}

template <int T>
__device__ __forceinline__ double* out_tile(const SegmentStackJob& job, double* C, int64_t slot)
{
    return slot >= 0 ? C + slot * (T * T) : job.ws + (-1 - slot) * (T * T);
}

// 64-bit tile offsets throughout: slot·T² crosses 2³¹ elements past 131,072
// tiles at T = 128.
template <typename In, int T, typename Job>
__global__ void __launch_bounds__(kThreads)
tile_run_kernel(const In* __restrict__ A, const In* __restrict__ B,
                typename AccOf<In>::type* __restrict__ C, const Job job)
{
    static_assert(T <= 32, "tile_run serves one whole tile a block here");
    job((int64_t)blockIdx.x, [&](int64_t slot, int e0, int e1, auto pair) {
        tile_run<In, T>(A, B, C + slot * (T * T), e0, e1, pair);
    });
}

template <typename In, int T, typename Job>
__global__ void __launch_bounds__(kThreads, 2)
tile_blocked_kernel(const In* __restrict__ A, const In* __restrict__ B,
                    float* __restrict__ C, const Job job)
{
    extern __shared__ __align__(16) unsigned char ring[];
    job((int64_t)blockIdx.x, [&](int64_t slot, int e0, int e1, auto pair) {
        tile_run_blocked_f32<In, T>(A, B, C + slot * (T * T), e0, e1, pair,
                                    reinterpret_cast<In*>(ring));
    });
}

template <int T, typename Job>
__global__ void __launch_bounds__(kThreads, T == 128 ? 1 : 2)
tile_mma_kernel(const double* __restrict__ A, const double* __restrict__ B,
                double* __restrict__ C, const Job job)
{
    extern __shared__ __align__(16) unsigned char ring[];
    job((int64_t)blockIdx.x, [&](int64_t slot, int e0, int e1, auto pair) {
        tile_run_mma_f64<T>(A, B, out_tile<T>(job, C, slot), e0, e1, pair,
                            reinterpret_cast<double*>(ring));
    });
}

// The fix-up of a segmented launch: C tile red_c[r] += workspace tiles
// red_ptr[r] .. red_ptr[r+1]-1 of split run r, one after another in
// segment order (a fixed order: two launches are bitwise equal). Block
// (r, y) takes kThreads double2 of the tile, 16 bytes a thread.
template <int T>
__global__ void __launch_bounds__(kThreads)
tile_segment_sum_kernel(double* __restrict__ C, const double* __restrict__ ws,
                        const int* __restrict__ red_c, const int* __restrict__ red_ptr)
{
    const int r = blockIdx.x;
    const int64_t i = (int64_t)blockIdx.y * kThreads + threadIdx.x;
    double2* c = reinterpret_cast<double2*>(C + (int64_t)red_c[r] * (T * T)) + i;
    double2 acc = *c;
    for (int w = red_ptr[r]; w < red_ptr[r + 1]; ++w) {
        const double2 p = reinterpret_cast<const double2*>(ws + (int64_t)w * (T * T))[i];
        acc.x += p.x;
        acc.y += p.y;
    }
    *c = acc;
}

template <int T, typename Job>
__global__ void __launch_bounds__(kThreads, T == 128 ? 1 : 2)
tile_c64_blocked_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                        float2* __restrict__ C, const Job job)
{
    extern __shared__ __align__(16) unsigned char ring[];
    job((int64_t)blockIdx.x, [&](int64_t slot, int e0, int e1, auto pair) {
        tile_run_blocked_c64<T>(A, B, C + slot * (T * T), e0, e1, pair,
                                reinterpret_cast<float2*>(ring));
    });
}

// kSplit blocks a C tile, block q taking rows of part q % kSplit of tile
// q / kSplit; no register cap below 255 (at T = 64 a cap of 128, two
// blocks an SM, spills)
template <int T, typename Job>
__global__ void __launch_bounds__(kThreads, 1)
tile_c128_mma_kernel(const double2* __restrict__ A, const double2* __restrict__ B,
                     double2* __restrict__ C, const Job job)
{
    extern __shared__ __align__(16) unsigned char ring[];
    constexpr int kSplit = MmaC128<T>::kSplit;
    const int part = (int)(blockIdx.x % kSplit);
    job((int64_t)(blockIdx.x / kSplit), [&](int64_t slot, int e0, int e1, auto pair) {
        tile_run_mma_c128<T>(A, B, C + slot * (T * T), e0, e1, pair,
                             reinterpret_cast<double2*>(ring), part);
    });
}

// One block per output tile, n_out of them (complex128 at T = 128: two a
// tile), through the routine for (In, T); returns a cudaError_t as int (an
// overflowing grid is refused).
template <typename In, int T, typename Job>
static int launch_tile_kernel(const In* A, const In* B, typename AccOf<In>::type* C,
                              long long n_out, const Job& job, cudaStream_t s)
{
    if (n_out > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const unsigned blocks = (unsigned)n_out;
    if constexpr (T < 64) {
        tile_run_kernel<In, T, Job><<<blocks, kThreads, 0, s>>>(A, B, C, job);
    } else if constexpr (std::is_same_v<In, float2>) {
        constexpr int smem = BlockedC64<T>::kSmemBytes;
        const int err = (int)cudaFuncSetAttribute(
            tile_c64_blocked_kernel<T, Job>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err) return err;
        tile_c64_blocked_kernel<T, Job><<<blocks, kThreads, smem, s>>>(A, B, C, job);
    } else if constexpr (std::is_same_v<In, double2>) {
        constexpr int smem = MmaC128<T>::kSmemBytes;
        constexpr long long split = MmaC128<T>::kSplit;
        if (n_out * split > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
        const int err = (int)cudaFuncSetAttribute(
            tile_c128_mma_kernel<T, Job>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err) return err;
        tile_c128_mma_kernel<T, Job><<<(unsigned)(n_out * split), kThreads, smem, s>>>(
            A, B, C, job);
    } else if constexpr (std::is_same_v<In, double>) {
        constexpr int smem = MmaF64<T>::kSmemBytes;
        const int err = (int)cudaFuncSetAttribute(
            tile_mma_kernel<T, Job>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err) return err;
        tile_mma_kernel<T, Job><<<blocks, kThreads, smem, s>>>(A, B, C, job);
    } else {
        constexpr int smem = BlockedF32<In, T>::kSmemBytes;
        const int err = (int)cudaFuncSetAttribute(
            tile_blocked_kernel<In, T, Job>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err) return err;
        tile_blocked_kernel<In, T, Job><<<blocks, kThreads, smem, s>>>(A, B, C, job);
    }
    return (int)cudaGetLastError();
}

// tile_segment_sum_kernel over n_split split runs of a T-edge stack.
template <int T>
static int launch_segment_sum(double* C, const double* ws, const int* red_c,
                              const int* red_ptr, long long n_split, cudaStream_t s)
{
    static_assert(T * T % (2 * kThreads) == 0, "whole double2 rows of blocks");
    if (n_split > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)n_split, T * T / (2 * kThreads));
    tile_segment_sum_kernel<T><<<grid, kThreads, 0, s>>>(C, ws, red_c, red_ptr);
    return (int)cudaGetLastError();
}

}  // namespace dbcsr_torch
