// K4, the grouped kernel: evaluates the group plan of
// dbcsr_tpu_torch/mm/kernels.py:_plan_groups. The c-sorted stack is cut into
// groups of at most `group` (≤ 8) output rows whose distinct A tiles fit
// `cache` (≤ 256) slots; entry e of a group is packed
// [out_local:3][a_slot:8][b_tile:20] and multiplies
// A[aload[abounds[g] + a_slot]] with B[b_tile] into row g·group + out_local
// of a [n_groups·group, T, T] output. A C run split across groups leaves
// partial sums in several rows, which the wrapper joins with its ordered
// segment sum; padding rows come out zero.
//
// Replaces the TPU kernel dbcsr_tpu/mm/kernels.py:_grouped_kernel (launched
// by _grouped_launch / tile_stack_matmul_grouped). On the TPU one grid step
// per group DMAs the group's distinct A tiles into a VMEM cache once, streams
// B tiles through a ring of `ring` buffers, and accumulates the group's rows
// in the pipelined output window, one MXU dot per entry in stack order. The
// cache and the ring exist to hide DMA latency under the MXU on one core;
// here blocks run in parallel and L2 serves the reuse: the blocks of one
// group read the same few A tiles at about the same time. A group's entries
// stay c-sorted, so the entries of one output row are contiguous: the host
// derives per-row entry bounds once (lbounds), and one block owns a BM×BM
// sub-tile of one row for its whole sum, walking [lbounds[q], lbounds[q+1])
// in stack order. Every output element is written once, by one thread, in a
// fixed order: no atomics, two launches bitwise equal.
//
// What bounds it on an H100: as K1 (tile_product.cuh), compute-bound on FFMA
// (DFMA for double) issue and shared-memory reads; the padded output
// (n_groups·group rows) and, when runs are split, the segment-sum pass add
// memory traffic that K1 does not have.
#include "tile_product.cuh"

namespace dbcsr_torch {

constexpr int kBBits = 20;  // entry packing, as _plan_groups

template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
                      typename AccOf<In>::type* __restrict__ C,
                      const int* __restrict__ lbounds,
                      const int* __restrict__ abounds,
                      const int* __restrict__ aload,
                      const int* __restrict__ entries, int group)
{
    using S = SubTile<T>;
    constexpr int NS = T / S::BM;
    const int64_t q = blockIdx.x / S::kPerTile;  // output row: (group, local)
    const int sub = blockIdx.x % S::kPerTile;
    const int r0 = (sub / NS) * S::BM, c0 = (sub % NS) * S::BM;
    const int* slots = aload + abounds[q / group];
    tile_run<In, T, S::BM>(
        A, B, C + q * (T * T), r0, c0, lbounds[q], lbounds[q + 1],
        [=](int e) {
            const int packed = entries[e];
            return make_int2(slots[(packed >> kBBits) & 0xFF],
                             packed & ((1 << kBBits) - 1));
        });
}

}  // namespace dbcsr_torch

// n_rows = n_groups · group (lbounds has n_rows + 1 entries).
// dtype: 0 f32, 1 bf16 (both with f32 output), 2 f64 (f64 output).
extern "C" int dbcsr_torch_grouped_matmul(
    const void* a, const void* b, void* c, const void* lbounds,
    const void* abounds, const void* aload, const void* entries,
    long long n_rows, int group, int tile, int dtype, int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_rows <= 0) return 0;
    const int* lb = static_cast<const int*>(lbounds);
    const int* ab = static_cast<const int*>(abounds);
    const int* al = static_cast<const int*>(aload);
    const int* en = static_cast<const int*>(entries);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<true>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        using Acc = typename AccOf<In>::type;
        constexpr int T = decltype(tile_tag)::value;
        const unsigned blocks = tile_grid<T>(n_rows);
        if (!blocks) return (int)cudaErrorInvalidConfiguration;
        grouped_matmul_kernel<In, T><<<blocks, kThreads, 0, s>>>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<Acc*>(c), lb, ab, al, en, group);
        return (int)cudaGetLastError();
    });
}
