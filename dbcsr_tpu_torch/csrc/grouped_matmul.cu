// K4, the grouped kernel: evaluates the group plan of
// dbcsr_tpu_torch/mm/kernels.py:_plan_groups. The c-sorted stack is cut into
// groups of at most `group` (≤ 8) output rows whose distinct A tiles fit
// `cache` (≤ 256) slots; entry e of a group is packed
// [out_local:3][a_slot:8][b_tile:20] and multiplies
// A[aload[abounds[g] + a_slot]] with B[b_tile] into output row
// q = g·group + out_local.
//
// Replaces the TPU kernel dbcsr_tpu/mm/kernels.py:_grouped_kernel (launched
// by _grouped_launch / tile_stack_matmul_grouped). On the TPU one grid step
// per group DMAs the group's distinct A tiles into a VMEM cache once, streams
// B tiles through a ring of `ring` buffers, and accumulates the group's rows
// in the pipelined output window, one MXU dot per entry in stack order. The
// cache and the ring exist to hide DMA latency under the MXU on one core;
// here the blocks of one group run at about the same time and read the same
// few A tiles, so L2 serves that reuse. A shared-memory A cache is not built:
// one float32 A tile at T = 128 is 64 KiB, and beside the cp.async ring
// (104,448 bytes) the 227 KB a block may take hold one such tile, of a group
// that reads dozens. A group's entries stay c-sorted, so the entries of one
// output row are contiguous: the host derives per-row entry bounds once
// (lbounds), and one block of 256 threads owns one row for its whole sum,
// walking [lbounds[q], lbounds[q+1]) in stack order.
//
// The kernel writes where the row → slot map out_slot[q] says. When no C run
// is split across groups (every C slot has at most one row: the case whenever
// a group's A tiles fit the cache), out_slot[q] is the row's C slot and the
// kernel writes the [n_c, T, T] C store itself: no padded copy of C, no join.
// A padding row has out_slot[q] < 0 and its block returns at once. When a run
// is split, out_slot is the identity over a padded [n_groups·group, T, T]
// array, padding rows come out zero, and the wrapper joins the partial sums
// with its ordered segment sum. Either way every output element is written
// once, by one thread, in a fixed order: no atomics, two launches bitwise
// equal.
//
// What bounds it on an H100: operations, as K1 (stack_matmul.cu). The routine
// is chosen in tile_kernel.cuh: float32 and bf16 at T = 128/64 run the
// register-blocked, pipelined FFMA routine of tile_product_f32.cuh (the same
// FFMA chain per C element as K1's and K2's, so the three agree bitwise where
// no run is split); float64 at T = 128/64 runs mma.sync m16n8k8 on the FP64
// tensor cores (tile_mma_f64.cuh; sums inside one mma in the hardware's
// order, so it agrees with the float64 stack kernel bitwise and with a DFMA
// chain to 1e-12); T = 16 and T = 32 keep tile_run of tile_product.cuh.
#include "tile_kernel.cuh"

namespace dbcsr_torch {

constexpr int kBBits = 20;  // entry packing, as _plan_groups

struct GroupedJob {
    const int* lbounds;
    const int* abounds;
    const int* aload;
    const int* entries;
    const int* out_slot;
    int group;

    template <typename Run>
    __device__ __forceinline__ void operator()(int64_t q, Run&& run) const
    {
        const int slot = out_slot[q];
        if (slot < 0) return;  // padding row of a plan that writes the C store
        const int* slots = aload + abounds[q / group];
        const int* en = entries;
        run(slot, lbounds[q], lbounds[q + 1], [=](int e) {
            const int packed = en[e];
            return make_int2(slots[(packed >> kBBits) & 0xFF],
                             packed & ((1 << kBBits) - 1));
        });
    }
};

}  // namespace dbcsr_torch

// n_rows = n_groups · group (lbounds has n_rows + 1 entries, out_slot n_rows).
// dtype: 0 f32, 1 bf16 (both with f32 output), 2 f64 (f64 output).
extern "C" int dbcsr_torch_grouped_matmul(
    const void* a, const void* b, void* c, const void* lbounds,
    const void* abounds, const void* aload, const void* entries,
    const void* out_slot, long long n_rows, int group, int tile, int dtype,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_rows <= 0) return 0;
    const GroupedJob job{static_cast<const int*>(lbounds), static_cast<const int*>(abounds),
                         static_cast<const int*>(aload), static_cast<const int*>(entries),
                         static_cast<const int*>(out_slot), group};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<true>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        using Acc = typename AccOf<In>::type;
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<In, T>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<Acc*>(c), n_rows, job, s);
    });
}
