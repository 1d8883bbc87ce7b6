// K2, the panel kernel: evaluates a PanelPlan (dbcsr_tpu_torch/mm/panel.py).
//
// Replaces the TPU kernel dbcsr_tpu/mm/panel.py:_panel_kernel (launched by
// _panel_launch / tile_stack_matmul_panel). On the TPU each group of c_win
// consecutive C slots DMAs its A and B slab spans into double-buffered VMEM
// caches and revisits them from there. On an H100 a block has at most
// 227 KB of shared memory (three bf16 128² tiles), so the slab caches do not
// carry over; L2 takes their place. The block for (group g, local slot l,
// BM×BM sub-tile) walks entries [obounds[g·c_win+l], obounds[g·c_win+l+1]),
// decodes sa = e>>16, sb = e&0xFFFF, reads A[a_lo[g]+sa] and B[b_lo[g]+sb]
// and writes C[gstart[g]+l]. Consecutive blocks belong to the same or the
// neighbouring group, whose slabs overlap, so the group's A/B tiles are
// served from the 50 MB L2 instead of HBM — the reuse the VMEM caches bought.
//
// The last group's window is clamped to end at n_c (gstart is clamped), so it
// re-covers slots of its predecessor. Only the group whose window first
// reaches a slot writes it: a slot s of group g is skipped when s < g·c_win.
// Every C tile is therefore written exactly once.
//
// What bounds it: the same shared routine as K1 (tile_product.cuh), so the
// same compute bound (FFMA issue, shared-memory reads); its sums run in the
// same order as K1's on the same stack, so the two agree bitwise.
#include "tile_product.cuh"

namespace dbcsr_torch {

template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
panel_matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
                    float* __restrict__ C, const int* __restrict__ gstart,
                    const int* __restrict__ a_lo, const int* __restrict__ b_lo,
                    const int* __restrict__ obounds,
                    const int* __restrict__ entries, int c_win)
{
    using S = SubTile<T>;
    constexpr int NS = T / S::BM;
    const int64_t q = blockIdx.x / S::kPerTile;  // (group, local slot)
    const int sub = blockIdx.x % S::kPerTile;
    const int g = (int)(q / c_win);
    const int slot = gstart[g] + (int)(q % c_win);
    if (slot < g * c_win) return;  // clamped last group: owned by group g-1
    const int r0 = (sub / NS) * S::BM, c0 = (sub % NS) * S::BM;
    const int alo = a_lo[g], blo = b_lo[g];
    tile_run<In, T, S::BM>(
        A, B, C + (int64_t)slot * (T * T), r0, c0, obounds[q], obounds[q + 1],
        [=](int e) {
            const int packed = entries[e];
            return make_int2(alo + (packed >> 16), blo + (packed & 0xFFFF));
        });
}

}  // namespace dbcsr_torch

// n_slots = n_groups · c_win (the plan's obounds has n_slots + 1 entries).
extern "C" int dbcsr_torch_panel_matmul(
    const void* a, const void* b, void* c, const void* gstart,
    const void* a_lo, const void* b_lo, const void* obounds,
    const void* entries, long long n_slots, int c_win, int tile, int dtype,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_slots <= 0) return 0;
    const int* gs = static_cast<const int*>(gstart);
    const int* al = static_cast<const int*>(a_lo);
    const int* bl = static_cast<const int*>(b_lo);
    const int* ob = static_cast<const int*>(obounds);
    const int* en = static_cast<const int*>(entries);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<false>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        const unsigned blocks = tile_grid<T>(n_slots);
        if (!blocks) return (int)cudaErrorInvalidConfiguration;
        panel_matmul_kernel<In, T><<<blocks, kThreads, 0, s>>>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<float*>(c), gs, al, bl, ob, en, c_win);
        return (int)cudaGetLastError();
    });
}
