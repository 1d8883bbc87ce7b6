// K2, the panel kernel: evaluates a PanelPlan (dbcsr_tpu_torch/mm/panel.py).
//
// Replaces the TPU kernel dbcsr_tpu/mm/panel.py:_panel_kernel (launched by
// _panel_launch / tile_stack_matmul_panel). On the TPU each group of c_win
// consecutive C slots DMAs its A and B slab spans into double-buffered VMEM
// caches and revisits them from there. On an H100 a block has at most
// 227 KB of shared memory (three bf16 128² tiles), so the slab caches do not
// carry over; L2 takes their place. The block for (group g, local slot l)
// walks entries [obounds[g·c_win+l], obounds[g·c_win+l+1]), decodes
// sa = e>>16, sb = e&0xFFFF, reads A[a_lo[g]+sa] and B[b_lo[g]+sb] and writes
// C[gstart[g]+l]. Consecutive blocks belong to the same or the neighbouring
// group, whose slabs overlap, so the group's A/B tiles are served from the
// 50 MB L2 instead of HBM — the reuse the VMEM caches bought.
//
// The last group's window is clamped to end at n_c (gstart is clamped), so it
// re-covers slots of its predecessor. Only the group whose window first
// reaches a slot writes it: a slot s of group g is skipped when s < g·c_win.
// Every C tile is therefore written exactly once.
//
// What bounds it: operations, at the IEEE FFMA rate (67 TFLOP/s; float32 at
// "highest" has no tensor-core route, and bf16 slabs are widened to float32
// so that every product is exact). T = 128 and T = 64, float32 and bf16,
// run the register-blocked, pipelined routine of tile_product_f32.cuh: one
// block of 256 threads per C tile, an 8×8 (T = 64: 4×4) micro-tile a thread
// read with 128-bit shared-memory loads, K chunks of 32 brought by cp.async
// into a three-slot ring of dynamic shared memory that runs across the
// entries of the run; 104,448 bytes (bf16: 55,296) and 128 registers a
// thread at T = 128, two blocks an SM, no spills. T = 16 and T = 32 keep tile_run of tile_product.cuh. Either
// way each C element is one FFMA chain over the run in stack order and
// ascending k, which is K1's chain: the two kernels agree bitwise on the same
// stack.
#include "tile_kernel.cuh"

namespace dbcsr_torch {

// Block q is (group g, local slot l) = (q / c_win, q % c_win): it owns C slot
// gstart[g] + l unless the clamped last group re-covers a slot of its
// predecessor, walks entries [obounds[q], obounds[q+1]) and decodes entry e
// as (A slot a_lo[g] + (e >> 16), B slot b_lo[g] + (e & 0xFFFF)).
struct PanelJob {
    const int* gstart;
    const int* a_lo;
    const int* b_lo;
    const int* obounds;
    const int* entries;
    int c_win;

    template <typename Run>
    __device__ __forceinline__ void operator()(int64_t q, Run&& run) const
    {
        const int g = (int)(q / c_win);
        const int slot = gstart[g] + (int)(q % c_win);
        if (slot < g * c_win) return;  // clamped last group: owned by group g-1
        const int* en = entries;
        const int alo = a_lo[g], blo = b_lo[g];
        run(slot, obounds[q], obounds[q + 1], [=](int e) {
            const int packed = en[e];
            return make_int2(alo + (packed >> 16), blo + (packed & 0xFFFF));
        });
    }
};

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
    const PanelJob job{static_cast<const int*>(gstart), static_cast<const int*>(a_lo),
                       static_cast<const int*>(b_lo), static_cast<const int*>(obounds),
                       static_cast<const int*>(entries), c_win};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<false>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<In, T>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<float*>(c), n_slots, job, s);
    });
}
