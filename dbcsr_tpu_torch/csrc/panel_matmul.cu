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
#include "tile_product_f32.cuh"

namespace dbcsr_torch {

// entry e of group g -> (A slot, B slot)
struct PanelPair {
    const int* entries;
    int alo, blo;
    __device__ __forceinline__ int2 operator()(int e) const
    {
        const int packed = entries[e];
        return make_int2(alo + (packed >> 16), blo + (packed & 0xFFFF));
    }
};

// T = 16, 32: one block per (group, local slot)
template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
panel_matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
                    float* __restrict__ C, const int* __restrict__ gstart,
                    const int* __restrict__ a_lo, const int* __restrict__ b_lo,
                    const int* __restrict__ obounds,
                    const int* __restrict__ entries, int c_win)
{
    static_assert(SubTile<T>::kPerTile == 1, "tile_run serves T <= 32 here");
    const int64_t q = blockIdx.x;  // (group, local slot)
    const int g = (int)(q / c_win);
    const int slot = gstart[g] + (int)(q % c_win);
    if (slot < g * c_win) return;  // clamped last group: owned by group g-1
    tile_run<In, T, T>(
        A, B, C + (int64_t)slot * (T * T), 0, 0, obounds[q], obounds[q + 1],
        PanelPair{entries, a_lo[g], b_lo[g]});
}

// T = 64, 128: one block per (group, local slot), the blocked routine
template <typename In, int T>
__global__ void __launch_bounds__(kThreads, 2)
panel_matmul_blocked_kernel(const In* __restrict__ A, const In* __restrict__ B,
                            float* __restrict__ C, const int* __restrict__ gstart,
                            const int* __restrict__ a_lo, const int* __restrict__ b_lo,
                            const int* __restrict__ obounds,
                            const int* __restrict__ entries, int c_win)
{
    extern __shared__ __align__(16) unsigned char ring[];
    const int64_t q = blockIdx.x;
    const int g = (int)(q / c_win);
    const int slot = gstart[g] + (int)(q % c_win);
    if (slot < g * c_win) return;  // block-uniform, before any barrier
    tile_run_blocked_f32<In, T>(
        A, B, C + (int64_t)slot * (T * T), obounds[q], obounds[q + 1],
        PanelPair{entries, a_lo[g], b_lo[g]}, reinterpret_cast<In*>(ring));
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
    if (n_slots > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const int* gs = static_cast<const int*>(gstart);
    const int* al = static_cast<const int*>(a_lo);
    const int* bl = static_cast<const int*>(b_lo);
    const int* ob = static_cast<const int*>(obounds);
    const int* en = static_cast<const int*>(entries);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = (unsigned)n_slots;
    return dispatch<false>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        const In* A = static_cast<const In*>(a);
        const In* B = static_cast<const In*>(b);
        float* C = static_cast<float*>(c);
        if constexpr (T >= 64) {
            constexpr int smem = BlockedF32<In, T>::kSmemBytes;
            // above the 48 KB static limit at T = 128: opt in (per device, so
            // on every call)
            err = (int)cudaFuncSetAttribute(panel_matmul_blocked_kernel<In, T>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err) return err;
            panel_matmul_blocked_kernel<In, T><<<blocks, kThreads, smem, s>>>(
                A, B, C, gs, al, bl, ob, en, c_win);
        } else {
            panel_matmul_kernel<In, T><<<blocks, kThreads, 0, s>>>(
                A, B, C, gs, al, bl, ob, en, c_win);
        }
        return (int)cudaGetLastError();
    });
}
