// K3, the run-fused panel kernel: evaluates a PanelRunPlan
// (dbcsr_tpu_torch/mm/panel.py:plan_panel_runs). As in K2 the stack is cut
// into groups of c_win consecutive C slots with A and B slot spans starting
// at a_lo[g], b_lo[g] — B in COLUMN-major slot numbering, cm_perm mapping a
// column-major position to the store slot. Within a (group, C slot) cell the
// entries are sorted by A slot and cut into runs of consecutive (A slot,
// column-major B position) pairs; an entry (sa, sb) of length R stands for
//   Σ_{r<R} A[a_lo[g] + sa + r] @ B[cm_perm[b_lo[g] + sb + r]].
// A cell holds three tiers, summed in this order: quads (R = runlen, qent /
// obq), pairs (R = 2, pent / obp; empty when runlen == 2) and singles (R = 1,
// sent / obs).
//
// Replaces the TPU kernel dbcsr_tpu/mm/panel.py:_panel_run_kernel (launched
// by _panel_run_launch / tile_stack_matmul_panel_runs). On the TPU a run of R
// is ONE MXU dot of depth K = R·T over flat slabs — A stored as stacked
// transposed tiles, B copied into column-major order — because the per-entry
// dispatch, not memory, bounds its panel kernel. A CUDA block has no dispatch
// to save: a run of R is R consecutive tile products in the same registers,
// which IS one product of depth R·T. So the port builds neither slab; the
// kernel expands each entry and reads B through cm_perm. One block owns one
// cell for its whole sum (quads, pairs, singles), so each C element is
// written once by one thread in a fixed order: no atomics, two launches
// bitwise equal. A slot s of the clamped last group g is skipped when
// s < g·c_win (its predecessor owns it), as in K2.
//
// What bounds it on an H100: operations, as K1 (stack_matmul.cu). At T =
// 128/64 it runs the blocked FFMA routine of tile_product_f32.cuh, whose ring
// runs on from one tile product into the next, so a run of R costs one
// pipeline fill; tile_run at T = 16/32. The sum order differs from K2's
// (entries re-sorted by A slot, three tiers): K3 is held to its own plain
// version, and bitwise to K1 on panel.panel_runs_owned_stack.
#include "tile_kernel.cuh"

namespace dbcsr_torch {

struct PanelRunJob {
    const int* gstart;
    const int* a_lo;
    const int* b_lo;
    const int* obq;
    const int* qent;
    const int* obp;
    const int* pent;
    const int* obs;
    const int* sent;
    const int* cm_perm;  // null: the B store is already in column-major order
    int c_win, runlen;

    template <typename Run>
    __device__ __forceinline__ void operator()(int64_t cell, Run&& run) const
    {
        const int g = (int)(cell / c_win);  // (group, local slot)
        const int slot = gstart[g] + (int)(cell % c_win);
        if (slot < g * c_win) return;  // clamped last group: owned by group g-1
        const int c = (int)cell;
        const int n = (obq[c + 1] - obq[c]) * runlen + (obp[c + 1] - obp[c]) * 2
                      + obs[c + 1] - obs[c];
        // v runs over the cell's tile products: quads expanded, then pairs,
        // then singles. Inlined in the ring loop this expansion made the
        // float32 T = 128 instantiation spill, so it is staged (stage_pairs).
        run(slot, 0, n, stage_pairs(0, n, [job = *this, c, g](int v) {
            const int q0 = job.obq[c], nq = (job.obq[c + 1] - q0) * job.runlen;
            int packed, r;
            if (v < nq) {
                packed = job.qent[q0 + v / job.runlen];
                r = v % job.runlen;
            } else {
                const int p0 = job.obp[c], np = (job.obp[c + 1] - p0) * 2;
                const int w = v - nq;
                if (w < np) {
                    packed = job.pent[p0 + (w >> 1)];
                    r = w & 1;
                } else {
                    packed = job.sent[job.obs[c] + w - np];
                    r = 0;
                }
            }
            const int sb = job.b_lo[g] + (packed & 0xFFFF) + r;
            return make_int2(job.a_lo[g] + (packed >> 16) + r,
                             job.cm_perm ? job.cm_perm[sb] : sb);
        }));
    }
};

}  // namespace dbcsr_torch

// n_cells = n_groups · c_win (obq, obp and obs have n_cells + 1 entries).
// dtype: 0 f32, 1 bf16; the output is f32.
extern "C" int dbcsr_torch_panel_runs_matmul(
    const void* a, const void* b, void* c, const void* gstart,
    const void* a_lo, const void* b_lo, const void* obq, const void* qent,
    const void* obp, const void* pent, const void* obs, const void* sent,
    const void* cm_perm, long long n_cells, int c_win, int runlen, int tile,
    int dtype, int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_cells <= 0) return 0;
    if (runlen < 2) return (int)cudaErrorInvalidValue;
    auto ip = [](const void* x) { return static_cast<const int*>(x); };
    const PanelRunJob job{ip(gstart), ip(a_lo), ip(b_lo), ip(obq), ip(qent),
                          ip(obp), ip(pent), ip(obs), ip(sent), ip(cm_perm),
                          c_win, runlen};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<false>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<In, T>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<float*>(c), n_cells, job, s);
    });
}
