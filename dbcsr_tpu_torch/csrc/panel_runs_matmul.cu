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
// is ONE MXU issue of depth K = R·T over flat slabs — A stored as stacked
// transposed tiles, B copied into column-major order — because the per-entry
// issue path, not memory, bounds its panel kernel. A CUDA block has no issue
// slot to save: a run of R is R consecutive tile products accumulated in the
// same registers, which IS one product of depth R·T. So the port builds
// neither the transposed A slab nor the permuted B copy; the kernel expands
// each entry in place and reads B through cm_perm. One block owns a BM×BM
// sub-tile of one cell for its whole sum (quads, then pairs, then singles),
// so each C element is written once by one thread in a fixed order: no
// atomics, two launches bitwise equal. The clamped last group re-covers slots
// of its predecessor; as in K2 a slot s of group g is skipped when s < g·c_win.
//
// What bounds it on an H100: as K1/K2 (tile_product.cuh), compute-bound on
// FFMA issue and shared-memory reads. The sum order differs from K2's
// (entries re-sorted by A slot, three tiers), so K3 is held to its own plain
// version within a tolerance, not bitwise to K2.
#include "tile_product.cuh"

namespace dbcsr_torch {

struct RunPlanArrays {
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
};

template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
panel_runs_matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
                         float* __restrict__ C, RunPlanArrays p, int c_win,
                         int runlen)
{
    using S = SubTile<T>;
    constexpr int NS = T / S::BM;
    const int64_t cell = blockIdx.x / S::kPerTile;  // (group, local slot)
    const int sub = blockIdx.x % S::kPerTile;
    const int g = (int)(cell / c_win);
    const int slot = p.gstart[g] + (int)(cell % c_win);
    if (slot < g * c_win) return;  // clamped last group: owned by group g-1
    const int r0 = (sub / NS) * S::BM, c0 = (sub % NS) * S::BM;
    const int alo = p.a_lo[g], blo = p.b_lo[g];
    const int q0 = p.obq[cell], nq = (p.obq[cell + 1] - q0) * runlen;
    const int p0 = p.obp[cell], np = (p.obp[cell + 1] - p0) * 2;
    const int s0 = p.obs[cell], ns = p.obs[cell + 1] - s0;
    // v runs over the cell's tile products: quads expanded, then pairs, then
    // singles
    tile_run<In, T, S::BM>(
        A, B, C + (int64_t)slot * (T * T), r0, c0, 0, nq + np + ns,
        [=](int v) {
            int packed, r;
            if (v < nq) {
                packed = p.qent[q0 + v / runlen];
                r = v % runlen;
            } else if (v < nq + np) {
                packed = p.pent[p0 + (v - nq) / 2];
                r = (v - nq) % 2;
            } else {
                packed = p.sent[s0 + (v - nq - np)];
                r = 0;
            }
            const int sb = blo + (packed & 0xFFFF) + r;
            return make_int2(alo + (packed >> 16) + r,
                             p.cm_perm ? p.cm_perm[sb] : sb);
        });
}

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
    const RunPlanArrays p{ip(gstart), ip(a_lo), ip(b_lo), ip(obq), ip(qent),
                          ip(obp), ip(pent), ip(obs), ip(sent), ip(cm_perm)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<false>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        const unsigned blocks = tile_grid<T>(n_cells);
        if (!blocks) return (int)cudaErrorInvalidConfiguration;
        panel_runs_matmul_kernel<In, T><<<blocks, kThreads, 0, s>>>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<float*>(c), p, c_win, runlen);
        return (int)cudaGetLastError();
    });
}
