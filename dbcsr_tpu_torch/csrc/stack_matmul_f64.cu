// The float64 stack kernel: C[c] = Σ_{e in run c} A[a_idx[e]] @ B[b_idx[e]]
// with float64 inputs, float64 products and float64 sums.
//
// Replaces the TPU kernel dbcsr_tpu/mm/ozaki_panel.py:_ozaki_panel_kernel
// (launched by _ozaki_panel_launch / tile_stack_matmul_ozaki_panel), and with
// it the XLA twin that the JAX package takes where that kernel is not
// admitted (dbcsr_tpu/ops/f64_emu.py:tile_stack_matmul_ozaki). The TPU has no
// float64 unit, so K6 cuts each operand into 8 bf16 slices of 7 bits, runs
// 36 slice-pair dots that are exact in f32 and folds them with a TwoSum
// cascade into three f32 planes; that scheme admits only T = 128 and at most
// 8 entries per C tile (the f32 exactness bound). The H100 computes float64
// natively, so none of the slicing carries over: this kernel reads the same
// c-sorted stack as K1 (run offsets c_ptr[n_c+1], a/b columns), takes every
// T in KERNEL_TILES and runs of any length. One block owns its output
// region, walks its run in stack order and writes it once, with no atomics:
// two launches are bitwise equal.
//
// What bounds it on an H100: each stack entry reads one A and one B tile and
// does 2·T³ flops — at T=128 in f64, 256 KB for 4.2 MFLOP, 16 flop/byte.
// That is under the tensor cores' HBM ridge (67 TFLOP/s over 3.35 TB/s = 20
// flop/byte), but neighbouring C tiles of a banded stack share their tiles
// through the 50 MB L2, and reading each tile once takes half the time of
// the operations. So it is bound by operations at the FP64 tensor-core rate,
// and next by what L2 can deliver (4 TB/s at that rate).
//
// On atom-block patterns most of those operations multiply padding: a
// 128-row tile of liquid water holds some 17 atoms of 5 and 13 rows at
// random places, and most of a tile product's K range is empty in A's
// columns or in B's rows (the water benchmark issued 77× the work its
// blocks need, at 71% of the FP64 peak). So the stack may carry, for every
// A and B tile, a mask of the mma depths (8 columns of A, 8 rows of B) that
// hold a stored block, built on the host from the block index
// (mm/f64_stack.py); at T = 64 and 128 the kernel then copies only the K
// chunks with a depth set in both tiles of an entry and issues only those
// depths (SegmentStackJob, tile_ring.cuh). The depths it skips hold exact
// zeros by the store invariant, so the result equals the unmasked launch
// up to the sign of a zero. What bounds it then is still the tensor cores
// on the depths it issues, and next the copies of the 16-deep chunks, of
// which one depth may be empty.
//
// Run segments (T = 64 and 128): one block a C tile leaves the card idle
// behind a few long runs. RI-HFX's K += X·B has 144 C tiles, each a run of
// 713 to 3,650 entries, on 132 SMs at one block an SM: the longest run set
// the time while most SMs waited. So a masked stack comes with a segment
// table, planned on the host from each entry's issued depths
// (mm/f64_stack.py): a run whose issued work passes W / (4·S) (W the
// launch's work, S the card's SMs) is cut at entry boundaries into segments
// of about equal work, one block each, where a list schedule of the blocks
// over the SMs says the cut saves more than the fix-up costs (not for whole
// waves of equal runs, nor for runs of about an entry); every other run is
// one segment. A
// run's first segment writes its C tile, every other one a tile of a
// float64 workspace of fewer than 4·S tiles, and tile_segment_sum_kernel
// then adds each split run's workspace tiles into its C tile in segment
// order (no atomics; two launches are bitwise equal; a split run differs
// from the unsplit one by rounding alone). What bounds a segmented launch
// is the longest segment against W / S (at most 1.25·W/S on a list
// schedule), and next the fix-up's bytes: each workspace tile read once,
// each split C tile read and written once (≤ 4·S + 2·n_split tiles, under
// 0.1 GB at T = 128). A stack whose runs all stay under W / (4·S) (the
// water SCF products: 134,448 runs, the longest 0.27 GFLOP against W/S =
// 30.6 GFLOP) has a table of one segment a run, the kernel's blocks as
// before, and no fix-up.
//
// T = 128 and T = 64 run on the FP64 tensor cores: one block of 256 threads
// per C tile (or segment), mma.sync m16n8k8 over 64×32 (T = 64: 32×16) warp
// tiles held in registers, K chunks of 16 brought by cp.async into a four-slot ring of
// dynamic shared memory that runs across the entries of the run
// (tile_mma_f64.cuh has the layout; T = 128: 164,864 bytes, 218 registers
// a thread and one block an SM, T = 64: 82,944 bytes, 91 registers and two;
// no spills). Sums inside one mma are taken in the
// hardware's order, so the result agrees with a DFMA chain to rounding
// (1e-12 of the largest entry), not bitwise.
//
// T = 16 and T = 32 keep the DFMA routine tile_run<double> of
// tile_product.cuh (one block per tile, 16×16 threads, a 1×1 or 2×2
// micro-tile): a 16-row mma tile spread over 8 warps reuses nothing there.
#include "tile_kernel.cuh"

// a_chunks, b_chunks, seg_ptr, seg_out, ws: the K occupancy of every A and
// B tile and the run segments (SegmentStackJob in tile_kernel.cuh), n_seg
// of them, with the fix-up after (dbcsr_torch_segment_sum_f64); all given
// at T = 64 and 128, where the tensor-core routine can skip a depth, or all
// null to multiply every chunk of one block a C tile. ws may be null where
// no run is split.
extern "C" int dbcsr_torch_stack_matmul_f64(
    const void* a, const void* b, void* c, const void* c_ptr,
    const void* a_idx, const void* b_idx, const void* a_chunks, const void* b_chunks,
    const void* seg_ptr, const void* seg_out, void* ws,
    long long n_c, long long n_seg, int tile, int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const StackJob job{static_cast<const int*>(c_ptr), static_cast<const int*>(a_idx),
                       static_cast<const int*>(b_idx)};
    const SegmentStackJob seg_job{static_cast<const int*>(seg_ptr),
                                  static_cast<const int*>(seg_out), job.a_idx, job.b_idx,
                                  static_cast<const int*>(a_chunks),
                                  static_cast<const int*>(b_chunks), static_cast<double*>(ws)};
    const bool segmented = seg_ptr && seg_out && a_chunks && b_chunks;
    if (!segmented && (seg_ptr || seg_out || a_chunks || b_chunks))
        return (int)cudaErrorInvalidValue;
    if (segmented && tile != 64 && tile != 128) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_tile<double>(tile, [&](auto, auto tile_tag) {
        constexpr int T = decltype(tile_tag)::value;
        auto launch = [&](long long n_out, const auto& with) {
            return launch_tile_kernel<double, T>(
                static_cast<const double*>(a), static_cast<const double*>(b),
                static_cast<double*>(c), n_out, with, s);
        };
        if constexpr (T >= 64) {
            if (segmented) return launch(n_seg, seg_job);
        }
        return launch(n_c, job);
    });
}
// The fix-up of a segmented launch: C tile red_c[r] += workspace tiles
// [red_ptr[r], red_ptr[r+1]) in order, for the n_split split runs.
extern "C" int dbcsr_torch_segment_sum_f64(
    void* c, const void* ws, const void* red_c, const void* red_ptr,
    long long n_split, int tile, int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_split <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* C = static_cast<double*>(c);
    const auto* W = static_cast<const double*>(ws);
    const auto* rc = static_cast<const int*>(red_c);
    const auto* rp = static_cast<const int*>(red_ptr);
    if (tile == 128) return launch_segment_sum<128>(C, W, rc, rp, n_split, s);
    if (tile == 64) return launch_segment_sum<64>(C, W, rc, rp, n_split, s);
    return (int)cudaErrorInvalidValue;
}
