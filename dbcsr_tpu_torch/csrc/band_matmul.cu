// K5, the band kernel: the tile-diagonal convolution of a BandPlan
// (dbcsr_tpu_torch/mm/band.py),
//   C[dc, m] = Σ_{d1} A[d1, m] @ B[dc - d1, m + off_a + d1],
// over the diagonals d1 of A's band [Wa, Mt] and d2 = dc - d1 of B's band
// [Wb, Kt], absent tiles counting as zero tiles.
//
// Replaces the TPU kernel dbcsr_tpu/mm/band.py:_band_row_kernel (launched by
// _band_product_pallas / band_matmul_pallas). On the TPU the grid walks the
// tile rows m in order, A's diagonal window arrives through the pipeline, B's
// wide rows [T, Wb·T] ride a ring of Wa+1 VMEM buffers that slides by one row
// per step, and each step issues Wa wide MXU products over every cell of the
// band, present or not; the operands are first packed into dense diagonal
// arrays (two gathers and a padded, shift-aligned copy of B). None of that
// carries over: blocks run in no order, so nothing slides, and a wide product
// buys nothing without an MXU. Here one block owns one PRESENT output tile —
// the i-th of the result, at band position c_unpack[i] = dc·Mt + m — and sums
// over d1 ascending (the TPU kernel's and the plain version's order), reading
// the tile stores through a_pack[d1·Mt + m] and b_pack[d2·Kt + k], k = m +
// off_a + d1. A -1 slot or a k outside [0, Kt) is a zero tile and is skipped,
// so the kernel does the products that exist, not the padded Wa·Wb·Mt, moves
// no packed copy and writes the result in c_unpack order. Each output element
// is summed by one thread in a fixed order and written once (a tile whose
// cells are all absent comes out zero): no atomics, two launches bitwise equal.
//
// What bounds it on an H100: operations, as K1 (stack_matmul.cu). The routine
// is chosen in tile_kernel.cuh: at T = 128/64 the blocked FFMA routine for
// float32 and bf16 (K1's chain per C element, so K5 equals K1 bitwise on the
// band's flat stack) and mma.sync m16n8k8 on the FP64 tensor cores for
// float64 (bitwise the float64 stack kernel's sums); tile_run at T = 16/32.
// The run's slots are looked up by the block's threads at once (stage_pairs):
// no pack-map load and no absent cell's latency sits in the ring loop. The
// Wa+Wb tiles a block row touches are shared with the neighbouring rows'
// blocks through L2, the reuse the sliding ring bought on the TPU.
#include "tile_kernel.cuh"

namespace dbcsr_torch {

struct BandJob {
    const int* a_pack;
    const int* b_pack;
    const int* c_unpack;
    int wa, wb, mt, kt, off_a;

    template <typename Run>
    __device__ __forceinline__ void operator()(int64_t i, Run&& run) const
    {
        const int pos = c_unpack[i];
        const int dc = pos / mt, m = pos % mt;  // once a block
        const int d_lo = dc - (wb - 1) > 0 ? dc - (wb - 1) : 0;
        const int d_hi = dc < wa - 1 ? dc : wa - 1;
        run(i, d_lo, d_hi + 1, stage_pairs(d_lo, d_hi + 1, [job = *this, dc, m](int d1) {
            const int k = m + job.off_a + d1;  // off_a may be negative
            if (k < 0 || k >= job.kt) return make_int2(-1, -1);
            return make_int2(job.a_pack[d1 * job.mt + m],
                             job.b_pack[(dc - d1) * job.kt + k]);
        }));
    }
};

}  // namespace dbcsr_torch

// dtype: 0 f32, 1 bf16 (both with f32 output), 2 f64 (f64 output).
extern "C" int dbcsr_torch_band_matmul(
    const void* a, const void* b, void* c, const void* a_pack,
    const void* b_pack, const void* c_unpack, long long n_c, int wa, int wb,
    int mt, int kt, int off_a, int tile, int dtype, int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_c <= 0) return 0;
    const BandJob job{static_cast<const int*>(a_pack), static_cast<const int*>(b_pack),
                      static_cast<const int*>(c_unpack), wa, wb, mt, kt, off_a};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<true>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        using Acc = typename AccOf<In>::type;
        constexpr int T = decltype(tile_tag)::value;
        return launch_tile_kernel<In, T>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<Acc*>(c), n_c, job, s);
    });
}
