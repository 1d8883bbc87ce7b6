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
// buys nothing without an MXU. Here one block owns a BM×BM sub-tile of one
// PRESENT output tile — the i-th tile of the result, at band position
// c_unpack[i] = dc·Mt + m — and sums over d1 ascending (the order of the TPU
// kernel's unrolled loop and of the plain version), reading the tile stores
// directly through a_pack[d1·Mt + m] and b_pack[d2·Kt + k], k = m + off_a +
// d1. A -1 slot or a k outside [0, Kt) is a zero tile and is skipped, so the
// kernel does the products that exist (the stack's), not the padded Wa·Wb·Mt,
// moves no packed copy, and writes the result in c_unpack order with no
// gather after it. Each output element is summed by one thread in a fixed
// order and written once: no atomics, two launches bitwise equal.
//
// What bounds it on an H100: as K1 (tile_product.cuh) — 2·T³ flops per
// present (A, B) pair against two tile reads, compute-bound on FFMA (DFMA for
// double) issue and shared-memory reads; the Wa+Wb tiles a block row touches
// are shared with the neighbouring rows' blocks through L2, the reuse the
// sliding ring bought on the TPU.
#include "tile_product.cuh"

namespace dbcsr_torch {

template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
band_matmul_kernel(const In* __restrict__ A, const In* __restrict__ B,
                   typename AccOf<In>::type* __restrict__ C,
                   const int* __restrict__ a_pack, const int* __restrict__ b_pack,
                   const int* __restrict__ c_unpack,
                   int wa, int wb, int mt, int kt, int off_a)
{
    using S = SubTile<T>;
    constexpr int NS = T / S::BM;
    const int64_t i = blockIdx.x / S::kPerTile;
    const int sub = blockIdx.x % S::kPerTile;
    const int r0 = (sub / NS) * S::BM, c0 = (sub % NS) * S::BM;
    const int pos = c_unpack[i];
    const int dc = pos / mt, m = pos % mt;
    const int d_lo = dc - (wb - 1) > 0 ? dc - (wb - 1) : 0;
    const int d_hi = dc < wa - 1 ? dc : wa - 1;
    tile_run<In, T, S::BM>(
        A, B, C + i * (T * T), r0, c0, d_lo, d_hi + 1,
        [=](int d1) {
            const int k = m + off_a + d1;  // off_a may be negative
            if (k < 0 || k >= kt) return make_int2(-1, -1);
            return make_int2(a_pack[d1 * mt + m], b_pack[(dc - d1) * kt + k]);
        });
}

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
    const int* ap = static_cast<const int*>(a_pack);
    const int* bp = static_cast<const int*>(b_pack);
    const int* cu = static_cast<const int*>(c_unpack);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch<true>(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using In = typename decltype(in_tag)::type;
        using Acc = typename AccOf<In>::type;
        constexpr int T = decltype(tile_tag)::value;
        const unsigned blocks = tile_grid<T>(n_c);
        if (!blocks) return (int)cudaErrorInvalidConfiguration;
        band_matmul_kernel<In, T><<<blocks, kThreads, 0, s>>>(
            static_cast<const In*>(a), static_cast<const In*>(b),
            static_cast<Acc*>(c), ap, bp, cu, wa, wb, mt, kt, off_a);
        return (int)cudaGetLastError();
    });
}
