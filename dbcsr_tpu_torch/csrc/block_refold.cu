// The block-granular refold of a tensor's tile store (block/refold.py): every
// stored block of a rank-N tensor (N <= 4) moves from its 2-D block in one
// fold to its 2-D block in another, its elements permuted inside the block.
//
// Replaces no TPU kernel: the JAX package refolds through an element map, one
// int32 or int64 store position an element (dbcsr_tpu/tensors/tensor.py,
// with_layout), and so did the port. Here the plan is a few numbers a block:
// its natural sizes (dims), the element row and column where its old and its
// new 2-D block start (meta), and a dense lookup of each store's tiles (slot
// of a tile row and column, -1 where the store holds no tile).
//
// One thread block a tensor block; its threads walk the block's elements in
// the new block's storage order (the new fold's last dim fastest), so the
// writes of neighbouring threads are neighbours in a row of the new store.
// Each thread works out from its element's natural index its row and column
// in both 2-D blocks: a dim's index is (e / stride) % size, and it adds
// index · mult to the row or the column of each fold, all from the dims'
// positions in the two storage orders (4 bits a dim, packed) and the
// block's sizes (a block holds fewer than 2^31 elements). Unused dims
// have size 1. The tile edge is a power of two,
// so a position is slot · T² + (row % T) · T + col % T with shifts.
//
// Bits are copied (elements of 2, 4, 8 or 16 bytes), so the result equals
// the element-map gather bit for bit; positions no block covers stay as the
// caller allocated them (zero). Bound by bytes: each block element is read
// once and written once; the reads of neighbouring threads are a row apart
// in the old store where the fold moves a dim across the row/column split.
#include <cuda_runtime.h>
#include <stdint.h>

namespace dbcsr_torch {

constexpr int kRefoldDims = 4;
constexpr int kRefoldThreads = 256;

struct Fold {
    int pos[kRefoldDims];  // each dim's position in the storage order
    int nrow;              // dims before this position are the rows
};

__device__ __forceinline__ Fold unpack_fold(int packed, int nrow)
{
    Fold f;
#pragma unroll
    for (int d = 0; d < kRefoldDims; ++d) f.pos[d] = (packed >> (4 * d)) & 0xF;
    f.nrow = nrow;
    return f;
}

// mult[d]: what one step of dim d moves the row (row[d] = 1) or the column
// of the 2-D block, under fold f with the block's sizes s
__device__ __forceinline__ void fold_mults(const Fold& f, const int* s, long long* mult,
                                           bool* row)
{
#pragma unroll
    for (int d = 0; d < kRefoldDims; ++d) {
        row[d] = f.pos[d] < f.nrow;
        long long m = 1;
#pragma unroll
        for (int q = 0; q < kRefoldDims; ++q) {
            const bool same = (f.pos[q] < f.nrow) == row[d];
            if (same && f.pos[q] > f.pos[d]) m *= s[q];
        }
        mult[d] = m;
    }
}

template <typename E>
__global__ void __launch_bounds__(kRefoldThreads) block_refold_kernel(
    const E* __restrict__ src, E* __restrict__ dst, const long long* __restrict__ meta,
    const int* __restrict__ dims, const int* __restrict__ src_lut,
    const int* __restrict__ dst_lut, long long src_ntc, long long dst_ntc, int old_packed,
    int old_nrow, int new_packed, int new_nrow, int tshift)
{
    const long long b = blockIdx.x;
    int s[kRefoldDims];
    int total = 1;
#pragma unroll
    for (int d = 0; d < kRefoldDims; ++d) {
        s[d] = dims[b * kRefoldDims + d];
        total *= s[d];
    }
    const long long sr0 = meta[4 * b], sc0 = meta[4 * b + 1];
    const long long dr0 = meta[4 * b + 2], dc0 = meta[4 * b + 3];
    const Fold fo = unpack_fold(old_packed, old_nrow);
    const Fold fn = unpack_fold(new_packed, new_nrow);
    // stride[d]: elements between neighbours along dim d in the new storage
    // order taken whole (rows then columns): the walk's order
    int stride[kRefoldDims];
    long long mo[kRefoldDims], mn[kRefoldDims];
    bool ro[kRefoldDims], rn[kRefoldDims];
#pragma unroll
    for (int d = 0; d < kRefoldDims; ++d) {
        int m = 1;
#pragma unroll
        for (int q = 0; q < kRefoldDims; ++q)
            if (fn.pos[q] > fn.pos[d]) m *= s[q];
        stride[d] = m;
    }
    fold_mults(fo, s, mo, ro);
    fold_mults(fn, s, mn, rn);
    const long long mask = (1LL << tshift) - 1;
    for (int e = threadIdx.x; e < total; e += kRefoldThreads) {
        long long orow = sr0, ocol = sc0, nrow = dr0, ncol = dc0;
#pragma unroll
        for (int d = 0; d < kRefoldDims; ++d) {
            const long long i = (e / stride[d]) % s[d];
            if (ro[d]) orow += i * mo[d]; else ocol += i * mo[d];
            if (rn[d]) nrow += i * mn[d]; else ncol += i * mn[d];
        }
        const long long sslot = src_lut[(orow >> tshift) * src_ntc + (ocol >> tshift)];
        const long long dslot = dst_lut[(nrow >> tshift) * dst_ntc + (ncol >> tshift)];
        dst[(dslot << (2 * tshift)) + ((nrow & mask) << tshift) + (ncol & mask)] =
            src[(sslot << (2 * tshift)) + ((orow & mask) << tshift) + (ocol & mask)];
    }
}

template <typename E>
int launch_refold(const void* src, void* dst, const void* meta, const void* dims,
                  const void* src_lut, const void* dst_lut, long long src_ntc,
                  long long dst_ntc, long long n_blocks, int old_nrow, int new_nrow,
                  int old_packed, int new_packed, int tshift, cudaStream_t s)
{
    if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    block_refold_kernel<E><<<(unsigned)n_blocks, kRefoldThreads, 0, s>>>(
        static_cast<const E*>(src), static_cast<E*>(dst),
        static_cast<const long long*>(meta), static_cast<const int*>(dims),
        static_cast<const int*>(src_lut), static_cast<const int*>(dst_lut), src_ntc, dst_ntc,
        old_packed, old_nrow, new_packed, new_nrow, tshift);
    return (int)cudaGetLastError();
}

}  // namespace dbcsr_torch

// dst (zero, the new fold's store) gets every element of the n_blocks blocks
// from src (the old fold's store). elem_bytes: 2, 4, 8 or 16.
extern "C" int dbcsr_torch_block_refold(
    const void* src, void* dst, const void* meta, const void* dims, const void* src_lut,
    const void* dst_lut, long long src_ntc, long long dst_ntc, long long n_blocks,
    int old_nrow, int new_nrow, int old_packed, int new_packed, int tshift, int elem_bytes,
    int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_blocks <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DBCSR_REFOLD(E)                                                                  \
    launch_refold<E>(src, dst, meta, dims, src_lut, dst_lut, src_ntc, dst_ntc, n_blocks, \
                     old_nrow, new_nrow, old_packed, new_packed, tshift, s)
    switch (elem_bytes) {
        case 2: return DBCSR_REFOLD(uint16_t);
        case 4: return DBCSR_REFOLD(uint32_t);
        case 8: return DBCSR_REFOLD(uint64_t);
        case 16: return DBCSR_REFOLD(uint4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DBCSR_REFOLD
}
