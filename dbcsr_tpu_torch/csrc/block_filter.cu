// The eps filter's two passes over a tile store, each walking every tile's
// atom-block segments in place: block norms² (block_sumsq_kernel) and the
// keep decision with the zeroing of the dropped blocks (keep_blocks_kernel).
//
// Replaces no TPU kernel: the JAX package takes its norms and masks as XLA
// indicator matmuls (dbcsr_tpu/block/tileops.py: per_tile_block_sums,
// block_mask_store), which the port first copied as batched torch matmuls.
// Those read every tile of C's store, square it into a float32 copy, run two
// small GEMMs a tile, and build a float32 T×T mask a tile (plus its float64
// copy and a masked second C) to zero a block. On an atom-block pattern the
// stored blocks cover a third of the store or less (liquid water at T = 128:
// 31%), and the rest is padding that holds exact zeros.
//
// The plan (block/tileops.py, built once on the host): each tile row's and
// tile column's segment bounds rseg[r][0..amax] / cseg[c][0..bmax] (segment a
// of tile row r covers rows rseg[r][a] .. rseg[r][a+1]-1 of its tiles; past
// the last segment the bounds stay at its end), each tile's tile row and
// column (rows, cols, int64), and bid_p1[t][a][b], the stored block of cell
// (a, b) of tile t plus one (0 where none).
//
// What bounds them on an H100: bytes. block_sumsq reads the stored cells'
// elements and writes amax·bmax floats a tile; at water_2048 (C's store
// 13.77 GB in float64) the cells hold 4.28 GB, 1.28 ms at 3.35 TB/s, against
// 4.11 ms for a pass that reads every tile. keep_blocks writes zeros into the
// dropped cells and reads nothing of the store: 2.85 GB there, 0.85 ms.
//
// Both kernels walk a tile the same way: one block of 256 threads a tile; a
// thread owns 16 bytes of a row (4 float32, 8 bfloat16, 2 float64, 2
// complex64 or 1 complex128 columns: V of them); the T / V threads of a
// row form a row group, and group g walks the row segments a ≡ g (mod G)
// top to bottom, so a segment is never split between groups.
//
// block_sumsq_kernel: a thread loads its 16 bytes of a segment's rows only
// where one of its columns lies in a stored cell of that segment: the
// padding and the empty cells are never read. Each square is taken in the
// store's precision, rounded to float32 and added in float32 in row order
// (no contraction into an FMA, as torch's squares followed by a float32
// sum), into a per-(segment, column) partial in shared memory; then one
// thread a cell adds its columns' partials in column order. No atomics: the
// order is fixed and two launches are bitwise equal. The structure is the
// indicator matmuls' (rows of a segment first, then its columns), so the
// two differ by float32 rounding of the sums alone.
//
// keep_blocks_kernel: keep[i] = (nsq[i] >= thr) over the blocks, grid-stride;
// then each tile's cells are marked no block / kept / dropped (a stored
// block whose nsq is below thr, or NaN) in shared memory, and a thread
// writes zeros down its 16 bytes of a segment's rows where one of its
// columns lies in a dropped cell: one 16-byte store a row where no kept cell
// shares its columns, else its dropped columns one by one. Kept blocks are
// never written, and nothing of the store is read. The padding is zero
// already, because the superset product of stores with zero padding leaves
// every position that no stored block covers at exact zero; it is written
// (with zeros) only inside a 32-byte sector of a row that a dropped block
// shares, so that the sector is written whole (a partial sector costs the
// memory a read besides the write). At water_2048 that takes 2.33 ms; a
// first design, a warp a dropped cell with its lanes along the cell's
// elements (stores of 40 and 104 bytes a row), took 4.78 ms, and 16-byte
// stores of the dropped pieces alone 3.06 ms.
#include "tile_product.cuh"

namespace dbcsr_torch {

constexpr int kFilterThreads = 256;  // a block of either kernel: one tile

// A thread's 16 bytes of a row: n columns of element type S. squares()
// takes each column's |x|² in the store's precision (re² + im² for a
// complex element, both products and their sum rounded in the parts'
// precision; a bfloat16 square rounded to bfloat16, as torch multiplies
// bfloat16) and rounds it to float32; zero() is 16 bytes of zeros and
// zero1() one element's.
template <typename S> struct Vec16;
template <> struct Vec16<double> {
    using type = double2;
    static constexpr int n = 2;
    __device__ static type zero() { return make_double2(0.0, 0.0); }
    __device__ static double zero1() { return 0.0; }
    __device__ static void squares(const double2 v, float* sq)
    {
        sq[0] = __double2float_rn(__dmul_rn(v.x, v.x));
        sq[1] = __double2float_rn(__dmul_rn(v.y, v.y));
    }
};
template <> struct Vec16<float> {
    using type = float4;
    static constexpr int n = 4;
    __device__ static type zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static float zero1() { return 0.f; }
    __device__ static void squares(const float4 v, float* sq)
    {
        sq[0] = __fmul_rn(v.x, v.x);
        sq[1] = __fmul_rn(v.y, v.y);
        sq[2] = __fmul_rn(v.z, v.z);
        sq[3] = __fmul_rn(v.w, v.w);
    }
};
template <> struct Vec16<__nv_bfloat16> {
    using type = uint4;
    static constexpr int n = 8;
    __device__ static type zero() { return make_uint4(0u, 0u, 0u, 0u); }
    __device__ static __nv_bfloat16 zero1() { return __ushort_as_bfloat16(0); }
    __device__ static void squares(const uint4 v, float* sq)
    {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const float f = __bfloat162float(e[k]);
            sq[k] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(f, f)));
        }
    }
};
template <> struct Vec16<float2> {  // complex64: (re, im)
    using type = float4;
    static constexpr int n = 2;
    __device__ static type zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ static float2 zero1() { return make_float2(0.f, 0.f); }
    __device__ static void squares(const float4 v, float* sq)
    {
        sq[0] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
        sq[1] = __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w));
    }
};
template <> struct Vec16<double2> {  // complex128: (re, im)
    using type = double2;
    static constexpr int n = 1;
    __device__ static type zero() { return make_double2(0.0, 0.0); }
    __device__ static double2 zero1() { return make_double2(0.0, 0.0); }
    __device__ static void squares(const double2 v, float* sq)
    {
        sq[0] = __double2float_rn(__dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y)));
    }
};

// dynamic shared memory of block_sumsq_kernel: the float partials
// [amax][T], then one byte a cell (stored or not)
inline size_t sumsq_smem(int tile, int amax, int bmax)
{
    return sizeof(float) * (size_t)amax * tile + (size_t)amax * bmax;
}

// The column segments [lo, hi] that columns j0 .. j0 + n - 1 of a tile lie
// in (cs: its tile column's bounds); false when they all lie past the last
// segment (padding), and lo, hi are then not to be read. Past the last
// segment the bounds stay at its end, so hi may name empty segments there,
// which hold no block.
__device__ inline bool column_segments(const int* cs, int bmax, int j0, int n, int& lo,
                                       int& hi)
{
    lo = 0;
    while (lo + 1 < bmax && cs[lo + 1] <= j0) ++lo;
    hi = lo;
    while (hi + 1 < bmax && cs[hi + 1] <= j0 + n - 1) ++hi;
    return j0 < cs[bmax];
}

template <typename S, int T>
__global__ void __launch_bounds__(kFilterThreads)
block_sumsq_kernel(const S* __restrict__ store, float* __restrict__ z,
                   const long long* __restrict__ rows, const long long* __restrict__ cols,
                   const int* __restrict__ rseg, const int* __restrict__ cseg,
                   const long long* __restrict__ bid_p1, int amax, int bmax)
{
    using V = Vec16<S>;
    constexpr int L = T / V::n;            // threads along a row
    constexpr int G = kFilterThreads / L;  // row groups
    extern __shared__ float part[];        // [amax][T]
    unsigned char* stored = reinterpret_cast<unsigned char*>(part + amax * T);
    const long long t = blockIdx.x;
    const int ncell = amax * bmax;
    const int* rs = rseg + rows[t] * (amax + 1);
    const int* cs = cseg + cols[t] * (bmax + 1);
    const long long* bp = bid_p1 + t * ncell;
    for (int c = threadIdx.x; c < ncell; c += kFilterThreads) stored[c] = bp[c] > 0;
    const int lane = threadIdx.x % L, g = threadIdx.x / L;
    const int j0 = lane * V::n;
    int b_lo, b_hi;
    const bool any_col = column_segments(cs, bmax, j0, V::n, b_lo, b_hi);
    __syncthreads();
    const S* x = store + t * (T * T) + j0;
    for (int a = g; a < amax; a += G) {
        float acc[V::n];
#pragma unroll
        for (int k = 0; k < V::n; ++k) acc[k] = 0.f;
        bool need = false;
        if (any_col)
            for (int b = b_lo; b <= b_hi; ++b) need |= stored[a * bmax + b] != 0;
        if (need) {
            const int r1 = rs[a + 1];
#pragma unroll 8
            for (int r = rs[a]; r < r1; ++r) {
                float sq[V::n];
                V::squares(*reinterpret_cast<const typename V::type*>(x + r * T), sq);
#pragma unroll
                for (int k = 0; k < V::n; ++k) acc[k] = __fadd_rn(acc[k], sq[k]);
            }
        }
#pragma unroll
        for (int k = 0; k < V::n; ++k) part[a * T + j0 + k] = acc[k];
    }
    __syncthreads();
    float* zt = z + t * ncell;
    for (int c = threadIdx.x; c < ncell; c += kFilterThreads) {
        float s = 0.f;
        if (stored[c]) {
            const int a = c / bmax, b = c - a * bmax;
            const float* p = part + a * T;
            for (int j = cs[b]; j < cs[b + 1]; ++j) s = __fadd_rn(s, p[j]);
        }
        zt[c] = s;
    }
}

// keep_blocks_kernel's dynamic shared memory: one byte a cell (no block,
// kept, dropped), then one byte a (row segment, 16-byte chunk of a row)
enum CellState : unsigned char { kNoBlock = 0, kKept = 1, kDropped = 2 };

// 16-byte chunks of a row written together by keep_blocks_kernel: a chunk
// with no kept block is written whole where one of its group is dropped and
// written whole, so that the group's bytes reach the memory whole. Two
// chunks, a 32-byte sector: at water_2048 groups of 1, 2, 4 and 8 chunks
// took 3.06, 2.33, 2.35 and 2.42 ms (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kWriteGroup = 2;

template <typename S, int T>
__global__ void __launch_bounds__(kFilterThreads)
keep_blocks_kernel(S* __restrict__ store, const float* __restrict__ nsq,
                   float* __restrict__ keep, const long long* __restrict__ rows,
                   const long long* __restrict__ cols, const int* __restrict__ rseg,
                   const int* __restrict__ cseg, const long long* __restrict__ bid_p1,
                   long long n_tiles, long long n_blocks, int amax, int bmax, float thr)
{
    using V = Vec16<S>;
    constexpr int L = T / V::n;
    constexpr int G = kFilterThreads / L;
    extern __shared__ unsigned char state[];  // [amax][bmax]
    const long long stride = (long long)gridDim.x * kFilterThreads;
    for (long long i = (long long)blockIdx.x * kFilterThreads + threadIdx.x; i < n_blocks;
         i += stride)
        keep[i] = nsq[i] >= thr ? 1.f : 0.f;
    const long long t = blockIdx.x;
    if (t >= n_tiles) return;  // the whole block
    const int ncell = amax * bmax;
    const int* rs = rseg + rows[t] * (amax + 1);
    const int* cs = cseg + cols[t] * (bmax + 1);
    const long long* bp = bid_p1 + t * ncell;
    for (int c = threadIdx.x; c < ncell; c += kFilterThreads) {
        const long long id = bp[c];
        state[c] = id == 0 ? kNoBlock : nsq[id - 1] >= thr ? kKept : kDropped;
    }
    unsigned char* flags = state + ncell;  // [amax][L]: a chunk's cells, below
    const int lane = threadIdx.x % L, g = threadIdx.x / L;
    const int j0 = lane * V::n;
    int b_lo, b_hi;
    const bool any_col = column_segments(cs, bmax, j0, V::n, b_lo, b_hi);
    __syncthreads();
    // what the cells of segment a hold in each thread's 16 bytes of a row:
    // kDropped (1) and kKept (2) or'ed
    for (int a = g; a < amax; a += G) {
        unsigned char f = 0;
        for (int b = b_lo; any_col && b <= b_hi; ++b) {
            const unsigned char c = state[a * bmax + b];
            f |= c == kDropped ? 1 : c == kKept ? 2 : 0;
        }
        flags[a * L + lane] = f;
    }
    __syncthreads();
    constexpr int W = kWriteGroup < L ? kWriteGroup : L;
    const int first = lane & ~(W - 1);
    S* x = store + t * (T * T) + j0;
    for (int a = g; a < amax; a += G) {
        const unsigned char f = flags[a * L + lane];
        const int r0 = rs[a], r1 = rs[a + 1];
        if (!(f & 2)) {
            // no kept block among these columns: one 16-byte store a row
            // where a dropped block lies in them, or in a chunk of the same
            // write group that is written whole (the padding holds zeros
            // already, and the group's sectors are then written whole)
            bool whole = f & 1;
            for (int m = first; m < first + W && !whole; ++m) whole = flags[a * L + m] == 1;
            if (whole)
                for (int r = r0; r < r1; ++r)
                    *reinterpret_cast<typename V::type*>(x + r * T) = V::zero();
            continue;
        }
        if (!(f & 1)) continue;
        // a kept block shares these columns: the dropped columns alone
        int b = b_lo;
        for (int k = 0; k < V::n; ++k) {
            while (b < b_hi && cs[b + 1] <= j0 + k) ++b;
            if (state[a * bmax + b] != kDropped) continue;
            for (int r = r0; r < r1; ++r) x[r * T + k] = V::zero1();
        }
    }
}

// the filter's store types: tile_product.cuh's codes, and two complex ones
enum FilterDType : int { kFilterC64 = 3, kFilterC128 = 4 };

template <typename F>
static int dispatch_filter(int dtype, int tile, F&& f)
{
    if (dtype == kF32) return dispatch_tile<float>(tile, f);
    if (dtype == kBF16) return dispatch_tile<__nv_bfloat16>(tile, f);
    if (dtype == kF64) return dispatch_tile<double>(tile, f);
    if (dtype == kFilterC64) return dispatch_tile<float2>(tile, f);
    if (dtype == kFilterC128) return dispatch_tile<double2>(tile, f);
    return (int)cudaErrorInvalidValue;
}

}  // namespace dbcsr_torch

// z[t][a][b] = Σ |x|² over stored cell (a, b) of tile t, float32; 0 where
// no block is stored. dtype: kF32, kBF16, kF64, kFilterC64 or kFilterC128.
extern "C" int dbcsr_torch_block_sumsq(
    const void* store, void* z, const void* rows, const void* cols, const void* rseg,
    const void* cseg, const void* bid_p1, long long n_tiles, int amax, int bmax,
    int tile, int dtype, int device, void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    if (n_tiles <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = sumsq_smem(tile, amax, bmax);
    return dispatch_filter(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using S = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        auto kernel = block_sumsq_kernel<S, T>;
        if (smem > 48 * 1024) {
            const int e = (int)cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e) return e;
        }
        kernel<<<(unsigned)n_tiles, kFilterThreads, smem, s>>>(
            static_cast<const S*>(store), static_cast<float*>(z),
            static_cast<const long long*>(rows), static_cast<const long long*>(cols),
            static_cast<const int*>(rseg), static_cast<const int*>(cseg),
            static_cast<const long long*>(bid_p1), amax, bmax);
        return (int)cudaGetLastError();
    });
}

// keep[i] = nsq[i] >= thr (1 or 0, float32) over the n_blocks blocks, and
// zeros written, in place, over every stored cell of the n_tiles tiles whose
// block is not kept.
extern "C" int dbcsr_torch_keep_blocks(
    void* store, const void* nsq, void* keep, const void* rows, const void* cols,
    const void* rseg, const void* cseg, const void* bid_p1, long long n_tiles,
    long long n_blocks, int amax, int bmax, float thr, int tile, int dtype, int device,
    void* stream)
{
    using namespace dbcsr_torch;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    const long long for_keep = (n_blocks + kFilterThreads - 1) / kFilterThreads;
    const long long grid = n_tiles > for_keep ? n_tiles : for_keep;
    if (grid <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch_filter(dtype, tile, [&](auto in_tag, auto tile_tag) {
        using S = typename decltype(in_tag)::type;
        constexpr int T = decltype(tile_tag)::value;
        const size_t smem = (size_t)amax * (bmax + T / Vec16<S>::n);
        keep_blocks_kernel<S, T><<<(unsigned)grid, kFilterThreads, smem, s>>>(
            static_cast<S*>(store), static_cast<const float*>(nsq),
            static_cast<float*>(keep), static_cast<const long long*>(rows),
            static_cast<const long long*>(cols), static_cast<const int*>(rseg),
            static_cast<const int*>(cseg), static_cast<const long long*>(bid_p1),
            n_tiles, n_blocks, amax, bmax, thr);
        return (int)cudaGetLastError();
    });
}
