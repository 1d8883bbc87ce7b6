/* dbcsr_tpu C API, the build over dbcsr_tpu_torch (PyTorch and the port's
 * CUDA kernels on an NVIDIA GPU): the analog of DBCSR's C bindings, the
 * full `c_dbcsr_*` matrix surface (DBCSR's `src/dbcsr.h`,
 * 100 functions generated by fypp over `src/dbcsr_api_c.F`) plus the
 * `c_dbcsr_t_*` tensor surface (`src/tensors/dbcsr_tensor.h`, 54
 * functions over `dbcsr_tensor_api_c.F`). The shim embeds CPython: the
 * heavy lifting runs in the dbcsr_tpu_torch package on the device that
 * DBCSR_CAPI_DEVICE names (`cuda` by default, `cuda:N`, or `cpu`); this
 * header gives C/Fortran applications the familiar handle-based surface
 * for all four type classes d/s/z/c.
 *
 * Documented deviations from the reference (see PARITY.md):
 *  - handles are opaque int64 values (0 = "none") instead of void*;
 *  - every function returns int: 0 = success, nonzero = failure with the
 *    message available via c_dbcsr_last_error() (the reference's void
 *    returns abort on error instead);
 *  - complex scalars are passed/returned as (re, im) double pairs; the
 *    real type classes ignore the imaginary part;
 *  - MPI communicators are plain ints, accepted and ignored (the device
 *    comes from DBCSR_CAPI_DEVICE; distributions carry the grid);
 *  - pointer-returning accessors (get_block_p / get_data / iterators)
 *    COPY into caller-provided buffers — device-resident storage has no
 *    stable element addresses. Pass NULL to query sizes only.
 *
 * Matrix handles follow the reference's work-matrix state machine:
 * create_new/put_block2d stage blocks, finalize builds the index; access
 * on an unfinalized matrix finalizes implicitly; put_block2d on a
 * finalized matrix re-opens it (dbcsr_work_operations semantics).
 *
 * Thread-safety: calls acquire the CPython GIL; concurrent calls from
 * multiple threads serialize (the reference's library-level locking).
 */
#ifndef DBCSR_TPU_CAPI_H
#define DBCSR_TPU_CAPI_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* data_type constants (reference dbcsr.h:17-20) */
#define dbcsr_type_real_4 1
#define dbcsr_type_real_8 3
#define dbcsr_type_complex_4 5
#define dbcsr_type_complex_8 7

/* norm kinds (reference dbcsr.h:24-27) */
#define dbcsr_norm_frobenius 1
#define dbcsr_norm_maxabsnorm 2
#define dbcsr_norm_gershgorin 3
#define dbcsr_norm_column 4

/* element functions (reference dbcsr.h:29-41; supported subset) */
#define dbcsr_func_inverse 0
#define dbcsr_func_tanh 1
#define dbcsr_func_dtanh 2
#define dbcsr_func_ddtanh 3
#define dbcsr_func_artanh 4
#define dbcsr_func_inverse_special 5
#define dbcsr_func_sin 7
#define dbcsr_func_cos 11

/* ===================== lifecycle ===================== */
int c_dbcsr_init_lib(void); /* convenience (no comm) */
int c_dbcsr_init_lib_internal(int comm, int io_unit);
int c_dbcsr_finalize_lib(void);
int c_dbcsr_clear_mempools(void);
int c_dbcsr_print_statistics(int print_timers, const char *callgraph_file);
int c_dbcsr_mp_grid_setup(int64_t dist);
const char *c_dbcsr_last_error(void);
int c_dbcsr_release(int64_t handle);      /* any handle, by value */
int c_dbcsr_release_p(int64_t *handle);   /* reference shape: zeroes it */

/* ===================== distribution ===================== */
int c_dbcsr_distribution_new(int64_t *dist, int comm, const int *row_dist,
                             int row_dist_size, const int *col_dist,
                             int col_dist_size);
int c_dbcsr_distribution_hold(int64_t dist);
int c_dbcsr_distribution_release(int64_t *dist);
int c_dbcsr_distribution_get(int64_t dist, int *nprow, int *npcol,
                             int *nrows, int *ncols);

/* ===================== create / finalize ===================== */
int c_dbcsr_create_new(int64_t *matrix, const char *name, int64_t dist,
                       char matrix_type, const int *row_blk_size,
                       int row_size, const int *col_blk_size, int col_size,
                       int data_type);
int c_dbcsr_create_template(int64_t *matrix, const char *name,
                            int64_t template_, int64_t dist,
                            char matrix_type, int data_type);
int c_dbcsr_finalize(int64_t matrix);

/* legacy convenience assembly (f64; kept from v1) */
int c_dbcsr_create(int64_t *builder, const char *name,
                   const int *row_block_sizes, int nblkrows,
                   const int *col_block_sizes, int nblkcols);
int c_dbcsr_put_block_d(int64_t builder, int row, int col,
                        const double *block, int m, int n, int sum);
int c_dbcsr_finalize_builder(int64_t builder, int64_t *matrix);
int c_dbcsr_get_block_d(int64_t matrix, int row, int col, double *out,
                        int *m, int *n, int *found);
int c_dbcsr_get_nblks(int64_t matrix, int64_t *nblks);
int c_dbcsr_filter_d(int64_t a, double eps, int64_t *out);
int c_dbcsr_transpose(int64_t a, int64_t *out);
int c_dbcsr_norm_frobenius(int64_t a, double *out);

/* ===================== block assembly / access ===================== */
#define DBCSR_TPU_TYPED4(DECL) DECL(d, double) DECL(s, float) \
  DECL(z, double) DECL(c, float)

#define DBCSR_TPU_DECL_PUT(SUF, CTYPE)                                  \
  int c_dbcsr_put_block2d_##SUF(int64_t matrix, int row, int col,       \
                                const CTYPE *block, int m, int n,       \
                                int summation);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_PUT)

#define DBCSR_TPU_DECL_GETB(SUF, CTYPE)                                 \
  int c_dbcsr_get_block_p_##SUF(int64_t matrix, int row, int col,       \
                                CTYPE *block, int *found, int *row_size,\
                                int *col_size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_GETB)

int c_dbcsr_reserve_block2d(int64_t matrix, int row, int col);
int c_dbcsr_reserve_blocks(int64_t matrix, const int *rows,
                           const int *cols, int n);
int c_dbcsr_reserve_all_blocks(int64_t matrix);
int c_dbcsr_reserve_diag_blocks(int64_t matrix);

/* ===================== iterators ===================== */
int c_dbcsr_iterator_start(int64_t *iterator, int64_t matrix);
int c_dbcsr_iterator_blocks_left(int64_t iterator, int *left);
int c_dbcsr_iterator_next_block_index(int64_t iterator, int *row, int *col,
                                      int *blk_size);
#define DBCSR_TPU_DECL_IT(SUF, CTYPE)                                   \
  int c_dbcsr_iterator_next_2d_block_##SUF(int64_t iterator, int *row,  \
                                           int *col, CTYPE *block,      \
                                           int *row_size, int *col_size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_IT)
int c_dbcsr_iterator_stop(int64_t *iterator);

/* ===================== typed primitive ops =====================
 * A <- alpha*A + beta*B etc. — the reference's mutating semantics. */
#define DBCSR_TPU_DECL_SET(SUF, CTYPE)                                  \
  int c_dbcsr_set_##SUF(int64_t matrix, double re, double im);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_SET)
#define DBCSR_TPU_DECL_ADD(SUF, CTYPE)                                  \
  int c_dbcsr_add_##SUF(int64_t matrix_a, int64_t matrix_b, double ar,  \
                        double ai, double br, double bi);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_ADD)
#define DBCSR_TPU_DECL_SCALE(SUF, CTYPE)                                \
  int c_dbcsr_scale_##SUF(int64_t matrix, double re, double im);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_SCALE)
#define DBCSR_TPU_DECL_SCALEV(SUF, CTYPE)                               \
  int c_dbcsr_scale_by_vector_##SUF(int64_t matrix, const CTYPE *alpha, \
                                    int alpha_size, const char *side);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_SCALEV)
#define DBCSR_TPU_DECL_MM(SUF, CTYPE)                                   \
  int c_dbcsr_multiply_##SUF(char transa, char transb, double alpha_re, \
                             double alpha_im, int64_t matrix_a,         \
                             int64_t matrix_b, double beta_re,          \
                             double beta_im, int64_t matrix_c,          \
                             int retain_sparsity, double filter_eps,    \
                             double *flop);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_MM)
#define DBCSR_TPU_DECL_TRACE(SUF, CTYPE)                                \
  int c_dbcsr_trace_##SUF(int64_t matrix, double *re, double *im);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TRACE)
#define DBCSR_TPU_DECL_DOT(SUF, CTYPE)                                  \
  int c_dbcsr_dot_##SUF(int64_t matrix_a, int64_t matrix_b, double *re, \
                        double *im);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_DOT)
#define DBCSR_TPU_DECL_GDIAG(SUF, CTYPE)                                \
  int c_dbcsr_get_diag_##SUF(int64_t matrix, CTYPE *diag, int size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_GDIAG)
#define DBCSR_TPU_DECL_SDIAG(SUF, CTYPE)                                \
  int c_dbcsr_set_diag_##SUF(int64_t matrix, const CTYPE *diag, int size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_SDIAG)
#define DBCSR_TPU_DECL_ADIAG(SUF, CTYPE)                                \
  int c_dbcsr_add_on_diag_##SUF(int64_t matrix, double re, double im);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_ADIAG)
#define DBCSR_TPU_DECL_GDATA(SUF, CTYPE)                                \
  int c_dbcsr_get_data_##SUF(int64_t matrix, CTYPE *data, int size,     \
                             int64_t *data_size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_GDATA)

/* ===================== untyped ops ===================== */
int c_dbcsr_clear(int64_t matrix);
int c_dbcsr_triu(int64_t matrix);
int c_dbcsr_replicate_all(int64_t matrix);
int c_dbcsr_sum_replicated(int64_t matrix);
int c_dbcsr_print(int64_t matrix);
int c_dbcsr_print_block_sum(int64_t matrix);
int c_dbcsr_filter(int64_t matrix, double eps);
int c_dbcsr_function_of_elements(int64_t matrix, int func, double a0,
                                 double a1, double a2);
int c_dbcsr_hadamard_product(int64_t matrix_a, int64_t matrix_b,
                             int64_t matrix_c);
int c_dbcsr_init_random(int64_t matrix, int keep_sparsity);
int c_dbcsr_copy(int64_t matrix_b, int64_t matrix_a, const char *name);
int c_dbcsr_copy_into_existing(int64_t matrix_b, int64_t matrix_a);
int c_dbcsr_desymmetrize(int64_t matrix, int64_t *out);
int c_dbcsr_transposed(int64_t matrix, int64_t *out);
int c_dbcsr_get_block_diag(int64_t matrix, int64_t *out);
int c_dbcsr_complete_redistribute(int64_t matrix, int64_t dist,
                                  int64_t *out);
int c_dbcsr_distribute(int64_t matrix, int64_t dist);

/* ===================== norms / info / io ===================== */
int c_dbcsr_frobenius_norm(int64_t matrix, double *out);
int c_dbcsr_gershgorin_norm(int64_t matrix, double *out);
int c_dbcsr_maxabs(int64_t matrix, double *out);
int c_dbcsr_norm_scalar(int64_t matrix, int which, double *out);
int c_dbcsr_checksum(int64_t matrix, int pos, double *out);
int c_dbcsr_get_occupation(int64_t matrix, double *out);
int c_dbcsr_get_data_type(int64_t matrix, int *out);
int c_dbcsr_get_data_size(int64_t matrix, int64_t *out);
int c_dbcsr_get_num_blocks(int64_t matrix, int *out);
int c_dbcsr_nblkrows_total(int64_t matrix, int *out);
int c_dbcsr_nblkcols_total(int64_t matrix, int *out);
int c_dbcsr_nblkrows_local(int64_t matrix, int *out);
int c_dbcsr_nblkcols_local(int64_t matrix, int *out);
int c_dbcsr_nfullrows_total(int64_t matrix, int *out);
int c_dbcsr_nfullcols_total(int64_t matrix, int *out);
int c_dbcsr_valid_index(int64_t matrix, int *out);
int c_dbcsr_has_symmetry(int64_t matrix, int *out);
int c_dbcsr_get_group(int64_t matrix, int *out);
int c_dbcsr_get_matrix_type(int64_t matrix, char *out);
int c_dbcsr_get_name(int64_t matrix, char *out, int maxlen);
int c_dbcsr_setname(int64_t matrix, const char *name);
int c_dbcsr_get_info(int64_t matrix, int *nblkrows, int *nblkcols,
                     int *nfullrows, int *nfullcols, int *nblks);
/* reference ${var}$-stamped info arrays (dbcsr.h:282-287); copies the
 * first min(size, len) ints. 0-based offsets; local == total on one
 * controller. */
int c_dbcsr_get_local_rows(int64_t matrix, int *out, int size);
int c_dbcsr_get_local_cols(int64_t matrix, int *out, int size);
int c_dbcsr_get_proc_row_dist(int64_t matrix, int *out, int size);
int c_dbcsr_get_proc_col_dist(int64_t matrix, int *out, int size);
int c_dbcsr_get_row_blk_size(int64_t matrix, int *out, int size);
int c_dbcsr_get_col_blk_size(int64_t matrix, int *out, int size);
int c_dbcsr_get_row_blk_offset(int64_t matrix, int *out, int size);
int c_dbcsr_get_col_blk_offset(int64_t matrix, int *out, int size);
int c_dbcsr_get_stored_coordinates(int64_t matrix, int row, int col,
                                   int *processor);
int c_dbcsr_get_distribution(int64_t matrix, int64_t *dist);
int c_dbcsr_binary_write(int64_t matrix, const char *filepath);
int c_dbcsr_binary_read(const char *filepath, int64_t dist,
                        int64_t *matrix);

/* ===================== tensor API (c_dbcsr_t_*) ===================== */
int c_dbcsr_t_pgrid_create(int64_t *pgrid, int ndim, const int *dims);
int c_dbcsr_t_pgrid_create_expert(int64_t *pgrid, int ndim,
                                  const int *dims, int nsplit,
                                  int dimsplit);
int c_dbcsr_t_pgrid_destroy(int64_t *pgrid);
int c_dbcsr_t_distribution_new(int64_t *dist, int64_t pgrid, int ndim);
int c_dbcsr_t_distribution_destroy(int64_t *dist);
int c_dbcsr_t_create_new(int64_t *tensor, const char *name, int ndim,
                         const int *nblks_per_dim,
                         const int *const *blk_sizes, const int *map1,
                         int nmap1, const int *map2, int nmap2,
                         int data_type);
int c_dbcsr_t_create_template(int64_t template_, int64_t *tensor,
                              const char *name, int data_type);
int c_dbcsr_t_create_matrix(int64_t matrix, int64_t *tensor,
                            const char *name);
int c_dbcsr_t_destroy(int64_t *tensor);
int c_dbcsr_t_finalize(int64_t tensor);

#define DBCSR_TPU_DECL_TPUT(SUF, CTYPE)                                 \
  int c_dbcsr_t_put_block_##SUF(int64_t tensor, int ndim,               \
                                const int *index, const int *sizes,     \
                                const CTYPE *block, int summation);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TPUT)
#define DBCSR_TPU_DECL_TGET(SUF, CTYPE)                                 \
  int c_dbcsr_t_get_block_##SUF(int64_t tensor, int ndim,               \
                                const int *index, CTYPE *block,         \
                                int *found, int *sizes);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TGET)

int c_dbcsr_t_reserve_blocks_index(int64_t tensor, int nblocks, int ndim,
                                   const int *const *index_per_dim);
int c_dbcsr_t_reserve_blocks_template(int64_t tensor_from,
                                      int64_t tensor_to);

/* bounds_1/2/3: the reference's batched-contraction element ranges over
 * (contracted dims / notcontract_1 / notcontract_2) — flattened
 * [lo0, hi0, lo1, hi1, ...], 0-based HALF-OPEN; NULL = unbounded, and a
 * (0, -1) pair leaves that single dim unbounded. */
#define DBCSR_TPU_DECL_TCON(SUF, CTYPE)                                 \
  int c_dbcsr_t_contract_##SUF(                                         \
      double alpha_re, double alpha_im, int64_t tensor_a,               \
      int64_t tensor_b, double beta_re, double beta_im,                 \
      int64_t tensor_c, const int *contract_1, int ncon1,               \
      const int *notcontract_1, int nncon1, const int *contract_2,      \
      int ncon2, const int *notcontract_2, int nncon2, const int *map_1,\
      int nmap1, const int *map_2, int nmap2, const int *bounds_1,      \
      const int *bounds_2, const int *bounds_3, double filter_eps,      \
      double *flop);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TCON)

int c_dbcsr_t_contract_index(int64_t tensor_a, int64_t tensor_b,
                             int64_t tensor_c, const int *contract_1,
                             int ncon1, const int *notcontract_1,
                             int nncon1, const int *contract_2, int ncon2,
                             const int *notcontract_2, int nncon2,
                             int *nblks_out);
/* typed index-only estimate (reference dbcsr_tensor.h:82-87): returns
 * the result block count and fills result_index (row-major
 * [nblks, ndim_c], 0-based) up to result_index_size ints; alpha/beta
 * exist for signature parity (the index is scale-independent). */
#define DBCSR_TPU_DECL_TCIDX(SUF, CTYPE)                                \
  int c_dbcsr_t_contract_index_##SUF(                                   \
      double alpha_re, double alpha_im, int64_t tensor_a,               \
      int64_t tensor_b, double beta_re, double beta_im,                 \
      int64_t tensor_c, const int *contract_1, int ncon1,               \
      const int *notcontract_1, int nncon1, const int *contract_2,      \
      int ncon2, const int *notcontract_2, int nncon2,                  \
      double filter_eps, int *nblks_out, int *result_index,             \
      int64_t result_index_size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TCIDX)

int c_dbcsr_t_batched_contract_init(int64_t tensor, int64_t *state);
int c_dbcsr_t_batched_contract_finalize(int64_t *state);

int c_dbcsr_t_copy(int64_t tensor_from, int64_t tensor_to, int summation);
int c_dbcsr_t_copy_matrix_to_tensor(int64_t matrix, int64_t tensor);
int c_dbcsr_t_copy_tensor_to_matrix(int64_t tensor, int64_t matrix);
int c_dbcsr_t_filter(int64_t tensor, double eps);
/* typed filter (reference dbcsr_tensor.h:89-90): method must be 1
 * (Frobenius, the reference's only method); use_absolute nonzero scales
 * eps by the tensor's maxabs norm. */
#define DBCSR_TPU_DECL_TFILT(SUF, CTYPE)                                \
  int c_dbcsr_t_filter_##SUF(int64_t tensor, double eps, int method,    \
                             int use_absolute);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TFILT)
#define DBCSR_TPU_DECL_TSCALE(SUF, CTYPE)                               \
  int c_dbcsr_t_scale_##SUF(int64_t tensor, double re, double im);      \
  int c_dbcsr_t_set_##SUF(int64_t tensor, double re, double im);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TSCALE)
int c_dbcsr_t_clear(int64_t tensor);
int c_dbcsr_t_split_blocks(int64_t tensor, int ndim, const int *factors);

int c_dbcsr_t_iterator_start(int64_t *iterator, int64_t tensor);
int c_dbcsr_t_iterator_blocks_left(int64_t iterator, int *left);
#define DBCSR_TPU_DECL_TIT(SUF, CTYPE)                                  \
  int c_dbcsr_t_iterator_next_block_##SUF(int64_t iterator, int *index, \
                                          CTYPE *block, int *sizes,     \
                                          int ndim);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TIT)
int c_dbcsr_t_iterator_stop(int64_t *iterator);

int c_dbcsr_t_ndims(int64_t tensor, int *out);
int c_dbcsr_t_dims(int64_t tensor, int *out, int maxn);
int c_dbcsr_t_nblks_total(int64_t tensor, int dim, int *out);
int c_dbcsr_t_nblks_local(int64_t tensor, int dim, int *out);
int c_dbcsr_t_max_nblks_local(int64_t tensor, int *out);
int c_dbcsr_t_get_num_blocks(int64_t tensor, int *out);
int c_dbcsr_t_get_num_blocks_total(int64_t tensor, int *out);
int c_dbcsr_t_get_nze(int64_t tensor, int64_t *out);
int c_dbcsr_t_get_nze_total(int64_t tensor, int64_t *out);
int c_dbcsr_t_get_stored_coordinates(int64_t tensor, int ndim,
                                     const int *index, int *processor);
int c_dbcsr_t_get_mapping_info(int64_t tensor, int *map1, int *nmap1,
                               int *map2, int *nmap2);
int c_dbcsr_t_ndims_matrix_row(int64_t tensor, int *out);
int c_dbcsr_t_ndims_matrix_column(int64_t tensor, int *out);
int c_dbcsr_t_get_nd_index(int64_t tensor, int *out, int maxn);
int c_dbcsr_t_get_nd_index_blk(int64_t tensor, int *out, int maxn);
int c_dbcsr_t_get_info(int64_t tensor, int *ndim, int *dims, int *nblks,
                       int *data_type);
#define DBCSR_TPU_DECL_TDATA(SUF, CTYPE)                                \
  int c_dbcsr_t_get_data_##SUF(int64_t tensor, CTYPE *data, int size,   \
                               int64_t *data_size);
DBCSR_TPU_TYPED4(DBCSR_TPU_DECL_TDATA)

#ifdef __cplusplus
}
#endif

#endif /* DBCSR_TPU_CAPI_H */
