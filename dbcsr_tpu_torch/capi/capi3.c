/* Tensor C API (`c_dbcsr_t_*`) — analog of the reference's 54-function
 * tensor bindings (DBCSR's `src/tensors/dbcsr_tensor.h`,
 * impl `dbcsr_tensor_api_c.F`). #included from capi.c after capi2.c.
 * Same conventions: int64 handles, int error returns, buffers copied. */

static PyObject *int_list(const int *v, int n) {
  PyObject *l = PyList_New(n);
  for (int i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyLong_FromLong(v ? v[i] : 0));
  return l;
}

static PyObject *addr_list(const int *const *ptrs, int n) {
  PyObject *l = PyList_New(n);
  for (int i = 0; i < n; ++i)
    PyList_SetItem(l, i, PyLong_FromLongLong((long long)(intptr_t)ptrs[i]));
  return l;
}

static int parse_int_list(PyObject *l, int *out, int maxn) {
  Py_ssize_t n = PyList_Size(l);
  for (Py_ssize_t i = 0; i < n && i < maxn; ++i)
    out[i] = (int)PyLong_AsLong(PyList_GetItem(l, i));
  return (int)n;
}

/* ---------------- pgrid / distribution ---------------- */

int c_dbcsr_t_pgrid_create(int64_t *pgrid, int ndim, const int *dims) {
  ENTER;
  PyObject *r = callv("t_pgrid_create", "(iL)", ndim,
                      (long long)(intptr_t)dims);
  return finish_obj(st, r, pgrid);
}

int c_dbcsr_t_pgrid_create_expert(int64_t *pgrid, int ndim, const int *dims,
                                  int nsplit, int dimsplit) {
  (void)nsplit;
  (void)dimsplit; /* TAS split factors are auto-estimated here */
  return c_dbcsr_t_pgrid_create(pgrid, ndim, dims);
}

int c_dbcsr_t_pgrid_destroy(int64_t *pgrid) {
  int rc = c_dbcsr_release(*pgrid);
  if (!rc) *pgrid = 0;
  return rc;
}

int c_dbcsr_t_distribution_new(int64_t *dist, int64_t pgrid, int ndim) {
  ENTER;
  PyObject *r = callv("t_distribution_new", "(Oi)", cell_opt(pgrid), ndim);
  return finish_obj(st, r, dist);
}

int c_dbcsr_t_distribution_destroy(int64_t *dist) {
  int rc = c_dbcsr_release(*dist);
  if (!rc) *dist = 0;
  return rc;
}

/* ---------------- create / destroy ---------------- */

int c_dbcsr_t_create_new(int64_t *tensor, const char *name, int ndim,
                         const int *nblks_per_dim,
                         const int *const *blk_sizes, const int *map1,
                         int nmap1, const int *map2, int nmap2,
                         int data_type) {
  ENTER;
  PyObject *sizes = addr_list(blk_sizes, ndim);
  PyObject *m1 = int_list(map1, nmap1);
  PyObject *m2 = int_list(map2, nmap2);
  PyObject *r = callv("t_create_new", "(siLOOOi)", name, ndim,
                      (long long)(intptr_t)nblks_per_dim, sizes, m1, m2,
                      data_type);
  Py_DECREF(sizes);
  Py_DECREF(m1);
  Py_DECREF(m2);
  return finish_obj(st, r, tensor);
}

int c_dbcsr_t_create_template(int64_t template_, int64_t *tensor,
                              const char *name, int data_type) {
  ENTER;
  PyObject *t = cell_of(template_);
  if (!t) LEAVE_RC(1);
  return finish_obj(
      st, callv("t_create_template", "(Osi)", t, name, data_type), tensor);
}

int c_dbcsr_t_create_matrix(int64_t matrix, int64_t *tensor,
                            const char *name) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_obj(st, callv("t_create_matrix", "(Os)", m, name), tensor);
}

int c_dbcsr_t_destroy(int64_t *tensor) {
  int rc = c_dbcsr_release(*tensor);
  if (!rc) *tensor = 0;
  return rc;
}

int c_dbcsr_t_finalize(int64_t tensor) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_none(st, callv("t_finalize", "(O)", t));
}

/* ---------------- block access ---------------- */

#define T_PUT_BLOCK(SUF, CTYPE)                                            \
  int c_dbcsr_t_put_block_##SUF(int64_t tensor, int ndim,                  \
                                const int *index, const int *sizes,        \
                                const CTYPE *block, int summation) {       \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("t_put_block", "(OsiLLLi)", t, #SUF, ndim,    \
                             (long long)(intptr_t)index,                   \
                             (long long)(intptr_t)sizes,                   \
                             (long long)(intptr_t)block, summation));      \
  }

T_PUT_BLOCK(d, double)
T_PUT_BLOCK(s, float)
T_PUT_BLOCK(z, double)
T_PUT_BLOCK(c, float)

#define T_GET_BLOCK(SUF, CTYPE)                                            \
  int c_dbcsr_t_get_block_##SUF(int64_t tensor, int ndim,                  \
                                const int *index, CTYPE *block,            \
                                int *found, int *sizes) {                  \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    PyObject *r = callv("t_get_block", "(OsiLL)", t, #SUF, ndim,           \
                        (long long)(intptr_t)index,                        \
                        (long long)(intptr_t)block);                       \
    if (!r) LEAVE_RC(1);                                                   \
    PyObject *shp;                                                         \
    if (!PyArg_ParseTuple(r, "iO", found, &shp)) {                         \
      set_err_from_python();                                               \
      Py_DECREF(r);                                                        \
      LEAVE_RC(1);                                                         \
    }                                                                      \
    if (sizes) parse_int_list(shp, sizes, ndim);                           \
    Py_DECREF(r);                                                          \
    LEAVE_RC(0);                                                           \
  }

T_GET_BLOCK(d, double)
T_GET_BLOCK(s, float)
T_GET_BLOCK(z, double)
T_GET_BLOCK(c, float)

int c_dbcsr_t_reserve_blocks_index(int64_t tensor, int nblocks, int ndim,
                                   const int *const *index_per_dim) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  PyObject *addrs = addr_list(index_per_dim, ndim);
  PyObject *r = callv("t_reserve_blocks_index", "(OiO)", t, nblocks, addrs);
  Py_DECREF(addrs);
  return rc_none(st, r);
}

int c_dbcsr_t_reserve_blocks_template(int64_t tensor_from,
                                      int64_t tensor_to) {
  ENTER;
  PyObject *a = cell_of(tensor_from), *b = cell_of(tensor_to);
  if (!a || !b) LEAVE_RC(1);
  return rc_none(st, callv("t_reserve_blocks_template", "(OO)", a, b));
}

/* ---------------- contraction ---------------- */

#define T_CONTRACT(SUF)                                                    \
  int c_dbcsr_t_contract_##SUF(                                            \
      double ar, double ai, int64_t tensor_a, int64_t tensor_b, double br, \
      double bi, int64_t tensor_c, const int *contract_1, int ncon1,       \
      const int *notcontract_1, int nncon1, const int *contract_2,         \
      int ncon2, const int *notcontract_2, int nncon2, const int *map_1,   \
      int nmap1, const int *map_2, int nmap2, const int *bounds_1,         \
      const int *bounds_2, const int *bounds_3, double filter_eps,         \
      double *flop) {                                                      \
    ENTER;                                                                 \
    PyObject *a = cell_of(tensor_a), *b = cell_of(tensor_b),               \
             *c = cell_of(tensor_c);                                       \
    if (!a || !b || !c) LEAVE_RC(1);                                       \
    PyObject *c1 = int_list(contract_1, ncon1);                            \
    PyObject *n1 = int_list(notcontract_1, nncon1);                        \
    PyObject *c2 = int_list(contract_2, ncon2);                            \
    PyObject *n2 = int_list(notcontract_2, nncon2);                        \
    PyObject *m1 = int_list(map_1, nmap1);                                 \
    PyObject *m2 = int_list(map_2, nmap2);                                 \
    PyObject *b1 = int_list(bounds_1, bounds_1 ? 2 * ncon1 : 0);           \
    PyObject *b2 = int_list(bounds_2, bounds_2 ? 2 * nncon1 : 0);          \
    PyObject *b3 = int_list(bounds_3, bounds_3 ? 2 * nncon2 : 0);          \
    PyObject *r =                                                          \
        callv("t_contract", "(sddOOddOOOOOOOdOOO)", #SUF, ar, ai, a, b,    \
              br, bi, c, c1, n1, c2, n2, m1, m2, filter_eps, b1, b2, b3);  \
    Py_DECREF(c1);                                                         \
    Py_DECREF(n1);                                                         \
    Py_DECREF(c2);                                                         \
    Py_DECREF(n2);                                                         \
    Py_DECREF(m1);                                                         \
    Py_DECREF(m2);                                                         \
    Py_DECREF(b1);                                                         \
    Py_DECREF(b2);                                                         \
    Py_DECREF(b3);                                                         \
    if (!r) LEAVE_RC(1);                                                   \
    double fl = PyFloat_AsDouble(r);                                       \
    Py_DECREF(r);                                                          \
    if (PyErr_Occurred()) {                                                \
      set_err_from_python();                                               \
      LEAVE_RC(1);                                                         \
    }                                                                      \
    if (flop) *flop = fl;                                                  \
    LEAVE_RC(0);                                                           \
  }

T_CONTRACT(d) T_CONTRACT(s) T_CONTRACT(z) T_CONTRACT(c)

int c_dbcsr_t_contract_index(int64_t tensor_a, int64_t tensor_b,
                             int64_t tensor_c, const int *contract_1,
                             int ncon1, const int *notcontract_1, int nncon1,
                             const int *contract_2, int ncon2,
                             const int *notcontract_2, int nncon2,
                             int *nblks_out) {
  ENTER;
  PyObject *a = cell_of(tensor_a), *b = cell_of(tensor_b),
           *c = cell_of(tensor_c);
  if (!a || !b || !c) LEAVE_RC(1);
  PyObject *c1 = int_list(contract_1, ncon1);
  PyObject *n1 = int_list(notcontract_1, nncon1);
  PyObject *c2 = int_list(contract_2, ncon2);
  PyObject *n2 = int_list(notcontract_2, nncon2);
  PyObject *r =
      callv("t_contract_index", "(OOOOOOO)", a, b, c, c1, n1, c2, n2);
  Py_DECREF(c1);
  Py_DECREF(n1);
  Py_DECREF(c2);
  Py_DECREF(n2);
  return rc_int(st, r, nblks_out);
}

/* typed index-only contraction estimate (reference
 * src/tensors/dbcsr_tensor.h:82-87): fills result_index with the result
 * block coordinates (row-major [nblks, ndim_c], 0-based). */
#define T_CONTRACT_INDEX(SUF)                                              \
  int c_dbcsr_t_contract_index_##SUF(                                      \
      double alpha_re, double alpha_im, int64_t tensor_a,                  \
      int64_t tensor_b, double beta_re, double beta_im, int64_t tensor_c,  \
      const int *contract_1, int ncon1, const int *notcontract_1,          \
      int nncon1, const int *contract_2, int ncon2,                        \
      const int *notcontract_2, int nncon2, double filter_eps,             \
      int *nblks_out, int *result_index, int64_t result_index_size) {      \
    ENTER;                                                                 \
    PyObject *a = cell_of(tensor_a), *b = cell_of(tensor_b),               \
             *c = cell_of(tensor_c);                                       \
    if (!a || !b || !c) LEAVE_RC(1);                                       \
    PyObject *c1 = int_list(contract_1, ncon1);                            \
    PyObject *n1 = int_list(notcontract_1, nncon1);                        \
    PyObject *c2 = int_list(contract_2, ncon2);                            \
    PyObject *n2 = int_list(notcontract_2, nncon2);                        \
    PyObject *r = callv("t_contract_index_typed", "(sddOOddOOOOOdLL)",     \
                        #SUF, alpha_re, alpha_im, a, b, beta_re, beta_im,  \
                        c, c1, n1, c2, n2, filter_eps,                     \
                        (long long)(intptr_t)result_index,                 \
                        (long long)result_index_size);                     \
    Py_DECREF(c1);                                                         \
    Py_DECREF(n1);                                                         \
    Py_DECREF(c2);                                                         \
    Py_DECREF(n2);                                                         \
    return rc_int(st, r, nblks_out);                                       \
  }

T_CONTRACT_INDEX(d) T_CONTRACT_INDEX(s) T_CONTRACT_INDEX(z)
T_CONTRACT_INDEX(c)

int c_dbcsr_t_batched_contract_init(int64_t tensor, int64_t *state) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return finish_obj(st, callv("t_batched_contract_init", "(O)", t), state);
}

int c_dbcsr_t_batched_contract_finalize(int64_t *state) {
  {
    ENTER;
    PyObject *s = cell_of(*state);
    if (!s) LEAVE_RC(1);
    PyObject *r = callv("t_batched_contract_finalize", "(O)", s);
    if (!r) LEAVE_RC(1);
    Py_DECREF(r);
    PyGILState_Release(st);
  }
  int rc = c_dbcsr_release(*state);
  if (!rc) *state = 0;
  return rc;
}

/* ---------------- copy / conversions ---------------- */

int c_dbcsr_t_copy(int64_t tensor_from, int64_t tensor_to, int summation) {
  ENTER;
  PyObject *a = cell_of(tensor_from), *b = cell_of(tensor_to);
  if (!a || !b) LEAVE_RC(1);
  return rc_none(st, callv("t_copy", "(OOi)", a, b, summation));
}

int c_dbcsr_t_copy_matrix_to_tensor(int64_t matrix, int64_t tensor) {
  ENTER;
  PyObject *m = cell_of(matrix), *t = cell_of(tensor);
  if (!m || !t) LEAVE_RC(1);
  return rc_none(st, callv("t_copy_matrix_to_tensor", "(OO)", m, t));
}

int c_dbcsr_t_copy_tensor_to_matrix(int64_t tensor, int64_t matrix) {
  ENTER;
  PyObject *t = cell_of(tensor), *m = cell_of(matrix);
  if (!t || !m) LEAVE_RC(1);
  return rc_none(st, callv("t_copy_tensor_to_matrix", "(OO)", t, m));
}

/* ---------------- elementwise ---------------- */

int c_dbcsr_t_filter(int64_t tensor, double eps) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_none(st, callv("t_filter", "(Od)", t, eps));
}

/* typed filter (reference src/tensors/dbcsr_tensor.h:89-90): method must
 * be 1 (Frobenius); use_absolute nonzero scales eps by the tensor's
 * maxabs norm, mirroring the reference's PRESENT(use_absolute) path. */
#define T_FILTER(SUF)                                                      \
  int c_dbcsr_t_filter_##SUF(int64_t tensor, double eps, int method,       \
                             int use_absolute) {                           \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("t_filter", "(Odii)", t, eps, method,         \
                             use_absolute));                               \
  }

T_FILTER(d) T_FILTER(s) T_FILTER(z) T_FILTER(c)

#define T_SCALAR_FN(CNAME, PYNAME)                                         \
  int CNAME(int64_t tensor, const char *typ, double re, double im) {       \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    return rc_none(st, callv(PYNAME, "(Osdd)", t, typ, re, im));           \
  }

T_SCALAR_FN(c_dbcsr_t_scale_any, "t_scale")
T_SCALAR_FN(c_dbcsr_t_set_any, "t_set")

#define T_SCALE(SUF)                                                       \
  int c_dbcsr_t_scale_##SUF(int64_t tensor, double re, double im) {        \
    return c_dbcsr_t_scale_any(tensor, #SUF, re, im);                      \
  }                                                                        \
  int c_dbcsr_t_set_##SUF(int64_t tensor, double re, double im) {          \
    return c_dbcsr_t_set_any(tensor, #SUF, re, im);                        \
  }

T_SCALE(d) T_SCALE(s) T_SCALE(z) T_SCALE(c)

int c_dbcsr_t_clear(int64_t tensor) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_none(st, callv("t_clear", "(O)", t));
}

/* ---------------- iterator ---------------- */

int c_dbcsr_t_iterator_start(int64_t *iterator, int64_t tensor) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return finish_obj(st, callv("t_iterator_start", "(O)", t), iterator);
}

int c_dbcsr_t_iterator_blocks_left(int64_t iterator, int *left) {
  ENTER;
  PyObject *it = cell_of(iterator);
  if (!it) LEAVE_RC(1);
  return rc_int(st, callv("t_iterator_blocks_left", "(O)", it), left);
}

#define T_ITER_NEXT(SUF, CTYPE)                                            \
  int c_dbcsr_t_iterator_next_block_##SUF(int64_t iterator, int *index,    \
                                          CTYPE *block, int *sizes,        \
                                          int ndim) {                      \
    ENTER;                                                                 \
    PyObject *it = cell_of(iterator);                                      \
    if (!it) LEAVE_RC(1);                                                  \
    PyObject *r = callv("t_iterator_next_block", "(OsL)", it, #SUF,        \
                        (long long)(intptr_t)block);                       \
    if (!r) LEAVE_RC(1);                                                   \
    PyObject *bi, *shp;                                                    \
    if (!PyArg_ParseTuple(r, "OO", &bi, &shp)) {                           \
      set_err_from_python();                                               \
      Py_DECREF(r);                                                        \
      LEAVE_RC(1);                                                         \
    }                                                                      \
    if (index) parse_int_list(bi, index, ndim);                            \
    if (sizes) parse_int_list(shp, sizes, ndim);                           \
    Py_DECREF(r);                                                          \
    LEAVE_RC(0);                                                           \
  }

T_ITER_NEXT(d, double)
T_ITER_NEXT(s, float)
T_ITER_NEXT(z, double)
T_ITER_NEXT(c, float)

int c_dbcsr_t_iterator_stop(int64_t *iterator) {
  {
    ENTER;
    PyObject *it = cell_of(*iterator);
    if (!it) LEAVE_RC(1);
    PyObject *r = callv("t_iterator_stop", "(O)", it);
    if (!r) LEAVE_RC(1);
    Py_DECREF(r);
    PyGILState_Release(st);
  }
  int rc = c_dbcsr_release(*iterator);
  if (!rc) *iterator = 0;
  return rc;
}

/* ---------------- info ---------------- */

#define T_INT_FN(CNAME, PYNAME)                                            \
  int CNAME(int64_t tensor, int *out) {                                    \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    return rc_int(st, callv(PYNAME, "(O)", t), out);                       \
  }

T_INT_FN(c_dbcsr_t_ndims, "t_ndims")
T_INT_FN(c_dbcsr_t_get_num_blocks, "t_get_num_blocks")
T_INT_FN(c_dbcsr_t_get_num_blocks_total, "t_get_num_blocks_total")
T_INT_FN(c_dbcsr_t_max_nblks_local, "t_max_nblks_local")
T_INT_FN(c_dbcsr_t_ndims_matrix_row, "t_ndims_matrix_row")
T_INT_FN(c_dbcsr_t_ndims_matrix_column, "t_ndims_matrix_column")

int c_dbcsr_t_get_nze(int64_t tensor, int64_t *out) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_i64(st, callv("t_get_nze", "(O)", t), out);
}

int c_dbcsr_t_get_nze_total(int64_t tensor, int64_t *out) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_i64(st, callv("t_get_nze_total", "(O)", t), out);
}

#define T_LIST_FN(CNAME, PYNAME)                                           \
  int CNAME(int64_t tensor, int *out, int maxn) {                          \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    PyObject *r = callv(PYNAME, "(O)", t);                                 \
    if (!r) LEAVE_RC(1);                                                   \
    parse_int_list(r, out, maxn);                                          \
    Py_DECREF(r);                                                          \
    LEAVE_RC(0);                                                           \
  }

T_LIST_FN(c_dbcsr_t_dims, "t_dims")
T_LIST_FN(c_dbcsr_t_get_nd_index, "t_get_nd_index")
T_LIST_FN(c_dbcsr_t_get_nd_index_blk, "t_get_nd_index_blk")

int c_dbcsr_t_nblks_total(int64_t tensor, int dim, int *out) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_int(st, callv("t_nblks_total", "(Oi)", t, dim), out);
}

int c_dbcsr_t_nblks_local(int64_t tensor, int dim, int *out) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_int(st, callv("t_nblks_local", "(Oi)", t, dim), out);
}

int c_dbcsr_t_get_stored_coordinates(int64_t tensor, int ndim,
                                     const int *index, int *processor) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_int(st,
                callv("t_get_stored_coordinates", "(OiL)", t, ndim,
                      (long long)(intptr_t)index),
                processor);
}

int c_dbcsr_t_get_mapping_info(int64_t tensor, int *map1, int *nmap1,
                               int *map2, int *nmap2) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  PyObject *r = callv("t_get_mapping_info", "(O)", t);
  if (!r) LEAVE_RC(1);
  PyObject *m1, *m2;
  if (!PyArg_ParseTuple(r, "OO", &m1, &m2)) {
    set_err_from_python();
    Py_DECREF(r);
    LEAVE_RC(1);
  }
  *nmap1 = parse_int_list(m1, map1, 16);
  *nmap2 = parse_int_list(m2, map2, 16);
  Py_DECREF(r);
  LEAVE_RC(0);
}

int c_dbcsr_t_get_info(int64_t tensor, int *ndim, int *dims, int *nblks,
                       int *data_type) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  PyObject *r = callv("t_get_info", "(O)", t);
  if (!r) LEAVE_RC(1);
  PyObject *d1, *d2;
  if (!PyArg_ParseTuple(r, "iOOi", ndim, &d1, &d2, data_type)) {
    set_err_from_python();
    Py_DECREF(r);
    LEAVE_RC(1);
  }
  if (dims) parse_int_list(d1, dims, *ndim);
  if (nblks) parse_int_list(d2, nblks, *ndim);
  Py_DECREF(r);
  LEAVE_RC(0);
}

#define T_GET_DATA(SUF, CTYPE)                                             \
  int c_dbcsr_t_get_data_##SUF(int64_t tensor, CTYPE *data, int size,      \
                               int64_t *data_size) {                       \
    ENTER;                                                                 \
    PyObject *t = cell_of(tensor);                                         \
    if (!t) LEAVE_RC(1);                                                   \
    return rc_i64(st,                                                      \
                  callv("t_get_data_p", "(OsLi)", t, #SUF,                 \
                        (long long)(intptr_t)data, size),                  \
                  data_size);                                              \
  }

T_GET_DATA(d, double)
T_GET_DATA(s, float)
T_GET_DATA(z, double)
T_GET_DATA(c, float)

int c_dbcsr_t_split_blocks(int64_t tensor, int ndim, const int *factors) {
  ENTER;
  PyObject *t = cell_of(tensor);
  if (!t) LEAVE_RC(1);
  return rc_none(st, callv("t_split_blocks", "(OiL)", t, ndim,
                           (long long)(intptr_t)factors));
}
