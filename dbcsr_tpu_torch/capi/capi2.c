/* Reference-parity C API surface (v2) — the full `c_dbcsr_*` +
 * `c_dbcsr_t_*` function set of the reference C bindings
 * (DBCSR's `src/dbcsr.h`, `src/tensors/dbcsr_tensor.h`),
 * implemented over dbcsr_tpu_torch.capi.himpl (mutating Cell handles).
 * #included from capi.c — shares the handle table and plumbing.
 *
 * Conventions (documented deviations from the reference):
 *  - handles are int64 (0 = none) instead of void*; every function
 *    returns int (0 ok / nonzero error, message via c_dbcsr_last_error)
 *    instead of void — embedders get real error reporting;
 *  - MPI communicators are plain ints, accepted and ignored (the device
 *    comes from DBCSR_CAPI_DEVICE in dbcsr_tpu_torch);
 *  - pointer-returning accessors (get_block_p / get_data) COPY into
 *    caller buffers (device storage has no stable element addresses).
 */

static PyObject *g_himpl = NULL;

static PyObject *callv(const char *name, const char *fmt, ...) {
  if (!g_himpl) {
    g_himpl = PyImport_ImportModule(DBCSR_PY_PACKAGE ".capi.himpl");
    if (!g_himpl) {
      set_err_from_python();
      return NULL;
    }
  }
  PyObject *meth = PyObject_GetAttrString(g_himpl, name);
  if (!meth) {
    set_err_from_python();
    return NULL;
  }
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (!args) {
    Py_DECREF(meth);
    set_err_from_python();
    return NULL;
  }
  if (!PyTuple_Check(args)) {
    PyObject *t = PyTuple_Pack(1, args);
    Py_DECREF(args);
    args = t;
  }
  PyObject *r = PyObject_CallObject(meth, args);
  Py_DECREF(args);
  Py_DECREF(meth);
  if (!r) set_err_from_python();
  return r;
}

/* handle -> Cell object (borrowed); error recorded on failure */
static PyObject *cell_of(int64_t h) { return get_handle(h); }

/* optional handle: 0 -> Py_None (borrowed) */
static PyObject *cell_opt(int64_t h) { return h ? get_handle(h) : Py_None; }

static int rc_none(PyGILState_STATE st, PyObject *r) {
  if (!r) {
    PyGILState_Release(st);
    return 1;
  }
  Py_DECREF(r);
  PyGILState_Release(st);
  return 0;
}

static int rc_i64(PyGILState_STATE st, PyObject *r, int64_t *out) {
  if (!r) {
    PyGILState_Release(st);
    return 1;
  }
  *out = PyLong_AsLongLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    set_err_from_python();
    PyGILState_Release(st);
    return 1;
  }
  PyGILState_Release(st);
  return 0;
}

static int rc_int(PyGILState_STATE st, PyObject *r, int *out) {
  int64_t v;
  int rc = rc_i64(st, r, &v);
  if (!rc) *out = (int)v;
  return rc;
}

static int rc_cmplx(PyGILState_STATE st, PyObject *r, double *re,
                    double *im) {
  if (!r) {
    PyGILState_Release(st);
    return 1;
  }
  Py_complex c = PyComplex_AsCComplex(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    set_err_from_python();
    PyGILState_Release(st);
    return 1;
  }
  *re = c.real;
  if (im) *im = c.imag;
  PyGILState_Release(st);
  return 0;
}

/* ---------------- lifecycle ---------------- */

int c_dbcsr_init_lib_internal(int comm, int io_unit) {
  if (c_dbcsr_init_lib()) return 1; /* embeds python + imports helpers */
  ENTER;
  return rc_none(st, callv("init_lib", "(ii)", comm, io_unit));
}

int c_dbcsr_clear_mempools(void) {
  ENTER;
  return rc_none(st, callv("clear_mempools", "()"));
}

int c_dbcsr_print_statistics(int print_timers, const char *callgraph_file) {
  ENTER;
  return rc_none(st, callv("print_statistics", "(is)", print_timers,
                           callgraph_file ? callgraph_file : ""));
}

int c_dbcsr_mp_grid_setup(int64_t dist) {
  ENTER;
  PyObject *d = cell_of(dist);
  if (!d) LEAVE_RC(1);
  return rc_none(st, callv("mp_grid_setup", "(O)", d));
}

/* ---------------- distribution ---------------- */

int c_dbcsr_distribution_new(int64_t *dist, int comm, const int *row_dist,
                             int row_dist_size, const int *col_dist,
                             int col_dist_size) {
  ENTER;
  PyObject *r =
      callv("distribution_new", "(iLiLi)", comm,
            (long long)(intptr_t)row_dist, row_dist_size,
            (long long)(intptr_t)col_dist, col_dist_size);
  return finish_obj(st, r, dist);
}

int c_dbcsr_distribution_hold(int64_t dist) {
  ENTER;
  PyObject *d = cell_of(dist);
  if (!d) LEAVE_RC(1);
  return rc_none(st, callv("distribution_hold", "(O)", d));
}

int c_dbcsr_distribution_release(int64_t *dist) {
  int rc = c_dbcsr_release(*dist);
  if (!rc) *dist = 0;
  return rc;
}

int c_dbcsr_distribution_get(int64_t dist, int *nprow, int *npcol,
                             int *nrows, int *ncols) {
  ENTER;
  PyObject *d = cell_of(dist);
  if (!d) LEAVE_RC(1);
  PyObject *r = callv("distribution_get", "(O)", d);
  if (!r) LEAVE_RC(1);
  int ok = PyArg_ParseTuple(r, "iiii", nprow, npcol, nrows, ncols);
  Py_DECREF(r);
  if (!ok) {
    set_err_from_python();
    LEAVE_RC(1);
  }
  LEAVE_RC(0);
}

/* ---------------- create / finalize / release ---------------- */

int c_dbcsr_create_new(int64_t *matrix, const char *name, int64_t dist,
                       char matrix_type, const int *row_blk_size,
                       int row_size, const int *col_blk_size, int col_size,
                       int data_type) {
  ENTER;
  char mt[2] = {matrix_type, 0};
  PyObject *r = callv("create_new", "(sOsLiLii)", name, cell_opt(dist), mt,
                      (long long)(intptr_t)row_blk_size, row_size,
                      (long long)(intptr_t)col_blk_size, col_size,
                      data_type);
  return finish_obj(st, r, matrix);
}

int c_dbcsr_create_template(int64_t *matrix, const char *name,
                            int64_t template_, int64_t dist,
                            char matrix_type, int data_type) {
  ENTER;
  PyObject *t = cell_of(template_);
  if (!t) LEAVE_RC(1);
  char mt[2] = {matrix_type, 0};
  PyObject *r = callv("create_template", "(OsOsi)", t, name,
                      cell_opt(dist), mt, data_type);
  return finish_obj(st, r, matrix);
}

int c_dbcsr_finalize(int64_t matrix) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("finalize", "(O)", m));
}

int c_dbcsr_release_p(int64_t *matrix) {
  int rc = c_dbcsr_release(*matrix);
  if (!rc) *matrix = 0;
  return rc;
}

/* ---------------- block assembly / access ---------------- */

#define PUT_BLOCK2D(SUF, CTYPE)                                            \
  int c_dbcsr_put_block2d_##SUF(int64_t matrix, int row, int col,          \
                                const CTYPE *block, int m, int n,          \
                                int summation) {                           \
    ENTER;                                                                 \
    PyObject *mo = cell_of(matrix);                                        \
    if (!mo) LEAVE_RC(1);                                                  \
    return rc_none(st, callv("put_block2d", "(OsiiLiii)", mo, #SUF, row,   \
                             col, (long long)(intptr_t)block, m, n,        \
                             summation));                                  \
  }

PUT_BLOCK2D(d, double)
PUT_BLOCK2D(s, float)
PUT_BLOCK2D(z, double)
PUT_BLOCK2D(c, float)

#define GET_BLOCK_P(SUF, CTYPE)                                            \
  int c_dbcsr_get_block_p_##SUF(int64_t matrix, int row, int col,          \
                                CTYPE *block, int *found, int *row_size,   \
                                int *col_size) {                           \
    ENTER;                                                                 \
    PyObject *mo = cell_of(matrix);                                        \
    if (!mo) LEAVE_RC(1);                                                  \
    PyObject *r = callv("get_block_p", "(OsiiL)", mo, #SUF, row, col,      \
                        (long long)(intptr_t)block);                       \
    if (!r) LEAVE_RC(1);                                                   \
    int ok = PyArg_ParseTuple(r, "iii", found, row_size, col_size);        \
    Py_DECREF(r);                                                          \
    if (!ok) {                                                             \
      set_err_from_python();                                               \
      LEAVE_RC(1);                                                         \
    }                                                                      \
    LEAVE_RC(0);                                                           \
  }

GET_BLOCK_P(d, double)
GET_BLOCK_P(s, float)
GET_BLOCK_P(z, double)
GET_BLOCK_P(c, float)

int c_dbcsr_reserve_block2d(int64_t matrix, int row, int col) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("reserve_block2d", "(Oii)", m, row, col));
}

int c_dbcsr_reserve_blocks(int64_t matrix, const int *rows, const int *cols,
                           int n) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("reserve_blocks", "(OLLi)", m,
                           (long long)(intptr_t)rows,
                           (long long)(intptr_t)cols, n));
}

int c_dbcsr_reserve_all_blocks(int64_t matrix) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("reserve_all_blocks", "(O)", m));
}

int c_dbcsr_reserve_diag_blocks(int64_t matrix) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("reserve_diag_blocks", "(O)", m));
}

/* ---------------- iterators ---------------- */

int c_dbcsr_iterator_start(int64_t *iterator, int64_t matrix) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_obj(st, callv("iterator_start", "(O)", m), iterator);
}

int c_dbcsr_iterator_blocks_left(int64_t iterator, int *left) {
  ENTER;
  PyObject *it = cell_of(iterator);
  if (!it) LEAVE_RC(1);
  return rc_int(st, callv("iterator_blocks_left", "(O)", it), left);
}

int c_dbcsr_iterator_next_block_index(int64_t iterator, int *row, int *col,
                                      int *blk_size) {
  ENTER;
  PyObject *it = cell_of(iterator);
  if (!it) LEAVE_RC(1);
  PyObject *r = callv("iterator_next_block_index", "(O)", it);
  if (!r) LEAVE_RC(1);
  int ok = PyArg_ParseTuple(r, "iii", row, col, blk_size);
  Py_DECREF(r);
  if (!ok) {
    set_err_from_python();
    LEAVE_RC(1);
  }
  LEAVE_RC(0);
}

#define ITER_NEXT_2D(SUF, CTYPE)                                           \
  int c_dbcsr_iterator_next_2d_block_##SUF(                                \
      int64_t iterator, int *row, int *col, CTYPE *block, int *row_size,   \
      int *col_size) {                                                     \
    ENTER;                                                                 \
    PyObject *it = cell_of(iterator);                                      \
    if (!it) LEAVE_RC(1);                                                  \
    PyObject *r = callv("iterator_next_2d_block", "(OsL)", it, #SUF,       \
                        (long long)(intptr_t)block);                       \
    if (!r) LEAVE_RC(1);                                                   \
    int ok = PyArg_ParseTuple(r, "iiii", row, col, row_size, col_size);    \
    Py_DECREF(r);                                                          \
    if (!ok) {                                                             \
      set_err_from_python();                                               \
      LEAVE_RC(1);                                                         \
    }                                                                      \
    LEAVE_RC(0);                                                           \
  }

ITER_NEXT_2D(d, double)
ITER_NEXT_2D(s, float)
ITER_NEXT_2D(z, double)
ITER_NEXT_2D(c, float)

int c_dbcsr_iterator_stop(int64_t *iterator) {
  {
    ENTER;
    PyObject *it = cell_of(*iterator);
    if (!it) LEAVE_RC(1);
    PyObject *r = callv("iterator_stop", "(O)", it);
    if (!r) LEAVE_RC(1);
    Py_DECREF(r);
    PyGILState_Release(st);
  }
  int rc = c_dbcsr_release(*iterator);
  if (!rc) *iterator = 0;
  return rc;
}

/* ---------------- typed primitive ops ---------------- */

#define SET_FN(SUF)                                                        \
  int c_dbcsr_set_##SUF(int64_t matrix, double re, double im) {            \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("set_value", "(Osdd)", m, #SUF, re, im));     \
  }

SET_FN(d) SET_FN(s) SET_FN(z) SET_FN(c)

#define ADD_FN(SUF)                                                        \
  int c_dbcsr_add_##SUF(int64_t matrix_a, int64_t matrix_b, double ar,     \
                        double ai, double br, double bi) {                 \
    ENTER;                                                                 \
    PyObject *a = cell_of(matrix_a), *b = cell_of(matrix_b);               \
    if (!a || !b) LEAVE_RC(1);                                             \
    return rc_none(                                                        \
        st, callv("add", "(OOsdddd)", a, b, #SUF, ar, ai, br, bi));        \
  }

ADD_FN(d) ADD_FN(s) ADD_FN(z) ADD_FN(c)

#define SCALE_FN(SUF)                                                      \
  int c_dbcsr_scale_##SUF(int64_t matrix, double re, double im) {          \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("scale", "(Osdd)", m, #SUF, re, im));         \
  }

SCALE_FN(d) SCALE_FN(s) SCALE_FN(z) SCALE_FN(c)

#define SCALE_VEC_FN(SUF, CTYPE)                                           \
  int c_dbcsr_scale_by_vector_##SUF(int64_t matrix, const CTYPE *alpha,    \
                                    int alpha_size, const char *side) {    \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("scale_by_vector", "(OsLis)", m, #SUF,        \
                             (long long)(intptr_t)alpha, alpha_size,       \
                             side));                                       \
  }

SCALE_VEC_FN(d, double)
SCALE_VEC_FN(s, float)
SCALE_VEC_FN(z, double)
SCALE_VEC_FN(c, float)

#define MULTIPLY_FN(SUF)                                                   \
  int c_dbcsr_multiply_##SUF(char transa, char transb, double ar,          \
                             double ai, int64_t matrix_a, int64_t matrix_b,\
                             double br, double bi, int64_t matrix_c,       \
                             int retain_sparsity, double filter_eps,       \
                             double *flop) {                               \
    ENTER;                                                                 \
    PyObject *a = cell_of(matrix_a), *b = cell_of(matrix_b),               \
             *c = cell_of(matrix_c);                                       \
    if (!a || !b || !c) LEAVE_RC(1);                                       \
    char ta[2] = {transa, 0}, tb[2] = {transb, 0};                         \
    PyObject *r = callv("multiply", "(sssddOOddOid)", #SUF, ta, tb, ar,    \
                        ai, a, b, br, bi, c, retain_sparsity, filter_eps); \
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

MULTIPLY_FN(d) MULTIPLY_FN(s) MULTIPLY_FN(z) MULTIPLY_FN(c)

#define TRACE_FN(SUF)                                                      \
  int c_dbcsr_trace_##SUF(int64_t matrix, double *re, double *im) {        \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_cmplx(st, callv("trace", "(O)", m), re, im);                 \
  }

TRACE_FN(d) TRACE_FN(s) TRACE_FN(z) TRACE_FN(c)

#define DOT_FN(SUF)                                                        \
  int c_dbcsr_dot_##SUF(int64_t matrix_a, int64_t matrix_b, double *re,    \
                        double *im) {                                      \
    ENTER;                                                                 \
    PyObject *a = cell_of(matrix_a), *b = cell_of(matrix_b);               \
    if (!a || !b) LEAVE_RC(1);                                             \
    return rc_cmplx(st, callv("dot", "(OO)", a, b), re, im);               \
  }

DOT_FN(d) DOT_FN(s) DOT_FN(z) DOT_FN(c)

#define GET_DIAG_FN(SUF, CTYPE)                                            \
  int c_dbcsr_get_diag_##SUF(int64_t matrix, CTYPE *diag, int size) {      \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("get_diag", "(OsLi)", m, #SUF,                \
                             (long long)(intptr_t)diag, size));            \
  }

GET_DIAG_FN(d, double)
GET_DIAG_FN(s, float)
GET_DIAG_FN(z, double)
GET_DIAG_FN(c, float)

#define SET_DIAG_FN(SUF, CTYPE)                                            \
  int c_dbcsr_set_diag_##SUF(int64_t matrix, const CTYPE *diag,            \
                             int size) {                                   \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("set_diag", "(OsLi)", m, #SUF,                \
                             (long long)(intptr_t)diag, size));            \
  }

SET_DIAG_FN(d, double)
SET_DIAG_FN(s, float)
SET_DIAG_FN(z, double)
SET_DIAG_FN(c, float)

#define ADD_ON_DIAG_FN(SUF)                                                \
  int c_dbcsr_add_on_diag_##SUF(int64_t matrix, double re, double im) {    \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("add_on_diag", "(Osdd)", m, #SUF, re, im));   \
  }

ADD_ON_DIAG_FN(d) ADD_ON_DIAG_FN(s) ADD_ON_DIAG_FN(z) ADD_ON_DIAG_FN(c)

#define GET_DATA_FN(SUF, CTYPE)                                            \
  int c_dbcsr_get_data_##SUF(int64_t matrix, CTYPE *data, int size,        \
                             int64_t *data_size) {                         \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_i64(st,                                                      \
                  callv("get_data", "(OsLi)", m, #SUF,                     \
                        (long long)(intptr_t)data, size),                  \
                  data_size);                                              \
  }

GET_DATA_FN(d, double)
GET_DATA_FN(s, float)
GET_DATA_FN(z, double)
GET_DATA_FN(c, float)

/* ---------------- untyped ops ---------------- */

#define VOID1(CNAME, PYNAME)                                               \
  int CNAME(int64_t matrix) {                                              \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv(PYNAME, "(O)", m));                           \
  }

VOID1(c_dbcsr_clear, "clear")
VOID1(c_dbcsr_triu, "triu")
VOID1(c_dbcsr_replicate_all, "replicate_all")
VOID1(c_dbcsr_sum_replicated, "sum_replicated")
VOID1(c_dbcsr_print, "print_matrix")
VOID1(c_dbcsr_print_block_sum, "print_block_sum")

#define SCALAR1(CNAME, PYNAME)                                             \
  int CNAME(int64_t matrix, double *out) {                                 \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return finish_f64(st, callv(PYNAME, "(O)", m), out);                   \
  }

SCALAR1(c_dbcsr_frobenius_norm, "frobenius_norm")
SCALAR1(c_dbcsr_gershgorin_norm, "gershgorin_norm")
SCALAR1(c_dbcsr_maxabs, "maxabs")
SCALAR1(c_dbcsr_get_occupation, "get_occupation")

#define INT1(CNAME, PYNAME)                                                \
  int CNAME(int64_t matrix, int *out) {                                    \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_int(st, callv(PYNAME, "(O)", m), out);                       \
  }

INT1(c_dbcsr_get_data_type, "get_data_type")
INT1(c_dbcsr_get_num_blocks, "get_num_blocks")
INT1(c_dbcsr_nblkrows_total, "nblkrows_total")
INT1(c_dbcsr_nblkcols_total, "nblkcols_total")
INT1(c_dbcsr_nblkrows_local, "nblkrows_local")
INT1(c_dbcsr_nblkcols_local, "nblkcols_local")
INT1(c_dbcsr_nfullrows_total, "nfullrows_total")
INT1(c_dbcsr_nfullcols_total, "nfullcols_total")
INT1(c_dbcsr_valid_index, "valid_index")
INT1(c_dbcsr_has_symmetry, "has_symmetry")
INT1(c_dbcsr_get_group, "get_group")

int c_dbcsr_get_data_size(int64_t matrix, int64_t *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_i64(st, callv("get_data_size", "(O)", m), out);
}

int c_dbcsr_get_matrix_type(int64_t matrix, char *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  PyObject *r = callv("get_matrix_type", "(O)", m);
  if (!r) LEAVE_RC(1);
  const char *s = PyUnicode_AsUTF8(r);
  *out = s && s[0] ? s[0] : 'N';
  Py_DECREF(r);
  LEAVE_RC(0);
}

int c_dbcsr_get_name(int64_t matrix, char *out, int maxlen) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  PyObject *r = callv("get_name", "(O)", m);
  if (!r) LEAVE_RC(1);
  const char *s = PyUnicode_AsUTF8(r);
  snprintf(out, (size_t)maxlen, "%s", s ? s : "");
  Py_DECREF(r);
  LEAVE_RC(0);
}

int c_dbcsr_setname(int64_t matrix, const char *name) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("setname", "(Os)", m, name));
}

int c_dbcsr_get_info(int64_t matrix, int *nblkrows, int *nblkcols,
                     int *nfullrows, int *nfullcols, int *nblks) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  PyObject *r = callv("get_info", "(O)", m);
  if (!r) LEAVE_RC(1);
  int ok = PyArg_ParseTuple(r, "iiiii", nblkrows, nblkcols, nfullrows,
                            nfullcols, nblks);
  Py_DECREF(r);
  if (!ok) {
    set_err_from_python();
    LEAVE_RC(1);
  }
  LEAVE_RC(0);
}

/* the reference's ${var}$-stamped info arrays (dbcsr.h:282-287): block
 * sizes, 0-based element offsets, distribution maps; local rows/cols ==
 * all rows/cols on one controller. Copies min(size, len) ints. */
#define INFOVAR_FN(NAME)                                                   \
  int c_dbcsr_get_##NAME(int64_t matrix, int *out, int size) {             \
    ENTER;                                                                 \
    PyObject *m = cell_of(matrix);                                         \
    if (!m) LEAVE_RC(1);                                                   \
    return rc_none(st, callv("get_infovar", "(OsLi)", m, #NAME,            \
                             (long long)(intptr_t)out, size));             \
  }

INFOVAR_FN(local_rows)
INFOVAR_FN(local_cols)
INFOVAR_FN(proc_row_dist)
INFOVAR_FN(proc_col_dist)
INFOVAR_FN(row_blk_size)
INFOVAR_FN(col_blk_size)
INFOVAR_FN(row_blk_offset)
INFOVAR_FN(col_blk_offset)

int c_dbcsr_get_stored_coordinates(int64_t matrix, int row, int col,
                                   int *processor) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_int(st, callv("get_stored_coordinates", "(Oii)", m, row, col),
                processor);
}

int c_dbcsr_get_distribution(int64_t matrix, int64_t *dist) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_obj(st, callv("get_distribution", "(O)", m), dist);
}

int c_dbcsr_filter(int64_t matrix, double eps) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("filter_matrix", "(Od)", m, eps));
}

int c_dbcsr_function_of_elements(int64_t matrix, int func, double a0,
                                 double a1, double a2) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("function_of_elements", "(Oiddd)", m, func, a0,
                           a1, a2));
}

int c_dbcsr_hadamard_product(int64_t matrix_a, int64_t matrix_b,
                             int64_t matrix_c) {
  ENTER;
  PyObject *a = cell_of(matrix_a), *b = cell_of(matrix_b),
           *c = cell_of(matrix_c);
  if (!a || !b || !c) LEAVE_RC(1);
  return rc_none(st, callv("hadamard_product", "(OOO)", a, b, c));
}

int c_dbcsr_init_random(int64_t matrix, int keep_sparsity) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("init_random", "(Oi)", m, keep_sparsity));
}

int c_dbcsr_copy(int64_t matrix_b, int64_t matrix_a, const char *name) {
  ENTER;
  PyObject *b = cell_of(matrix_b), *a = cell_of(matrix_a);
  if (!a || !b) LEAVE_RC(1);
  return rc_none(st, callv("copy", "(OOs)", b, a, name ? name : ""));
}

int c_dbcsr_copy_into_existing(int64_t matrix_b, int64_t matrix_a) {
  ENTER;
  PyObject *b = cell_of(matrix_b), *a = cell_of(matrix_a);
  if (!a || !b) LEAVE_RC(1);
  return rc_none(st, callv("copy_into_existing", "(OO)", b, a));
}

int c_dbcsr_desymmetrize(int64_t matrix, int64_t *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_obj(st, callv("desymmetrize", "(O)", m), out);
}

int c_dbcsr_transposed(int64_t matrix, int64_t *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_obj(st, callv("transposed", "(O)", m), out);
}

int c_dbcsr_get_block_diag(int64_t matrix, int64_t *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_obj(st, callv("get_block_diag", "(O)", m), out);
}

int c_dbcsr_complete_redistribute(int64_t matrix, int64_t dist,
                                  int64_t *out) {
  ENTER;
  PyObject *m = cell_of(matrix), *d = cell_of(dist);
  if (!m || !d) LEAVE_RC(1);
  return finish_obj(st, callv("complete_redistribute", "(OO)", m, d), out);
}

int c_dbcsr_distribute(int64_t matrix, int64_t dist) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("distribute", "(OO)", m, cell_opt(dist)));
}

int c_dbcsr_norm_scalar(int64_t matrix, int which, double *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_f64(st, callv("norm_scalar", "(Oi)", m, which), out);
}

int c_dbcsr_checksum(int64_t matrix, int pos, double *out) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return finish_f64(st, callv("checksum", "(Oi)", m, pos), out);
}

int c_dbcsr_binary_write(int64_t matrix, const char *filepath) {
  ENTER;
  PyObject *m = cell_of(matrix);
  if (!m) LEAVE_RC(1);
  return rc_none(st, callv("binary_write", "(Os)", m, filepath));
}

int c_dbcsr_binary_read(const char *filepath, int64_t dist,
                           int64_t *matrix) {
  ENTER;
  (void)dist; /* distribution attach is metadata-only here */
  return finish_obj(st, callv("binary_read", "(s)", filepath), matrix);
}
