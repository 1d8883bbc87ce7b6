/* C API shim implementation: embeds CPython and forwards every call to
 * dbcsr_tpu_torch.capi.helpers (which marshals buffers and calls the public
 * Python API). See dbcsr_tpu.h for the surface and the reference analogy
 * (`src/dbcsr.h` + `src/dbcsr_api_c.F`).
 *
 * Handle table: int64 handle -> owned PyObject* (builders and matrices),
 * with a free list; handle 0 is reserved for "none". All entry points
 * acquire the GIL, so the shim is callable from any thread.
 */
#include <Python.h>

#include <stdarg.h>
#include <stdio.h>
#include <string.h>

#include "dbcsr_tpu.h"

/* the Python package behind the shim */
#define DBCSR_PY_PACKAGE "dbcsr_tpu_torch"

static PyObject **g_obj = NULL;
static int64_t g_cap = 0;
static int64_t *g_free = NULL;
static int64_t g_nfree = 0;
static PyObject *g_helpers = NULL;
static char g_err[4096] = "";
static int g_we_initialized = 0;

const char *c_dbcsr_last_error(void) { return g_err; }

static void set_err_from_python(void) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  const char *msg = "unknown error";
  PyObject *s = value ? PyObject_Str(value) : NULL;
  if (s) msg = PyUnicode_AsUTF8(s);
  snprintf(g_err, sizeof(g_err), "%s", msg ? msg : "unknown error");
  Py_XDECREF(s);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

static int64_t put_handle(PyObject *o) { /* steals the reference */
  if (g_nfree > 0) {
    int64_t h = g_free[--g_nfree];
    g_obj[h - 1] = o;
    return h;
  }
  int64_t ncap = g_cap ? 2 * g_cap : 64;
  PyObject **nobj =
      (PyObject **)realloc(g_obj, (size_t)ncap * sizeof(PyObject *));
  int64_t *nfree =
      (int64_t *)realloc(g_free, (size_t)ncap * sizeof(int64_t));
  if (!nobj || !nfree) {
    /* keep the old (still valid) tables; report failure as handle 0 */
    if (nobj) g_obj = nobj;
    if (nfree) g_free = nfree;
    Py_DECREF(o);
    snprintf(g_err, sizeof(g_err), "out of memory growing handle table");
    return 0;
  }
  g_obj = nobj;
  g_free = nfree;
  memset(g_obj + g_cap, 0, (size_t)(ncap - g_cap) * sizeof(PyObject *));
  for (int64_t i = ncap; i > g_cap; --i) g_free[g_nfree++] = i;
  g_cap = ncap;
  return put_handle(o);
}

static PyObject *get_handle(int64_t h) {
  if (h <= 0 || h > g_cap || g_obj[h - 1] == NULL) {
    snprintf(g_err, sizeof(g_err), "invalid handle %lld", (long long)h);
    return NULL;
  }
  return g_obj[h - 1];
}

int c_dbcsr_release(int64_t h) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *o = get_handle(h);
  if (!o) {
    PyGILState_Release(st);
    return 1;
  }
  Py_DECREF(o);
  g_obj[h - 1] = NULL;
  g_free[g_nfree++] = h;
  PyGILState_Release(st);
  return 0;
}

int c_dbcsr_init_lib(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = 1;
    /* release the GIL owned by this thread post-init so every entry
     * point can use PyGILState_Ensure uniformly */
    PyEval_SaveThread();
  }
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = 0;
  if (!g_helpers) g_helpers = PyImport_ImportModule(DBCSR_PY_PACKAGE ".capi.helpers");
  if (!g_helpers) {
    set_err_from_python();
    rc = 1;
  } else {
    PyObject *r = PyObject_CallMethod(g_helpers, "init_lib", NULL);
    if (!r) {
      set_err_from_python();
      rc = 1;
    }
    Py_XDECREF(r);
  }
  PyGILState_Release(st);
  return rc;
}

int c_dbcsr_finalize_lib(void) {
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = 0;
  if (g_helpers) {
    PyObject *r = PyObject_CallMethod(g_helpers, "finalize_lib", NULL);
    if (!r) {
      set_err_from_python();
      rc = 1;
    }
    Py_XDECREF(r);
  }
  PyGILState_Release(st);
  return rc;
}

/* call helpers.<name>(fmt args); returns new ref or NULL (err recorded) */
static PyObject *callh(const char *name, const char *fmt, ...) {
  if (!g_helpers) {
    snprintf(g_err, sizeof(g_err), "c_dbcsr_init_lib not called");
    return NULL;
  }
  PyObject *meth = PyObject_GetAttrString(g_helpers, name);
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
  PyObject *r = PyObject_CallObject(meth, args);
  Py_DECREF(args);
  Py_DECREF(meth);
  if (!r) set_err_from_python();
  return r;
}

#define ENTER PyGILState_STATE st = PyGILState_Ensure()
#define LEAVE_RC(rc)        \
  do {                      \
    PyGILState_Release(st); \
    return (rc);            \
  } while (0)

/* result object -> new handle in *out */
static int finish_obj(PyGILState_STATE st, PyObject *r, int64_t *out) {
  if (!r) {
    PyGILState_Release(st);
    return 1;
  }
  *out = put_handle(r);
  PyGILState_Release(st);
  return *out == 0; /* 0 = handle-table OOM (error already recorded) */
}

/* result float -> *out */
static int finish_f64(PyGILState_STATE st, PyObject *r, double *out) {
  if (!r) {
    PyGILState_Release(st);
    return 1;
  }
  *out = PyFloat_AsDouble(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    set_err_from_python();
    PyGILState_Release(st);
    return 1;
  }
  PyGILState_Release(st);
  return 0;
}

int c_dbcsr_create(int64_t *builder, const char *name,
                   const int *row_block_sizes, int nblkrows,
                   const int *col_block_sizes, int nblkcols) {
  ENTER;
  PyObject *r = callh("create", "(sLiLi)", name,
                      (long long)(intptr_t)row_block_sizes, nblkrows,
                      (long long)(intptr_t)col_block_sizes, nblkcols);
  return finish_obj(st, r, builder);
}

int c_dbcsr_put_block_d(int64_t builder, int row, int col,
                        const double *block, int m, int n, int sum) {
  ENTER;
  PyObject *b = get_handle(builder);
  if (!b) LEAVE_RC(1);
  PyObject *r = callh("put_block", "(OiiLiii)", b, row, col,
                      (long long)(intptr_t)block, m, n, sum);
  if (!r) LEAVE_RC(1);
  Py_DECREF(r);
  LEAVE_RC(0);
}


int c_dbcsr_finalize_builder(int64_t builder, int64_t *matrix) {
  ENTER;
  PyObject *b = get_handle(builder);
  if (!b) LEAVE_RC(1);
  PyObject *r = callh("finalize", "(O)", b);
  return finish_obj(st, r, matrix);
}

int c_dbcsr_get_block_d(int64_t matrix, int row, int col, double *out,
                        int *m, int *n, int *found) {
  ENTER;
  PyObject *mat = get_handle(matrix);
  if (!mat) LEAVE_RC(1);
  PyObject *r = callh("get_block", "(OiiL)", mat, row, col,
                      (long long)(intptr_t)out);
  if (!r) LEAVE_RC(1);
  int f, mm, nn;
  if (!PyArg_ParseTuple(r, "iii", &f, &mm, &nn)) {
    set_err_from_python();
    Py_DECREF(r);
    LEAVE_RC(1);
  }
  Py_DECREF(r);
  *found = f;
  *m = mm;
  *n = nn;
  LEAVE_RC(0);
}

int c_dbcsr_get_nblks(int64_t matrix, int64_t *nblks) {
  ENTER;
  PyObject *mat = get_handle(matrix);
  if (!mat) LEAVE_RC(1);
  PyObject *r = callh("get_nblks", "(O)", mat);
  if (!r) LEAVE_RC(1);
  *nblks = PyLong_AsLongLong(r);
  Py_DECREF(r);
  int rc = 0;
  if (PyErr_Occurred()) {
    set_err_from_python();
    rc = 1;
  }
  LEAVE_RC(rc);
}



#define BINOP_SCALAR(cname, pyname)                          \
  int cname(int64_t a, int64_t b, double *out) {             \
    ENTER;                                                   \
    PyObject *ao = get_handle(a), *bo = get_handle(b);       \
    if (!ao || !bo) LEAVE_RC(1);                             \
    return finish_f64(st, callh(pyname, "(OO)", ao, bo), out); \
  }

#define UNOP_SCALAR(cname, pyname)                       \
  int cname(int64_t a, double *out) {                    \
    ENTER;                                               \
    PyObject *ao = get_handle(a);                        \
    if (!ao) LEAVE_RC(1);                                \
    return finish_f64(st, callh(pyname, "(O)", ao), out); \
  }

UNOP_SCALAR(c_dbcsr_norm_frobenius, "norm_frobenius")



int c_dbcsr_filter_d(int64_t a, double eps, int64_t *out) {
  ENTER;
  PyObject *ao = get_handle(a);
  if (!ao) LEAVE_RC(1);
  return finish_obj(st, callh("filter_blocks", "(Od)", ao, eps), out);
}

int c_dbcsr_transpose(int64_t a, int64_t *out) {
  ENTER;
  PyObject *ao = get_handle(a);
  if (!ao) LEAVE_RC(1);
  return finish_obj(st, callh("transpose", "(O)", ao), out);
}

#include "capi2.c"
#include "capi3.c"
