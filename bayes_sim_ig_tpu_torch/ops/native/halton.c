/* Generalized (scrambled) Halton sequence generator - C extension.
 *
 * Native replacement for the reference's ghalton C++ dependency
 * (rff.py:114-117, pdf.py:121-123): generates scrambled radical-inverse
 * sequences with deterministic per-base digit permutations identical to
 * the Python reference implementation in distributions/halton.py (which
 * remains the fallback when this extension is not built).
 *
 * The permutation for base b fixes sigma(0)=0 and permutes {1..b-1} with
 * a Fisher-Yates shuffle driven by the same numpy PCG64(seed=b) stream
 * the Python implementation uses, so both produce identical sequences.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const int PRIMES[] = {
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
    67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137,
    139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
    223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283,
    293, 307, 311, 313, 317, 331, 337, 347, 349, 353, 359, 367, 373, 379,
    383, 389, 397, 401, 409, 419, 421, 431, 433, 439, 443, 449, 457, 461,
    463, 467, 479, 487, 491, 499, 503, 509, 521, 523, 541};
#define N_PRIMES ((int)(sizeof(PRIMES) / sizeof(PRIMES[0])))

/* Scrambled radical inverse of one index in one base. */
static double radical_inverse(int64_t index, int base, const int *perm) {
    double result = 0.0;
    double inv_base = 1.0 / (double)base;
    double scale = inv_base;
    while (index > 0) {
        int digit = (int)(index % base);
        result += (double)perm[digit] * scale;
        scale *= inv_base;
        index /= base;
    }
    return result;
}

/* halton_fill(dim, n, skip, perms_concat) -> bytes of float64 (n*dim)
 *
 * perms_concat: a python bytes object with the concatenated int32
 * permutations for each dimension's base (computed host-side in Python so
 * the PCG64 streams match numpy exactly). */
static PyObject *halton_fill(PyObject *self, PyObject *args) {
    int dim;
    long long n, skip;
    Py_buffer perms;
    if (!PyArg_ParseTuple(args, "iLLy*", &dim, &n, &skip, &perms))
        return NULL;
    if (dim > N_PRIMES || dim < 1) {
        PyBuffer_Release(&perms);
        PyErr_SetString(PyExc_ValueError, "dim out of range");
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL,
                                              (Py_ssize_t)(n * dim * 8));
    if (!out) {
        PyBuffer_Release(&perms);
        return NULL;
    }
    double *data = (double *)PyBytes_AsString(out);
    const int32_t *perm_data = (const int32_t *)perms.buf;
    /* Per-dimension offsets into the concatenated permutation table. */
    Py_BEGIN_ALLOW_THREADS
    /* Row-major iteration (i outer) keeps the writes sequential. */
    long long offsets[128];
    long long off = 0;
    for (int d = 0; d < dim; d++) {
        offsets[d] = off;
        off += PRIMES[d];
    }
    for (long long i = 0; i < n; i++) {
        double *row = data + i * dim;
        for (int d = 0; d < dim; d++)
            row[d] = radical_inverse(skip + i, PRIMES[d],
                                     (const int *)(perm_data + offsets[d]));
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&perms);
    return out;
}

static PyMethodDef Methods[] = {
    {"halton_fill", halton_fill, METH_VARARGS,
     "Fill a scrambled Halton sequence (returns float64 bytes)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {PyModuleDef_HEAD_INIT, "_halton_native",
                                    NULL, -1, Methods};

PyMODINIT_FUNC PyInit__halton_native(void) {
    return PyModule_Create(&module);
}
