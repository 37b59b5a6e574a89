/* Depth-resolve rasterizer core: scatter-min of packed (depth<<32|rgb)
 * uint64 keys over per-body discs.
 *
 * Replaces the Python-side resolve loops in render/rasterize.py
 * (np.minimum.at per stamp offset + per-body 2D-slice minimum for large
 * splats) with one pass: for each body, stamp its disc row-span by
 * row-span with a branch-predictable compare-and-store.  Work is exactly
 * the total splat area (sum over bodies of the pixel count with
 * dx*dx + dy*dy <= r*r — the reference's circle-SDF inclusion,
 * nbody3d.js:377-378), and min-by-key is order-independent, so the
 * output is bit-identical to the numpy resolve at any body order.
 *
 * np.minimum.at runs ~1e7 scatter-min/s (ufunc.at dispatch per element);
 * this loop is memory-bound (~1e9/s) — the difference between ~100 s and
 * ~1 s for a 16.7M-body 1080p frame on the host.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <math.h>
#include <stdint.h>

/* stamp_discs(buf, h, w, cx, cy, r, keys)
 *   buf:  writable buffer of h*w uint64 (row-major), min-initialized
 *   cx,cy: int64 pixel centers (may lie outside the image)
 *   r:    float64 pixel radii
 *   keys: uint64 packed (depth_bits << 32) | rgb24
 */
static PyObject *stamp_discs(PyObject *self, PyObject *args) {
  Py_buffer buf, cxb, cyb, rb, keyb;
  Py_ssize_t h, w;
  if (!PyArg_ParseTuple(args, "w*nny*y*y*y*", &buf, &h, &w, &cxb, &cyb, &rb,
                        &keyb))
    return NULL;

  Py_ssize_t n = (Py_ssize_t)(cxb.len / (Py_ssize_t)sizeof(int64_t));
  if (buf.len < (Py_ssize_t)(h * w * (Py_ssize_t)sizeof(uint64_t)) ||
      cyb.len < n * (Py_ssize_t)sizeof(int64_t) ||
      rb.len < n * (Py_ssize_t)sizeof(double) ||
      keyb.len < n * (Py_ssize_t)sizeof(uint64_t)) {
    PyBuffer_Release(&buf);
    PyBuffer_Release(&cxb);
    PyBuffer_Release(&cyb);
    PyBuffer_Release(&rb);
    PyBuffer_Release(&keyb);
    PyErr_SetString(PyExc_ValueError, "stamp_discs: buffer sizes disagree");
    return NULL;
  }

  uint64_t *bp = (uint64_t *)buf.buf;
  const int64_t *cx = (const int64_t *)cxb.buf;
  const int64_t *cy = (const int64_t *)cyb.buf;
  const double *r = (const double *)rb.buf;
  const uint64_t *keys = (const uint64_t *)keyb.buf;

  Py_BEGIN_ALLOW_THREADS;
  for (Py_ssize_t i = 0; i < n; i++) {
    const double ri = r[i];
    const double r2 = ri * ri;
    const int64_t irad = (int64_t)floor(ri);
    const uint64_t key = keys[i];
    const int64_t x0c = cx[i], y0c = cy[i];
    int64_t dy0 = -irad, dy1 = irad;
    if (y0c + dy0 < 0) dy0 = -y0c;
    if (y0c + dy1 >= h) dy1 = h - 1 - y0c;
    for (int64_t dy = dy0; dy <= dy1; dy++) {
      /* widest dx with dx*dx + dy*dy <= r*r, matched exactly to the
       * numpy f64 mask test (guard loops absorb any sqrt rounding) */
      const double rem = r2 - (double)(dy * dy);
      int64_t dxm = (int64_t)floor(sqrt(rem > 0 ? rem : 0));
      while ((double)((dxm + 1) * (dxm + 1) + dy * dy) <= r2) dxm++;
      while (dxm >= 0 && (double)(dxm * dxm + dy * dy) > r2) dxm--;
      if (dxm < 0) continue;
      int64_t xa = x0c - dxm, xb = x0c + dxm;
      if (xa < 0) xa = 0;
      if (xb >= w) xb = w - 1;
      if (xa > xb) continue;
      uint64_t *row = bp + (size_t)(y0c + dy) * (size_t)w;
      for (int64_t x = xa; x <= xb; x++)
        if (key < row[x]) row[x] = key;
    }
  }
  Py_END_ALLOW_THREADS;

  PyBuffer_Release(&buf);
  PyBuffer_Release(&cxb);
  PyBuffer_Release(&cyb);
  PyBuffer_Release(&rb);
  PyBuffer_Release(&keyb);
  Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"stamp_discs", stamp_discs, METH_VARARGS,
     "Scatter-min packed depth|rgb keys over per-body discs."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_raster",
                                 "native rasterizer resolve", -1, Methods};

PyMODINIT_FUNC PyInit__raster(void) { return PyModule_Create(&mod); }
