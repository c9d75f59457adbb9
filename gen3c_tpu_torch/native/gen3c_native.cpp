// gen3c_native: CPython C-API extension over the native GEN3C cores.
//
// Parity role: the reference's pybind11 module (gui/src/python_api.cu,
// built as `pyngp`) — real compiled Python bindings rather than ctypes
// shims. Wraps the same three C++ cores the ctypes layer uses
// (camera_path.cpp / render_buffer.cpp / point_raster.cpp, included
// directly below so the extension is one self-contained TU):
//
//   gen3c_native.CameraPath    keyframes, Catmull-Rom/slerp eval,
//                              reference-format JSON save/load
//   gen3c_native.RenderBuffer  owns its accumulation surface (C++-side
//                              storage), tonemapped uint8 readout
//   gen3c_native.raster_points z-buffered point-splat preview frames
//
// Zero-copy in, buffer-protocol out: inputs are any C-contiguous
// buffer (numpy arrays work directly); bulk outputs are `bytes` the
// Python wrapper (native/ext.py) views through numpy. No numpy C API
// dependency, no pybind11 (absent in this environment — CPython API
// is the stable-floor equivalent).
//
// Build (done on demand by native/ext.py, or via setup.py):
//   g++ -O2 -std=c++17 -shared -fPIC -I<python-include>
//       gen3c_native.cpp -o gen3c_native.so   (one command)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "camera_path.cpp"
#include "point_raster.cpp"
#include "render_buffer.cpp"

#include <vector>

namespace {

// ------------------------- buffer helpers -------------------------

struct BufGuard {
  Py_buffer view{};
  bool held = false;
  ~BufGuard() {
    if (held) PyBuffer_Release(&view);
  }
};

// Acquire a C-contiguous read buffer of exactly `expect` bytes
// (expect < 0 skips the size check). Returns false with an exception set.
bool get_buf(PyObject* obj, BufGuard* g, Py_ssize_t expect,
             const char* what, bool writable = false) {
  int flags = PyBUF_C_CONTIGUOUS | (writable ? PyBUF_WRITABLE : 0);
  if (PyObject_GetBuffer(obj, &g->view, flags) != 0) return false;
  g->held = true;
  if (expect >= 0 && g->view.len != expect) {
    PyErr_Format(PyExc_ValueError, "%s: expected %zd bytes, got %zd", what,
                 (Py_ssize_t)expect, g->view.len);
    return false;
  }
  return true;
}

PyObject* floats_to_list(const float* v, int n) {
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (int i = 0; i < n; i++)
    PyList_SET_ITEM(out, i, PyFloat_FromDouble((double)v[i]));
  return out;
}

// ------------------------------ CameraPath ------------------------------

struct PyCameraPath {
  PyObject_HEAD CameraPath* path;
};

PyObject* cp_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyCameraPath* self = (PyCameraPath*)type->tp_alloc(type, 0);
  if (self) self->path = new CameraPath();
  return (PyObject*)self;
}

void cp_dealloc(PyObject* o) {
  delete ((PyCameraPath*)o)->path;
  Py_TYPE(o)->tp_free(o);
}

Py_ssize_t cp_len(PyObject* o) {
  return (Py_ssize_t)((PyCameraPath*)o)->path->keyframes.size();
}

PyObject* cp_clear(PyObject* o, PyObject*) {
  ((PyCameraPath*)o)->path->keyframes.clear();
  Py_RETURN_NONE;
}

// add_keyframe(c2w_3x4_buffer, fov=50.0, timestamp=-1.0)
PyObject* cp_add_keyframe(PyObject* o, PyObject* args, PyObject* kwargs) {
  static const char* kws[] = {"c2w", "fov", "timestamp", nullptr};
  PyObject* c2w_obj;
  float fov = 50.f, ts = -1.f;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|ff", (char**)kws,
                                   &c2w_obj, &fov, &ts))
    return nullptr;
  BufGuard g;
  if (!get_buf(c2w_obj, &g, 12 * (Py_ssize_t)sizeof(float), "c2w"))
    return nullptr;
  if (ts < 0.f) {
    PyCameraPath* self = (PyCameraPath*)o;
    ts = (float)self->path->keyframes.size();
  }
  camera_path_add_keyframe_m(((PyCameraPath*)o)->path,
                             (const float*)g.view.buf, fov, ts);
  Py_RETURN_NONE;
}

// add_keyframe_quat(r4_wxyz, t3, fov=50.0, timestamp=-1.0)
PyObject* cp_add_keyframe_quat(PyObject* o, PyObject* args,
                               PyObject* kwargs) {
  static const char* kws[] = {"r", "t", "fov", "timestamp", nullptr};
  PyObject *r_obj, *t_obj;
  float fov = 50.f, ts = -1.f;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "OO|ff", (char**)kws,
                                   &r_obj, &t_obj, &fov, &ts))
    return nullptr;
  BufGuard gr, gt;
  if (!get_buf(r_obj, &gr, 4 * (Py_ssize_t)sizeof(float), "r")) return nullptr;
  if (!get_buf(t_obj, &gt, 3 * (Py_ssize_t)sizeof(float), "t")) return nullptr;
  if (ts < 0.f) ts = (float)((PyCameraPath*)o)->path->keyframes.size();
  camera_path_add_keyframe(((PyCameraPath*)o)->path,
                           (const float*)gr.view.buf,
                           (const float*)gt.view.buf, fov, ts);
  Py_RETURN_NONE;
}

PyObject* cp_get_keyframe(PyObject* o, PyObject* args) {
  int i;
  if (!PyArg_ParseTuple(args, "i", &i)) return nullptr;
  float c2w[12], fov, ts;
  if (camera_path_get_keyframe(((PyCameraPath*)o)->path, i, c2w, &fov,
                               &ts) != 0) {
    PyErr_SetString(PyExc_IndexError, "keyframe index out of range");
    return nullptr;
  }
  PyObject* lst = floats_to_list(c2w, 12);
  if (!lst) return nullptr;
  return Py_BuildValue("(Nff)", lst, (double)fov, (double)ts);
}

PyObject* cp_eval(PyObject* o, PyObject* args) {
  float t;
  if (!PyArg_ParseTuple(args, "f", &t)) return nullptr;
  if (((PyCameraPath*)o)->path->keyframes.empty()) {
    PyErr_SetString(PyExc_ValueError, "empty camera path");
    return nullptr;
  }
  float c2w[12], fov;
  camera_path_eval(((PyCameraPath*)o)->path, t, c2w, &fov);
  PyObject* lst = floats_to_list(c2w, 12);
  if (!lst) return nullptr;
  return Py_BuildValue("(Nf)", lst, (double)fov);
}

// sample(n) -> (bytes float32 (n,3,4), bytes float32 (n,))
PyObject* cp_sample(PyObject* o, PyObject* args) {
  int n;
  if (!PyArg_ParseTuple(args, "i", &n)) return nullptr;
  if (n <= 0) {
    PyErr_SetString(PyExc_ValueError, "n must be positive");
    return nullptr;
  }
  if (((PyCameraPath*)o)->path->keyframes.empty()) {
    PyErr_SetString(PyExc_ValueError, "empty camera path");
    return nullptr;
  }
  std::vector<float> c2w((size_t)n * 12), fov((size_t)n);
  camera_path_sample(((PyCameraPath*)o)->path, n, c2w.data(), fov.data());
  PyObject* b1 = PyBytes_FromStringAndSize((const char*)c2w.data(),
                                           (Py_ssize_t)(c2w.size() * 4));
  PyObject* b2 = PyBytes_FromStringAndSize((const char*)fov.data(),
                                           (Py_ssize_t)(fov.size() * 4));
  if (!b1 || !b2) {
    Py_XDECREF(b1);
    Py_XDECREF(b2);
    return nullptr;
  }
  return Py_BuildValue("(NN)", b1, b2);
}

PyObject* cp_save(PyObject* o, PyObject* args) {
  const char* filename;
  if (!PyArg_ParseTuple(args, "s", &filename)) return nullptr;
  if (camera_path_save(((PyCameraPath*)o)->path, filename) != 0) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, filename);
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* cp_load(PyObject* o, PyObject* args) {
  const char* filename;
  if (!PyArg_ParseTuple(args, "s", &filename)) return nullptr;
  int rc = camera_path_load(((PyCameraPath*)o)->path, filename);
  if (rc == -1) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, filename);
    return nullptr;
  }
  if (rc != 0) {
    PyErr_Format(PyExc_ValueError, "invalid camera path JSON: %s", filename);
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* cp_get_play_time(PyObject* o, void*) {
  return PyFloat_FromDouble(
      (double)camera_path_play_time(((PyCameraPath*)o)->path));
}

int cp_set_play_time(PyObject* o, PyObject* v, void*) {
  double t = PyFloat_AsDouble(v);
  if (t == -1.0 && PyErr_Occurred()) return -1;
  camera_path_set_play_time(((PyCameraPath*)o)->path, (float)t);
  return 0;
}

PyMethodDef cp_methods[] = {
    {"clear", cp_clear, METH_NOARGS, "Remove all keyframes."},
    {"add_keyframe", (PyCFunction)cp_add_keyframe,
     METH_VARARGS | METH_KEYWORDS,
     "add_keyframe(c2w_3x4_float32_buffer, fov=50, timestamp=auto)"},
    {"add_keyframe_quat", (PyCFunction)cp_add_keyframe_quat,
     METH_VARARGS | METH_KEYWORDS,
     "add_keyframe_quat(r_wxyz, t_xyz, fov=50, timestamp=auto)"},
    {"get_keyframe", cp_get_keyframe, METH_VARARGS,
     "get_keyframe(i) -> (c2w 12-float list, fov, timestamp)"},
    {"eval", cp_eval, METH_VARARGS, "eval(t) -> (c2w 12-float list, fov)"},
    {"sample", cp_sample, METH_VARARGS,
     "sample(n) -> (float32 bytes (n,3,4), float32 bytes (n,))"},
    {"save", cp_save, METH_VARARGS, "save(filename): reference-format JSON"},
    {"load", cp_load, METH_VARARGS, "load(filename): reference-format JSON"},
    {nullptr, nullptr, 0, nullptr}};

PyGetSetDef cp_getset[] = {
    {"play_time", cp_get_play_time, cp_set_play_time,
     "playback position in [0, 1]", nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

PySequenceMethods cp_as_sequence = {
    cp_len,  // sq_length
};

PyTypeObject CameraPathType = {
    PyVarObject_HEAD_INIT(nullptr, 0)  //
    "gen3c_native.CameraPath",         // tp_name
    sizeof(PyCameraPath),              // tp_basicsize
};

// ------------------------------ RenderBuffer ------------------------------

struct PyRenderBuffer {
  PyObject_HEAD std::vector<float>* accum;
  int h, w, c;
  int spp;
};

PyObject* rb_new(PyTypeObject* type, PyObject* args, PyObject* kwargs) {
  static const char* kws[] = {"height", "width", "channels", nullptr};
  int h, w, c = 3;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "ii|i", (char**)kws, &h, &w,
                                   &c))
    return nullptr;
  if (h <= 0 || w <= 0 || c <= 0) {
    PyErr_SetString(PyExc_ValueError, "dimensions must be positive");
    return nullptr;
  }
  PyRenderBuffer* self = (PyRenderBuffer*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->accum = new std::vector<float>((size_t)h * w * c, 0.f);
  self->h = h;
  self->w = w;
  self->c = c;
  self->spp = 0;
  return (PyObject*)self;
}

void rb_dealloc(PyObject* o) {
  delete ((PyRenderBuffer*)o)->accum;
  Py_TYPE(o)->tp_free(o);
}

PyObject* rb_clear_py(PyObject* o, PyObject*) {
  PyRenderBuffer* self = (PyRenderBuffer*)o;
  std::fill(self->accum->begin(), self->accum->end(), 0.f);
  self->spp = 0;
  Py_RETURN_NONE;
}

PyObject* rb_accumulate_py(PyObject* o, PyObject* args) {
  PyRenderBuffer* self = (PyRenderBuffer*)o;
  PyObject* frame;
  if (!PyArg_ParseTuple(args, "O", &frame)) return nullptr;
  BufGuard g;
  if (!get_buf(frame, &g, (Py_ssize_t)(self->accum->size() * 4), "frame"))
    return nullptr;
  rb_accumulate(self->accum->data(), (const float*)g.view.buf,
                (int64_t)self->accum->size());
  self->spp += 1;
  Py_RETURN_NONE;
}

// readout(exposure=0.0, srgb_transfer=True) -> bytes uint8 (h*w*c)
PyObject* rb_readout_py(PyObject* o, PyObject* args, PyObject* kwargs) {
  static const char* kws[] = {"exposure", "srgb_transfer", nullptr};
  PyRenderBuffer* self = (PyRenderBuffer*)o;
  float exposure = 0.f;
  int srgb_transfer = 1;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|fp", (char**)kws,
                                   &exposure, &srgb_transfer))
    return nullptr;
  PyObject* out =
      PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)self->accum->size());
  if (!out) return nullptr;
  rb_readout(self->accum->data(), (int64_t)self->accum->size(),
             (float)self->spp, exposure, srgb_transfer,
             (uint8_t*)PyBytes_AS_STRING(out));
  return out;
}

PyObject* rb_get_spp(PyObject* o, void*) {
  return PyLong_FromLong(((PyRenderBuffer*)o)->spp);
}

PyObject* rb_get_shape(PyObject* o, void*) {
  PyRenderBuffer* self = (PyRenderBuffer*)o;
  return Py_BuildValue("(iii)", self->h, self->w, self->c);
}

PyMethodDef rb_methods[] = {
    {"clear", rb_clear_py, METH_NOARGS, "Zero the surface and spp."},
    {"accumulate", rb_accumulate_py, METH_VARARGS,
     "accumulate(float32 (H,W,C) buffer): accum += frame"},
    {"readout", (PyCFunction)rb_readout_py, METH_VARARGS | METH_KEYWORDS,
     "readout(exposure=0.0, srgb_transfer=True) -> uint8 bytes (H*W*C)"},
    {nullptr, nullptr, 0, nullptr}};

PyGetSetDef rb_getset[] = {
    {"spp", rb_get_spp, nullptr, "accumulated sample count", nullptr},
    {"shape", rb_get_shape, nullptr, "(H, W, C)", nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

PyTypeObject RenderBufferType = {
    PyVarObject_HEAD_INIT(nullptr, 0)  //
    "gen3c_native.RenderBuffer",       // tp_name
    sizeof(PyRenderBuffer),            // tp_basicsize
};

// ------------------------------ raster_points ------------------------------

// raster_points(points, colors, w2cs, ks, height, width,
//               point_radius=1.0, background=0, znear=1e-4)
//   -> bytes uint8 (F*H*W*3)
PyObject* py_raster_points(PyObject*, PyObject* args, PyObject* kwargs) {
  static const char* kws[] = {"points", "colors",       "w2cs",
                              "ks",     "height",       "width",
                              "radius", "background",   "znear",
                              nullptr};
  PyObject *points, *colors, *w2cs, *ks;
  int h, w, bg = 0;
  float radius = 1.f, znear = 1e-4f;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "OOOOii|fif", (char**)kws,
                                   &points, &colors, &w2cs, &ks, &h, &w,
                                   &radius, &bg, &znear))
    return nullptr;
  if (h <= 0 || w <= 0) {
    PyErr_SetString(PyExc_ValueError, "height/width must be positive");
    return nullptr;
  }
  BufGuard gp, gc, gw, gk;
  if (!get_buf(points, &gp, -1, "points")) return nullptr;
  if (gp.view.len % (3 * 4) != 0) {
    PyErr_SetString(PyExc_ValueError, "points must be (N,3) float32");
    return nullptr;
  }
  int64_t n = gp.view.len / (3 * 4);
  if (!get_buf(colors, &gc, n * 3, "colors")) return nullptr;
  if (!get_buf(w2cs, &gw, -1, "w2cs")) return nullptr;
  if (gw.view.len % (16 * 4) != 0) {
    PyErr_SetString(PyExc_ValueError, "w2cs must be (F,4,4) float32");
    return nullptr;
  }
  int f = (int)(gw.view.len / (16 * 4));
  if (!get_buf(ks, &gk, (Py_ssize_t)f * 9 * 4, "ks")) return nullptr;

  PyObject* out = PyBytes_FromStringAndSize(
      nullptr, (Py_ssize_t)f * h * w * 3);
  if (!out) return nullptr;
  point_raster_path((const float*)gp.view.buf, (const uint8_t*)gc.view.buf,
                    n, (const float*)gw.view.buf, (const float*)gk.view.buf,
                    f, h, w, radius, (uint8_t)bg, znear,
                    (uint8_t*)PyBytes_AS_STRING(out));
  return out;
}

PyMethodDef module_methods[] = {
    {"raster_points", (PyCFunction)py_raster_points,
     METH_VARARGS | METH_KEYWORDS,
     "raster_points(points, colors, w2cs, ks, height, width, radius=1, "
     "background=0, znear=1e-4) -> uint8 bytes (F*H*W*3)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef gen3c_native_module = {
    PyModuleDef_HEAD_INIT, "gen3c_native",
    "CPython bindings over the native GEN3C cores (pyngp parity role).",
    -1, module_methods};

}  // namespace

PyMODINIT_FUNC PyInit_gen3c_native(void) {
  CameraPathType.tp_new = cp_new;
  CameraPathType.tp_dealloc = cp_dealloc;
  CameraPathType.tp_flags = Py_TPFLAGS_DEFAULT;
  CameraPathType.tp_doc = "Native camera path: keyframes + spline eval.";
  CameraPathType.tp_methods = cp_methods;
  CameraPathType.tp_getset = cp_getset;
  CameraPathType.tp_as_sequence = &cp_as_sequence;
  if (PyType_Ready(&CameraPathType) < 0) return nullptr;

  RenderBufferType.tp_new = rb_new;
  RenderBufferType.tp_dealloc = rb_dealloc;
  RenderBufferType.tp_flags = Py_TPFLAGS_DEFAULT;
  RenderBufferType.tp_doc =
      "Native accumulation surface with tonemapped readout.";
  RenderBufferType.tp_methods = rb_methods;
  RenderBufferType.tp_getset = rb_getset;
  if (PyType_Ready(&RenderBufferType) < 0) return nullptr;

  PyObject* m = PyModule_Create(&gen3c_native_module);
  if (!m) return nullptr;
  Py_INCREF(&CameraPathType);
  if (PyModule_AddObject(m, "CameraPath", (PyObject*)&CameraPathType) < 0) {
    Py_DECREF(&CameraPathType);
    Py_DECREF(m);
    return nullptr;
  }
  Py_INCREF(&RenderBufferType);
  if (PyModule_AddObject(m, "RenderBuffer", (PyObject*)&RenderBufferType) <
      0) {
    Py_DECREF(&RenderBufferType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
