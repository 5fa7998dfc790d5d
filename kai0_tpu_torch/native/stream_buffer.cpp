// Native action-chunk buffers for the robot-edge publish loop.
//
// The port's copy of kai0_tpu/native/stream_buffer.cpp: the 25-30 Hz publish
// loop's buffers in C++, with the GIL released around all locking and math, so
// that a Python inference thread integrating a new chunk never stalls the
// publisher.
//
// Exposed via the CPython C API (no pybind11 needed):
//   StreamActionBuffer  — crossfade smoothing buffer
//     (semantics: train_deploy_alignment/.../agilex_inference_openpi_rtc.py:167-287)
//   TemporalEnsembleBuffer — ACT-style exp(-m*i) aggregation
//     (semantics: agilex_inference_openpi_temporal_ensembling.py:56-146)
//
// Built at first use by kai0_tpu_torch/native/__init__.py; the Python wrappers
// are kai0_tpu_torch/deploy/native_buffers.py. The pure-Python implementations
// in kai0_tpu_torch/deploy/buffers.py are the reference semantics.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

namespace {

using Action = std::vector<double>;

// ---------------------------------------------------------------------------
// StreamActionBuffer
// ---------------------------------------------------------------------------

struct StreamBufferCore {
  std::mutex mu;
  std::deque<Action> cur;
  long k = 0;  // steps popped since last integration
  bool smooth = true;
  bool has_last = false;
  Action last_action;

  // chunk: row-major [n, dim]
  void integrate(const double* chunk, long n, long dim, long max_k, long min_m) {
    std::lock_guard<std::mutex> lock(mu);
    if (n <= 0) return;
    long drop_n = std::min(k, std::max(0L, max_k));
    if (drop_n >= n) return;
    std::vector<Action> fresh;
    fresh.reserve(n - drop_n);
    for (long i = drop_n; i < n; ++i)
      fresh.emplace_back(chunk + i * dim, chunk + (i + 1) * dim);

    if (!smooth) {
      cur.assign(fresh.begin(), fresh.end());
      k = 0;
      return;
    }

    min_m = std::max(1L, min_m);
    std::vector<Action> old_list;
    if (cur.empty() && has_last) {
      // Bridge the crossfade from the last executed action.
      old_list.assign(min_m, last_action);
      has_last = false;
    } else {
      old_list.assign(cur.begin(), cur.end());
      if (!old_list.empty() && (long)old_list.size() < min_m) {
        Action tail = old_list.back();
        while ((long)old_list.size() < min_m) old_list.push_back(tail);
      } else if (old_list.empty()) {
        cur.assign(fresh.begin(), fresh.end());
        k = 0;
        return;
      }
    }

    long overlap = std::min((long)old_list.size(), (long)fresh.size());
    cur.clear();
    for (long i = 0; i < overlap; ++i) {
      double w_old = (overlap == 1) ? 1.0 : 1.0 - (double)i / (double)(overlap - 1);
      Action mixed(dim);
      for (long d = 0; d < dim; ++d)
        mixed[d] = w_old * old_list[i][d] + (1.0 - w_old) * fresh[i][d];
      cur.push_back(std::move(mixed));
    }
    for (size_t i = overlap; i < fresh.size(); ++i) cur.push_back(fresh[i]);
    k = 0;
  }

  // Returns true and fills `out` (size dim) when an action is available.
  bool pop(Action* out) {
    std::lock_guard<std::mutex> lock(mu);
    if (cur.empty()) return false;
    if (cur.size() == 1) {
      last_action = cur.front();
      has_last = true;
    }
    *out = std::move(cur.front());
    cur.pop_front();
    ++k;
    return true;
  }

  long size() {
    std::lock_guard<std::mutex> lock(mu);
    return (long)cur.size();
  }

  long staleness() {
    std::lock_guard<std::mutex> lock(mu);
    return k;
  }
};

struct PyStreamBuffer {
  PyObject_HEAD
  StreamBufferCore* core;
};

// Parse a Python object supporting the buffer protocol as a contiguous
// float64 [n, dim] matrix. Returns true on success.
bool parse_matrix(PyObject* obj, std::vector<double>* data, long* n, long* dim) {
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO | PyBUF_FORMAT) != 0) return false;
  bool ok = view.ndim == 2 && view.format && view.format[0] == 'd';
  if (ok) {
    *n = (long)view.shape[0];
    *dim = (long)view.shape[1];
    data->assign((const double*)view.buf, (const double*)view.buf + (*n) * (*dim));
  } else {
    PyErr_SetString(PyExc_TypeError, "expected a contiguous float64 array of shape [n, dim]");
  }
  PyBuffer_Release(&view);
  return ok;
}

int PyStreamBuffer_init(PyStreamBuffer* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"smooth_method", nullptr};
  const char* method = "temporal";
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|s", (char**)kwlist, &method)) return -1;
  self->core = new StreamBufferCore();
  self->core->smooth = std::strcmp(method, "raw") != 0;
  return 0;
}

void PyStreamBuffer_dealloc(PyStreamBuffer* self) {
  delete self->core;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

PyObject* PyStreamBuffer_integrate(PyStreamBuffer* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"actions_chunk", "max_k", "min_m", nullptr};
  PyObject* chunk_obj;
  long max_k, min_m = 8;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "Ol|l", (char**)kwlist, &chunk_obj, &max_k, &min_m))
    return nullptr;
  std::vector<double> data;
  long n, dim;
  if (!parse_matrix(chunk_obj, &data, &n, &dim)) return nullptr;
  Py_BEGIN_ALLOW_THREADS
  self->core->integrate(data.data(), n, dim, max_k, min_m);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

PyObject* PyStreamBuffer_pop(PyStreamBuffer* self, PyObject* Py_UNUSED(ignored)) {
  Action out;
  bool got;
  Py_BEGIN_ALLOW_THREADS
  got = self->core->pop(&out);
  Py_END_ALLOW_THREADS
  if (!got) Py_RETURN_NONE;
  PyObject* bytes = PyBytes_FromStringAndSize((const char*)out.data(), out.size() * sizeof(double));
  return bytes;  // Python wrapper converts to np.frombuffer(..., float64)
}

PyObject* PyStreamBuffer_len(PyStreamBuffer* self, PyObject* Py_UNUSED(ignored)) {
  return PyLong_FromLong(self->core->size());
}

PyObject* PyStreamBuffer_staleness(PyStreamBuffer* self, PyObject* Py_UNUSED(ignored)) {
  return PyLong_FromLong(self->core->staleness());
}

PyMethodDef PyStreamBuffer_methods[] = {
    {"integrate_new_chunk", (PyCFunction)PyStreamBuffer_integrate, METH_VARARGS | METH_KEYWORDS,
     "Integrate a new chunk: latency trim + crossfade."},
    {"pop_next_action_bytes", (PyCFunction)PyStreamBuffer_pop, METH_NOARGS,
     "Pop next action as float64 bytes (None when empty)."},
    {"size", (PyCFunction)PyStreamBuffer_len, METH_NOARGS, "Queued action count."},
    {"staleness", (PyCFunction)PyStreamBuffer_staleness, METH_NOARGS, "Steps popped since last chunk."},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PyStreamBufferType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// TemporalEnsembleBuffer
// ---------------------------------------------------------------------------

struct EnsembleCore {
  std::mutex mu;
  // timestep → ordered predictions (insertion order == chunk age order)
  std::map<long, std::vector<Action>> preds;
  long current_t = 0;
  long cleanup_lag = 10;
  double m = 0.01;
  bool has_last = false;
  Action last_action;

  void add(const double* chunk, long n, long dim, long start) {
    std::lock_guard<std::mutex> lock(mu);
    for (long i = 0; i < n; ++i) {
      long t = start + i;
      if (t < 0) continue;
      preds[t].emplace_back(chunk + i * dim, chunk + (i + 1) * dim);
    }
    long threshold = std::max(0L, current_t - cleanup_lag);
    preds.erase(preds.begin(), preds.lower_bound(threshold));
  }

  bool get(long t, Action* out) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = preds.find(t);
    if (it == preds.end() || it->second.empty()) {
      if (!has_last) return false;
      *out = last_action;
      return true;
    }
    const auto& list = it->second;
    size_t n = list.size();
    size_t dim = list[0].size();
    Action agg(dim, 0.0);
    double wsum = 0.0;
    for (size_t i = 0; i < n; ++i) {
      double w = std::exp(-m * (double)i);
      wsum += w;
      for (size_t d = 0; d < dim; ++d) agg[d] += w * list[i][d];
    }
    for (size_t d = 0; d < dim; ++d) agg[d] /= wsum;
    last_action = agg;
    has_last = true;
    *out = std::move(agg);
    return true;
  }

  long step_cursor() {
    std::lock_guard<std::mutex> lock(mu);
    return current_t++;
  }

  long cursor() {
    std::lock_guard<std::mutex> lock(mu);
    return current_t;
  }
};

struct PyEnsemble {
  PyObject_HEAD
  EnsembleCore* core;
};

int PyEnsemble_init(PyEnsemble* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"exp_weight_m", "cleanup_lag", nullptr};
  double m = 0.01;
  long lag = 10;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|dl", (char**)kwlist, &m, &lag)) return -1;
  self->core = new EnsembleCore();
  self->core->m = m;
  self->core->cleanup_lag = lag;
  return 0;
}

void PyEnsemble_dealloc(PyEnsemble* self) {
  delete self->core;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

PyObject* PyEnsemble_add(PyEnsemble* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"actions_chunk", "start_timestep", nullptr};
  PyObject* chunk_obj;
  PyObject* start_obj = Py_None;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|O", (char**)kwlist, &chunk_obj, &start_obj))
    return nullptr;
  std::vector<double> data;
  long n, dim;
  if (!parse_matrix(chunk_obj, &data, &n, &dim)) return nullptr;
  long start = (start_obj == Py_None) ? self->core->cursor() : PyLong_AsLong(start_obj);
  if (PyErr_Occurred()) return nullptr;
  Py_BEGIN_ALLOW_THREADS
  self->core->add(data.data(), n, dim, start);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

PyObject* PyEnsemble_get(PyEnsemble* self, PyObject* args) {
  PyObject* t_obj = Py_None;
  if (!PyArg_ParseTuple(args, "|O", &t_obj)) return nullptr;
  long t = (t_obj == Py_None) ? self->core->cursor() : PyLong_AsLong(t_obj);
  if (PyErr_Occurred()) return nullptr;
  Action out;
  bool got;
  Py_BEGIN_ALLOW_THREADS
  got = self->core->get(t, &out);
  Py_END_ALLOW_THREADS
  if (!got) Py_RETURN_NONE;
  return PyBytes_FromStringAndSize((const char*)out.data(), out.size() * sizeof(double));
}

PyObject* PyEnsemble_step(PyEnsemble* self, PyObject* Py_UNUSED(ignored)) {
  long t;
  Action out;
  bool got;
  Py_BEGIN_ALLOW_THREADS
  t = self->core->step_cursor();
  got = self->core->get(t, &out);
  Py_END_ALLOW_THREADS
  if (!got) Py_RETURN_NONE;
  return PyBytes_FromStringAndSize((const char*)out.data(), out.size() * sizeof(double));
}

PyObject* PyEnsemble_cursor(PyEnsemble* self, PyObject* Py_UNUSED(ignored)) {
  return PyLong_FromLong(self->core->cursor());
}

PyMethodDef PyEnsemble_methods[] = {
    {"add_chunk", (PyCFunction)PyEnsemble_add, METH_VARARGS | METH_KEYWORDS,
     "Store a chunk's per-timestep predictions."},
    {"get_action_bytes", (PyCFunction)PyEnsemble_get, METH_VARARGS,
     "Aggregated action at timestep (float64 bytes, None if empty)."},
    {"step_bytes", (PyCFunction)PyEnsemble_step, METH_NOARGS,
     "Aggregate at cursor and advance it."},
    {"cursor", (PyCFunction)PyEnsemble_cursor, METH_NOARGS, "Current timestep cursor."},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PyEnsembleType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// Module
// ---------------------------------------------------------------------------

PyModuleDef native_module = {
    PyModuleDef_HEAD_INIT, "_stream_buffer",
    "Native (C++) robot-edge action buffers of kai0_tpu_torch.", -1, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__stream_buffer(void) {
  PyStreamBufferType.tp_name = "kai0_tpu_torch.native.StreamActionBuffer";
  PyStreamBufferType.tp_basicsize = sizeof(PyStreamBuffer);
  PyStreamBufferType.tp_flags = Py_TPFLAGS_DEFAULT;
  PyStreamBufferType.tp_new = PyType_GenericNew;
  PyStreamBufferType.tp_init = (initproc)PyStreamBuffer_init;
  PyStreamBufferType.tp_dealloc = (destructor)PyStreamBuffer_dealloc;
  PyStreamBufferType.tp_methods = PyStreamBuffer_methods;

  PyEnsembleType.tp_name = "kai0_tpu_torch.native.TemporalEnsembleBuffer";
  PyEnsembleType.tp_basicsize = sizeof(PyEnsemble);
  PyEnsembleType.tp_flags = Py_TPFLAGS_DEFAULT;
  PyEnsembleType.tp_new = PyType_GenericNew;
  PyEnsembleType.tp_init = (initproc)PyEnsemble_init;
  PyEnsembleType.tp_dealloc = (destructor)PyEnsemble_dealloc;
  PyEnsembleType.tp_methods = PyEnsemble_methods;

  if (PyType_Ready(&PyStreamBufferType) < 0) return nullptr;
  if (PyType_Ready(&PyEnsembleType) < 0) return nullptr;

  PyObject* mod = PyModule_Create(&native_module);
  if (!mod) return nullptr;
  Py_INCREF(&PyStreamBufferType);
  PyModule_AddObject(mod, "StreamActionBuffer", (PyObject*)&PyStreamBufferType);
  Py_INCREF(&PyEnsembleType);
  PyModule_AddObject(mod, "TemporalEnsembleBuffer", (PyObject*)&PyEnsembleType);
  return mod;
}
