// C ABI over the PyTorch port's OCR engine (see tuatara_capi.h).
//
// Embeds CPython: loaded inside a Python process (e.g. through ctypes) it
// joins the running interpreter through PyGILState; linked into a plain
// C/C++ program it starts one on the first call (PYTHONPATH must reach the
// tuatara_tpu_torch package and torch, as with any embedded interpreter).
// All Python objects stay in this file; the exported surface is plain C
// (fixed-size records, caller-owned buffers, thread-local errors).
//
// Three channels go through `tuatara_tpu_torch.api.image_to_data`, gray
// through `get_engine(...).run`, both with device=$TUATARA_TORCH_DEVICE
// (None when unset: the first CUDA card, and an error without one).

#include "tuatara_capi.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string msg = "python error";
  if (type != nullptr) {
    msg = reinterpret_cast<PyTypeObject*>(type)->tp_name;
  }
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg += std::string(": ") + c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  PyErr_Clear();
  set_error(msg);
}

// Start an interpreter once if none is running (a standalone C/C++ host).
// Inside a Python process Py_IsInitialized() is already true and calls
// only join through PyGILState_Ensure.
std::once_flag g_init_once;

void ensure_interpreter() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);  // no signal handlers: we are a guest
      // Release the GIL that initialization holds, so that PyGILState_Ensure
      // below works the same from any thread. torch (and CUDA) start only
      // later, inside a call, under that GIL.
      PyEval_SaveThread();
    }
  });
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

// A new reference to `s` as a str, or to None for NULL / "".
PyObject* str_or_none(const char* s) {
  if (s == nullptr || s[0] == '\0') {
    Py_INCREF(Py_None);
    return Py_None;
  }
  return PyUnicode_FromString(s);
}

// The engine's results (a list of {text, bbox, confidence}) -> records.
// -> the count written, or -1 with a Python error set.
int write_items(PyObject* results, TuataraItem* out, int max_items) {
  PyObject* seq = PySequence_Fast(results, "engine returned a non-sequence");
  if (seq == nullptr) return -1;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  int written = 0;
  for (Py_ssize_t i = 0; i < n && written < max_items; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);  // borrowed
    PyObject* text = PyDict_GetItemString(item, "text");  // borrowed
    PyObject* bbox = PyDict_GetItemString(item, "bbox");
    PyObject* conf = PyDict_GetItemString(item, "confidence");
    if (text == nullptr || bbox == nullptr) continue;
    TuataraItem& rec = out[written];
    std::memset(&rec, 0, sizeof(rec));
    const char* t = PyUnicode_AsUTF8(text);
    if (t != nullptr) std::strncpy(rec.text, t, sizeof(rec.text) - 1);
    for (int j = 0; j < 4; ++j) {
      PyObject* v = PySequence_GetItem(bbox, j);
      if (v != nullptr) {
        rec.bbox[j] = static_cast<float>(PyFloat_AsDouble(v));
        Py_DECREF(v);
      }
    }
    rec.confidence =
        conf != nullptr ? static_cast<float>(PyFloat_AsDouble(conf)) : 0.0f;
    ++written;
  }
  Py_DECREF(seq);
  return PyErr_Occurred() ? -1 : written;
}

}  // namespace

extern "C" const char* tuatara_last_error(void) { return g_error.c_str(); }

extern "C" int tuatara_image_to_data(const unsigned char* image, int height,
                                     int width, int channels,
                                     const char* weights_dir,
                                     const char* outputs_dir, TuataraItem* out,
                                     int max_items) {
  if (image == nullptr || out == nullptr || height <= 0 || width <= 0 ||
      (channels != 1 && channels != 3) || max_items < 0) {
    set_error("invalid arguments");
    return -1;
  }
  ensure_interpreter();
  GilGuard gil;

  int written = -1;
  PyObject* np = nullptr;
  PyObject* api = nullptr;
  PyObject* arr = nullptr;
  PyObject* kwargs = nullptr;
  PyObject* results = nullptr;

  do {
    np = PyImport_ImportModule("numpy");
    if (np == nullptr) break;
    api = PyImport_ImportModule("tuatara_tpu_torch.api");
    if (api == nullptr) break;

    // np.frombuffer(bytearray, uint8).reshape(h, w[, c]): one host copy of
    // the caller's pixels, writable, as torch.from_numpy wants its arrays.
    const Py_ssize_t nbytes =
        static_cast<Py_ssize_t>(height) * width * channels;
    PyObject* raw = PyByteArray_FromStringAndSize(
        reinterpret_cast<const char*>(image), nbytes);
    if (raw == nullptr) break;
    PyObject* flat = PyObject_CallMethod(np, "frombuffer", "Os", raw, "uint8");
    Py_DECREF(raw);
    if (flat == nullptr) break;
    if (channels == 3) {
      arr = PyObject_CallMethod(flat, "reshape", "(iii)", height, width,
                                channels);
    } else {
      arr = PyObject_CallMethod(flat, "reshape", "(ii)", height, width);
    }
    Py_DECREF(flat);
    if (arr == nullptr) break;

    kwargs = PyDict_New();
    if (kwargs == nullptr) break;
    PyObject* device = str_or_none(std::getenv("TUATARA_TORCH_DEVICE"));
    if (device == nullptr) break;
    int rc = PyDict_SetItemString(kwargs, "device", device);
    Py_DECREF(device);
    if (rc < 0) break;
    PyObject* weights = str_or_none(weights_dir);
    if (weights == nullptr) break;
    rc = PyDict_SetItemString(kwargs, "weights_dir", weights);
    Py_DECREF(weights);
    if (rc < 0) break;

    // image_to_data requires ndim == 3 (the reference binding's check);
    // gray goes through the engine, which takes [H, W].
    if (channels == 3) {
      PyObject* outputs = str_or_none(outputs_dir);
      if (outputs == nullptr) break;
      rc = PyDict_SetItemString(kwargs, "outputs_dir", outputs);
      Py_DECREF(outputs);
      if (rc < 0) break;
      PyObject* fn = PyObject_GetAttrString(api, "image_to_data");
      if (fn == nullptr) break;
      PyObject* args = PyTuple_Pack(1, arr);
      if (args != nullptr) results = PyObject_Call(fn, args, kwargs);
      Py_XDECREF(args);
      Py_DECREF(fn);
    } else {
      PyObject* fn = PyObject_GetAttrString(api, "get_engine");
      if (fn == nullptr) break;
      PyObject* args = PyTuple_New(0);
      PyObject* engine =
          args != nullptr ? PyObject_Call(fn, args, kwargs) : nullptr;
      Py_XDECREF(args);
      Py_DECREF(fn);
      if (engine == nullptr) break;
      results = PyObject_CallMethod(engine, "run", "O", arr);
      Py_DECREF(engine);
    }
    if (results == nullptr) break;
    written = write_items(results, out, max_items);
    if (written >= 0) set_error("");
  } while (false);

  if (written < 0) {
    if (PyErr_Occurred()) {
      set_error_from_python();
    } else {
      set_error("python error");
    }
  }
  Py_XDECREF(results);
  Py_XDECREF(kwargs);
  Py_XDECREF(arr);
  Py_XDECREF(api);
  Py_XDECREF(np);
  return written;
}
