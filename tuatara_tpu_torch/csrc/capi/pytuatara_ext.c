/* Compiled CPython extension module `_pytuatara_torch`: the port's binding.
 *
 * The reference ships its Python binding as a compiled pybind11 module,
 * `pytuatara.image_to_data(image, weights_dir, outputs_dir)`, whose work is
 * marshalling: a numpy buffer checked for ndim == 3 and copied, a call
 * into the engine, and each result turned into {text, bbox}. This module is
 * that layer on the raw CPython C API, as the JAX package's
 * native/pytuatara_ext.c is, with the same checks in the same order
 * (argument values, the buffer protocol, ndim == 3, uint8), routed to the
 * port: `tuatara_tpu_torch.pytuatara._run`. Its name differs from the JAX
 * package's `_pytuatara`, so both load in one process.
 *
 * image_to_data(image, weights_dir, outputs_dir, device=None): `device` is
 * a torch device name; None runs on the first CUDA card.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string.h>

/* np.frombuffer(raw, uint8).reshape(h, w, c) from an owned contiguous
 * bytearray: a new reference, or NULL with an exception set. numpy's
 * Python surface keeps the module free of numpy's C ABI. */
static PyObject *bytes_to_ndarray(PyObject *raw, Py_ssize_t h, Py_ssize_t w,
                                  Py_ssize_t c) {
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) return NULL;
  PyObject *flat = PyObject_CallMethod(np, "frombuffer", "Os", raw, "uint8");
  Py_DECREF(np);
  if (!flat) return NULL;
  PyObject *arr = PyObject_CallMethod(flat, "reshape", "(nnn)", h, w, c);
  Py_DECREF(flat);
  return arr;
}

static PyObject *image_to_data(PyObject *self, PyObject *args) {
  (void)self;
  PyObject *image;
  const char *weights_dir, *outputs_dir;
  PyObject *device = Py_None;
  if (!PyArg_ParseTuple(args, "Oss|O:image_to_data", &image, &weights_dir,
                        &outputs_dir, &device))
    return NULL;
  if (device != Py_None && !PyUnicode_Check(device)) {
    PyErr_SetString(PyExc_TypeError, "device must be a str or None");
    return NULL;
  }

  /* The reference's argument checks, raised as exceptions. */
  if (!weights_dir[0]) {
    PyErr_SetString(PyExc_ValueError,
                    "Please provide a value for weights_dir");
    return NULL;
  }
  if (!outputs_dir[0]) {
    PyErr_SetString(PyExc_ValueError,
                    "Please provide a value for outputs_dir");
    return NULL;
  }

  /* The buffer, ndim == 3, uint8 (the reference's cv::Mat is CV_8UC3),
   * then one copy into memory this layer owns. */
  Py_buffer view;
  if (PyObject_GetBuffer(image, &view, PyBUF_RECORDS_RO) < 0) return NULL;
  if (view.ndim != 3) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError,
                    "Input array should have 3 dimensions");
    return NULL;
  }
  if (view.itemsize != 1 ||
      (view.format && strcmp(view.format, "B") != 0 &&
       strcmp(view.format, "b") != 0)) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_TypeError,
                    "expected a uint8 image buffer (dtype uint8)");
    return NULL;
  }
  Py_ssize_t h = view.shape[0], w = view.shape[1], c = view.shape[2];
  /* A bytearray, so the array is writable, as torch.from_numpy wants. */
  PyObject *raw = PyByteArray_FromStringAndSize(NULL, view.len);
  if (!raw) {
    PyBuffer_Release(&view);
    return NULL;
  }
  /* Strided sources are gathered; contiguous ones copied as they are. */
  if (PyBuffer_ToContiguous(PyByteArray_AS_STRING(raw), &view, view.len, 'C') <
      0) {
    Py_DECREF(raw);
    PyBuffer_Release(&view);
    return NULL;
  }
  PyBuffer_Release(&view);

  PyObject *arr = bytes_to_ndarray(raw, h, w, c);
  Py_DECREF(raw);
  if (!arr) return NULL;

  /* The engine call: `_run` checks the weights directory and serves from
   * the cached engine. Imported here, so loading this module imports no
   * torch. */
  PyObject *shim = PyImport_ImportModule("tuatara_tpu_torch.pytuatara");
  if (!shim) {
    Py_DECREF(arr);
    return NULL;
  }
  PyObject *records = PyObject_CallMethod(shim, "_run", "OssO", arr,
                                          weights_dir, outputs_dir, device);
  Py_DECREF(shim);
  Py_DECREF(arr);
  if (!records) return NULL;

  /* The reference's items carry exactly {text, bbox}. */
  PyObject *seq = PySequence_Fast(records, "engine returned a non-sequence");
  Py_DECREF(records);
  if (!seq) return NULL;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *rec = PySequence_Fast_GET_ITEM(seq, i); /* borrowed */
    PyObject *text = PyMapping_GetItemString(rec, "text");
    PyObject *bbox = text ? PyMapping_GetItemString(rec, "bbox") : NULL;
    PyObject *item = bbox ? PyDict_New() : NULL;
    if (!item || PyDict_SetItemString(item, "text", text) < 0 ||
        PyDict_SetItemString(item, "bbox", bbox) < 0) {
      Py_XDECREF(text);
      Py_XDECREF(bbox);
      Py_XDECREF(item);
      Py_DECREF(seq);
      Py_DECREF(out);
      return NULL;
    }
    Py_DECREF(text);
    Py_DECREF(bbox);
    PyList_SET_ITEM(out, i, item); /* steals */
  }
  Py_DECREF(seq);
  return out;
}

static PyMethodDef Methods[] = {
    {"image_to_data", image_to_data, METH_VARARGS,
     "image_to_data(image, weights_dir, outputs_dir, device=None) -> "
     "[{'text': str, 'bbox': [x0, y0, x1, y1]}]\n\n"
     "Compiled marshalling layer over the PyTorch port's OCR engine, with\n"
     "the reference binding's contract; device=None runs on the first CUDA\n"
     "card."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_pytuatara_torch",
    "Compiled binding of the PyTorch port's OCR engine "
    "(see tuatara_tpu_torch/pytuatara.py).",
    -1, Methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__pytuatara_torch(void) {
  return PyModule_Create(&moduledef);
}
