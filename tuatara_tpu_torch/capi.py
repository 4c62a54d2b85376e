"""Build and load the port's native surface (`csrc/capi/`).

Three targets, built with the host's C/C++ compilers at first use (never at
import) into `build/capi/` beside the package:

- `libtuatara_capi-<hash>.so`: the C ABI (`tuatara_capi.h`, the JAX
  package's ABI), which embeds CPython and routes to `tuatara_tpu_torch`;
- `capi_example-<hash>`: a standalone C program linked against it
  (`build_example()`; another C source written for the same header, e.g.
  the JAX package's `native/capi_example.c`, builds the same way);
- `_pytuatara_torch-<hash>.so`: the compiled binding that
  `tuatara_tpu_torch.pytuatara` calls.

Each is named by a hash of its sources and flags and written whole
(`_hostbuild`). Python's headers and library come from `sysconfig`; the C
ABI needs a shared libpython. A failed build raises with the compiler's
output.

`image_to_data` calls the C ABI through ctypes in this process; the library
joins the running interpreter. `embedded_env` is the environment a program
that embeds the library needs to find this package and torch.
"""

from __future__ import annotations

import ctypes
import importlib.machinery
import importlib.util
import os
import site
import sys
import sysconfig
import threading
from typing import Dict, List, Optional

import numpy as np

from ._hostbuild import compile_once, target

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
SRC_DIR = os.path.join(PKG_DIR, "csrc", "capi")
BUILD_DIR = os.path.join(REPO_DIR, "build", "capi")
HEADER = os.path.join(SRC_DIR, "tuatara_capi.h")
EXAMPLE = os.path.join(SRC_DIR, "capi_example.c")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
CFLAGS = ["-O2", "-Wall", "-Wextra"]
MODULE = "_pytuatara_torch"
MAX_ITEMS = 256  # records the ctypes wrappers make room for

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class TuataraItem(ctypes.Structure):
    """`TuataraItem` of tuatara_capi.h."""

    _fields_ = [("text", ctypes.c_char * 256),
                ("bbox", ctypes.c_float * 4),
                ("confidence", ctypes.c_float)]


def python_flags() -> Dict[str, List[str]]:
    """{"include": compile flags, "link": flags that link libpython}."""
    include = sysconfig.get_paths()["include"]
    if not os.path.isfile(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h not found in {include}: the C ABI needs Python's headers")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError("this Python has no shared libpython: the C ABI embeds the "
                           "interpreter and links it")
    libdir = sysconfig.get_config_var("LIBDIR")
    return {"include": [f"-I{include}"],
            "link": [f"-L{libdir}", f"-lpython{sysconfig.get_config_var('LDVERSION')}",
                     f"-Wl,-rpath,{libdir}"]}


def build_library() -> str:
    """The C ABI's shared library, built if missing. -> its path."""
    py = python_flags()
    source = os.path.join(SRC_DIR, "tuatara_capi.cpp")
    flags = CXXFLAGS + py["include"] + py["link"]
    out = target(BUILD_DIR, "libtuatara_capi", ".so", [source, HEADER], flags)
    return compile_once(out, ["g++", *CXXFLAGS, *py["include"], "-shared",
                              f"-Wl,-soname,{os.path.basename(out)}", "-o", "{tmp}", source,
                              *py["link"]], "the C ABI")


def build_example(source: str = EXAMPLE) -> str:
    """A C program written against tuatara_capi.h (default: the port's
    example), linked against the C ABI library beside it. -> its path."""
    lib = build_library()
    flags = CFLAGS + [os.path.basename(lib)]
    out = target(BUILD_DIR, os.path.splitext(os.path.basename(source))[0], "", [source, HEADER],
                 flags)
    return compile_once(out, ["cc", *CFLAGS, f"-I{SRC_DIR}", "-o", "{tmp}", source, lib,
                              "-Wl,-rpath,$ORIGIN"], os.path.basename(source))


def build_pyext() -> str:
    """The compiled binding `_pytuatara_torch`, built if missing. -> its path.
    An extension module takes libpython's symbols from the interpreter that
    loads it, so nothing links libpython here."""
    py = python_flags()
    source = os.path.join(SRC_DIR, "pytuatara_ext.c")
    flags = CFLAGS + py["include"] + ["-fPIC", "-shared"]
    out = target(BUILD_DIR, MODULE, ".so", [source], flags)
    return compile_once(out, ["cc", *flags, "-o", "{tmp}", source], "the compiled binding")


def load_pyext():
    """The `_pytuatara_torch` module, built and imported once."""
    with _lock:
        mod = sys.modules.get(MODULE)
        if mod is None:
            path = build_pyext()
            loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
            spec = importlib.util.spec_from_loader(MODULE, loader, origin=path)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            sys.modules[MODULE] = mod
        return mod


def load_library() -> ctypes.CDLL:
    """The C ABI library, built and loaded once, its two functions bound."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.tuatara_image_to_data.restype = ctypes.c_int
            lib.tuatara_image_to_data.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(TuataraItem), ctypes.c_int]
            lib.tuatara_last_error.restype = ctypes.c_char_p
            lib.tuatara_last_error.argtypes = []
            _lib = lib
        return _lib


def call(image: np.ndarray, weights_dir: Optional[str] = None,
         outputs_dir: Optional[str] = None):
    """`tuatara_image_to_data` on an [H, W, 3] or [H, W] uint8 array. ->
    (its return value, the item array). The device comes from
    $TUATARA_TORCH_DEVICE, as for any caller of the library."""
    lib = load_library()
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"expected an [H, W] or [H, W, C] uint8 array, got "
                         f"{image.dtype} {image.shape}")
    buf = np.ascontiguousarray(image)
    h, w = buf.shape[:2]
    c = 1 if buf.ndim == 2 else buf.shape[2]
    items = (TuataraItem * MAX_ITEMS)()
    n = lib.tuatara_image_to_data(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w, c,
        weights_dir.encode() if weights_dir else None,
        outputs_dir.encode() if outputs_dir else None, items, MAX_ITEMS)
    return n, items


def last_error() -> str:
    """`tuatara_last_error()` of this thread."""
    return load_library().tuatara_last_error().decode()


def image_to_data(image: np.ndarray, weights_dir: Optional[str] = None,
                  outputs_dir: Optional[str] = None) -> List[Dict]:
    """The C ABI's records as [{text, bbox, confidence}] (float32 values
    widened to Python floats). Raises RuntimeError with
    tuatara_last_error() when the call returns -1."""
    n, items = call(image, weights_dir, outputs_dir)
    if n < 0:
        raise RuntimeError(last_error())
    return [{"text": it.text.decode(), "bbox": [float(v) for v in it.bbox],
             "confidence": float(it.confidence)} for it in items[:n]]


def embedded_env(device: Optional[str] = None) -> Dict[str, str]:
    """This process's environment for a program that embeds the C ABI:
    PYTHONPATH reaching this repo and this interpreter's site-packages (an
    embedded interpreter knows no virtual environment), and
    TUATARA_TORCH_DEVICE when `device` is given."""
    env = dict(os.environ)
    paths = [REPO_DIR, *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    if device is not None:
        env["TUATARA_TORCH_DEVICE"] = device
    return env
