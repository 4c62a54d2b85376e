"""ctypes binding to the native host post-processing library (port of
`tuatara_tpu/native.py`).

`native/tuatara_postproc.cpp` is dependency-free C++: union-find 4-connected
labeling, box extraction with the reference's semantics, and a rotating-
calipers minAreaRect. It is compiled with `g++ -O3` at first use into
`build/native/` beside the package (never into `native/`), named by a hash
of the source and flags (`_hostbuild`), and loaded with ctypes. It is an
explicit host API and an independent oracle for the card's
post-processing; the engine never falls back to it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from ._hostbuild import compile_once, target

_LIB: Optional[ctypes.CDLL] = None
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "tuatara_postproc.cpp")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
SO_PATH = target(os.path.join(_ROOT, "build", "native"), "libtuatara_postproc", ".so",
                 [SOURCE], FLAGS)


def load() -> ctypes.CDLL:
    """Load the native library, building it first when it is missing."""
    global _LIB
    if _LIB is not None:
        return _LIB
    compile_once(SO_PATH, ["g++", *FLAGS, "-o", "{tmp}", SOURCE], "the native library")
    lib = ctypes.CDLL(SO_PATH)
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.tuatara_extract_boxes.restype = ctypes.c_int
    lib.tuatara_extract_boxes.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, i32p]
    lib.tuatara_label_components.restype = ctypes.c_int
    lib.tuatara_label_components.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def extract_boxes(textmap: np.ndarray, linkmap: np.ndarray, text_threshold: float = 0.7,
                  link_threshold: float = 0.4, low_text: float = 0.4, min_area: int = 10,
                  niter_mode: str = "reference", max_boxes: int = 256
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host box extraction on [H, W] heatmaps -> (boxes [N, 4] fp32
    heatmap-coordinate AABBs, corners [N, 4, 2] rotated min-area rects,
    the number of components)."""
    lib = load()
    t = np.ascontiguousarray(textmap, np.float32)
    link = np.ascontiguousarray(linkmap, np.float32)
    h, w = t.shape
    out = np.zeros((max_boxes, 12), np.float32)
    ncomp = ctypes.c_int(0)
    f32p = ctypes.POINTER(ctypes.c_float)
    n = lib.tuatara_extract_boxes(
        t.ctypes.data_as(f32p), link.ctypes.data_as(f32p), h, w,
        text_threshold, link_threshold, low_text, min_area,
        0 if niter_mode == "reference" else 1,
        out.ctypes.data_as(f32p), max_boxes, ctypes.byref(ncomp))
    return out[:n, :4].copy(), out[:n, 4:].reshape(n, 4, 2).copy(), int(ncomp.value)


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Host 4-connected labeling -> (labels [H, W] int32, -1 off the mask;
    the number of components)."""
    lib = load()
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    h, w = m.shape
    labels = np.zeros((h, w), np.int32)
    n = lib.tuatara_label_components(m.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h, w,
                                     labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, int(n)
