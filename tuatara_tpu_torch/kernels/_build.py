"""Build the CUDA sources under `tuatara_tpu_torch/csrc/` and load them.

Each source is compiled by its own `nvcc` call into a shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). A library's file name carries a hash of its source and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
libraries go to `build/kernels/` beside the package (listed in
`.gitignore`). `build_all()` starts every compile at once and waits for all
of them; a failed compile raises with nvcc's output. Nothing links against
the driver library: `csrc/vit.cu` and `csrc/stage1.cu` obtain
`cuTensorMapEncodeTiled` (their TMA descriptors) at run time through the
runtime's `cudaGetDriverEntryPoint`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("cc", "stats", "vit", "decode", "stage1", "hull")

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for p in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if p and os.path.isfile(p):
            return p
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every library that is missing, all at once. -> seconds."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = _target(name)
        if os.path.isfile(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, proc, tmp, out))
    errors: List[str] = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not os.path.isfile(out):
                build_all([name])
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    """C entry `int symbol(void* x n_ptr, int x n_int, float x n_float,
    stream)` of csrc/<name>.cu, bound once: every pointer and the stream are
    declared c_void_p, so none is cut to 32 bits."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn
