"""Write `tuatara_tpu_torch/data/rsqrtps_table.npy`, the table of x86's
`rsqrtps` (the 12-bit reciprocal square root estimate) that the port's
BatchNorm fold needs to fold as the JAX package folds on the CPU.

    python tests/gen_rsqrt_table.py

JAX folds with `scale * jax.lax.rsqrt(var + eps)`
(`tuatara_tpu/models/craft.py` `_fold_batchnorms_jit`). XLA's CPU backend
lowers an fp32 rsqrt to `rsqrtps` and two Newton steps with fused
multiply-adds (its LLVM IR: `llvm.x86.avx.rsqrt.ps.256`), so the result
is within an ulp of the true value but not correctly rounded, and which
ulp depends on the estimate. The estimate depends only on the exponent's
parity and the top 10 bits of the significand (checked here over every
significand of [1, 4), and its scaling by 4^k), so 2 x 1024 values hold
it: entry `parity * 1024 + top10` is the estimate for the input
`(1 + top10 / 1024) * 2^parity`. `weights.xla_rsqrt` reads it. The table
is the instruction's as this script reads it on the host it runs on (an
x86 CPU with AVX; the committed one comes from the Intel CPU the JAX
records were made on: other vendors' tables differ). Needs gcc.
"""

import ctypes
import os
import subprocess
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tuatara_tpu_torch", "data", "rsqrtps_table.npy")
SOURCE = r"""
#include <immintrin.h>
void rsqrt_ps(const float* x, float* y, long n) {
  for (long i = 0; i + 8 <= n; i += 8) _mm256_storeu_ps(y + i, _mm256_rsqrt_ps(_mm256_loadu_ps(x + i)));
}
"""


def hardware_rsqrt():
    """-> f(x: fp32 array, length a multiple of 8) -> `rsqrtps` of it."""
    tmp = tempfile.mkdtemp()
    src, lib = os.path.join(tmp, "rs.c"), os.path.join(tmp, "librs.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run(["gcc", "-O2", "-mavx", "-shared", "-fPIC", "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).rsqrt_ps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]

    def call(x):
        x = np.ascontiguousarray(x, np.float32)
        y = np.empty_like(x)
        fn(x.ctypes.data, y.ctypes.data, x.size)
        return y
    return call


def main():
    rs = hardware_rsqrt()
    m = np.arange(1 << 23, dtype=np.uint32)
    top = np.arange(1024, dtype=np.uint32)
    table = []
    for e in (127, 128):  # [1, 2) and [2, 4)
        x = ((np.uint32(e) << np.uint32(23)) | m).view(np.float32)
        y = rs(x)
        est = rs(((np.uint32(e) << np.uint32(23)) | (top << np.uint32(13))).view(np.float32))
        assert np.array_equal(y, est[m >> np.uint32(13)]), "the estimate reads more than 10 bits"
        assert np.array_equal(rs(x * np.float32(4)), y / np.float32(2)), "not scale invariant"
        table.append(est)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.save(OUT, np.concatenate(table))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
