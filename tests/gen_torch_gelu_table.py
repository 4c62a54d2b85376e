"""Write `tuatara_tpu_torch/data/gelu_{bf16,fp16}_table.npy` and
`gelu_window.json`, the terms of JAX's 16-bit GELU gradient that depend on
the pre-activation value v alone, as XLA's CPU backend computes them.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/gen_torch_gelu_table.py

The JAX package's `mlp` (`tuatara_tpu/models/layers.py:443-445`) applies
`jax.nn.gelu(approximate=False)`, `0.5 * x * erfc(-x * s)` with s =
sqrt(1/2) in the dtype T. XLA's optimised graph of its gradient (printed by
`tests/probe_torch_bf16.py hlo`) computes, for the output gradient g:

    a  = T(-x) * s                        (bf16: fed to erfc unrounded; fp16: T(.))
    e  = T(erfc(a))                       XLA's erfc polynomial
    ex = T(exp(-T(T(a)^2)))
    gx = T(T(T(g * e) * 0.5) - T(T(T(T(T(0.5 x) * g) * k) * ex) * s)),  k = T(-2/sqrt(pi))

each product rounded to T, denormals flushed (XLA's CPU backend runs with
flush-to-zero). e and ex depend on x alone, so each is one of 65,536
values: entry `bits(x)` of the table is e | ex << 16 (uint32), computed by
XLA on every bit pattern of the dtype. `kernels/bias_act.gelu_plain_grad`
reads it by v's bits and runs the g-dependent products in PyTorch; the
`gelu_grad` kernel stages part of it in shared memory.

`gelu_window.json` holds, for each dtype, the exponent window outside
which the entries are constant: every |x| < 2^lo_exp (and x = 0, and the
denormals) shares the entry of x = 0, and every finite |x| >= 2^hi_exp
shares the entry of the largest finite value of its sign. The kernel
reads those constants for any value outside the window.

The terms are computed by jitting JAX's own subexpressions on the bit
patterns; `tests/test_torch_gelu_grad.py` regenerates the table live and
holds the gradient built on it bit-equal to JAX's compiled vjp on every
finite bf16 value.
"""

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tuatara_tpu_torch", "data")
TABLES = {"bfloat16": "gelu_bf16_table.npy", "float16": "gelu_fp16_table.npy"}
WINDOW = "gelu_window.json"
# dtype -> (exponent bias, significand bits, bit magnitude of +Inf)
FORMATS = {"bfloat16": (127, 7, 0x7F80), "float16": (15, 10, 0x7C00)}


def jax_terms(dtype: str) -> np.ndarray:
    """-> uint32 [65536]: entry b is e | ex << 16 for the value of bit
    pattern b of `dtype`, as XLA's CPU backend computes JAX's terms."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    dt = jnp.dtype(dtype)
    s = np.sqrt(0.5).astype(dt)
    x = jnp.asarray(np.arange(1 << 16, dtype=np.uint16).view(dt))

    def ex_term(v):
        a = -v * s
        return jnp.exp(-(a * a))

    e = np.asarray(jax.jit(lambda v: lax.erfc(-v * s))(x)).view(np.uint16)
    ex = np.asarray(jax.jit(ex_term)(x)).view(np.uint16)
    return e.astype(np.uint32) | (ex.astype(np.uint32) << np.uint32(16))


def window(table: np.ndarray, dtype: str):
    """-> (lo_exp, hi_exp): the narrowest exponent window outside which
    the entries are constant (see the module docstring)."""
    bias, mant, inf = FORMATS[dtype]
    mags = np.arange(inf)
    pos, neg = table[mags], table[0x8000 | mags]
    small = table[0]
    top = int(inf) >> mant  # exponent field of Inf
    lo = 0
    while lo + 1 < top and np.all(pos[:(lo + 1) << mant] == small) and np.all(
            neg[:(lo + 1) << mant] == small):
        lo += 1
    hi = top
    while hi - 1 > lo and np.all(pos[(hi - 1) << mant:] == pos[-1]) and np.all(
            neg[(hi - 1) << mant:] == neg[-1]):
        hi -= 1
    return lo - bias, hi - bias


def main():
    os.makedirs(DATA, exist_ok=True)
    windows = {}
    for dtype, name in TABLES.items():
        table = jax_terms(dtype)
        np.save(os.path.join(DATA, name), table)
        lo, hi = window(table, dtype)
        windows[dtype] = {"lo_exp": lo, "hi_exp": hi}
        print(f"wrote {name}: constant below 2^{lo} and from 2^{hi}")
    with open(os.path.join(DATA, WINDOW), "w") as f:
        json.dump(windows, f, indent=1)
        f.write("\n")
    print(f"wrote {WINDOW}")


if __name__ == "__main__":
    main()
