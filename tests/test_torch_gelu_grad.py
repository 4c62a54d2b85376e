"""The port's 16-bit GELU, forward and gradient, against XLA's CPU graph of
the JAX package's (ROADMAP Queue 3 item 20), and a numpy model of the
`gelu_grad` kernel (GG, `tuatara_tpu_torch/csrc/bias_act.cu`).

JAX's `mlp` (`tuatara_tpu/models/layers.py:443-445`) applies
`jax.nn.gelu(approximate=False)`. XLA's compiled gradient rounds every
product of its backward to bf16, takes -2/sqrt(pi) as bf16's -1.125 and
flushes denormals (`tests/probe_torch_bf16.py hlo`, `gelu_vjp_form`). The
port computes it the same way (`kernels/bias_act.gelu_plain_grad`), its
terms that depend on v alone read from a table XLA wrote
(`tests/gen_torch_gelu_table.py`). Held here, on every finite value of the
dtype: the gradient bit-equal to JAX's jitted vjp under four draws of g
(`chip_smoke.gelu_grad_draws`), the forward bit-equal to `jax.nn.gelu`,
the committed table equal to a live regeneration (this file's one live
run of the generator), the CPU training graph's gradient (autograd
through `bias_act_plain`) equal to JAX's inside a jitted `mlp`, and the
kernel's index map and arithmetic, modelled in numpy, equal to the plain
version. fp16: JAX's jitted fp16 graph contracts the last product into
the difference (one rounding, on hosts with AVX512-FP16); the port keeps
every rounding, which is JAX's vjp run op by op.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tuatara_tpu.models import layers as JL
from tuatara_tpu_torch.kernels import bias_act as BA
from tuatara_tpu_torch.models import layers as TL

from gen_torch_gelu_table import DATA, TABLES, WINDOW, jax_terms, window
from probe_torch_bf16 import GELU_GRAD_FORM, gelu_vjp_form
from torch_common import torch_threads  # noqa: F401

BF16, FP16 = torch.bfloat16, torch.float16
DTYPES = {BF16: jnp.bfloat16, FP16: jnp.float16}
FORMATS = {BF16: (0x7F80, 7), FP16: (0x7C00, 10)}  # bit magnitude of Inf, significand bits


def patterns(dtype):
    """All 65,536 values of `dtype` in bit order."""
    return torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(np.int16)).view(dtype)


def finite(dtype):
    v = patterns(dtype)
    return v[torch.isfinite(v.float())]


def to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(DTYPES[t.dtype])


def from_jax(a, dtype):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def jax_vjp(v, g, jit=True):
    """JAX's gradient of `jax.nn.gelu(approximate=False)` at v for the
    output gradient g: compiled by XLA (jit) or op by op."""
    def vjp(v, g):
        return jax.vjp(lambda t: jax.nn.gelu(t, approximate=False), v)[1](g)[0]
    fn = jax.jit(vjp) if jit else vjp
    return from_jax(fn(to_jax(v), to_jax(g)), v.dtype)


def assert_same(got, want):
    """Bit for bit where finite (torch.equal), NaN at the same places."""
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    assert torch.equal(got[~nan], want[~nan])


def draw(name, n, dtype):
    return torch.from_numpy(chip_smoke.gelu_grad_draws(n)[name]).to(dtype)


@pytest.mark.parametrize("name", ["fc1", "unit", "tiny", "mixed"])
def test_gelu_plain_grad_equals_jax_vjp(name):
    v = finite(BF16)
    g = draw(name, v.numel(), BF16)
    assert_same(BA.gelu_plain_grad(g, v), jax_vjp(v, g))


@pytest.mark.parametrize("dtype", [BF16, FP16], ids=str)
def test_gelu_plain_equals_jax_gelu(dtype):
    v = finite(dtype)
    want = from_jax(jax.jit(lambda x: jax.nn.gelu(x, approximate=False))(to_jax(v)), dtype)
    got = BA.gelu_plain(v)
    assert torch.equal(got, want)
    # Denormals flushed as XLA flushes them: the forward's tail far left.
    assert torch.equal(got[v.float() < -13.5], torch.zeros_like(got[v.float() < -13.5]))


def test_table_equals_live_regeneration():
    """The committed tables and window against the generator's JAX run."""
    with open(os.path.join(DATA, WINDOW)) as f:
        committed = json.load(f)
    for name, file in TABLES.items():
        table = jax_terms(name)
        assert np.array_equal(np.load(os.path.join(DATA, file)), table)
        lo, hi = window(table, name)
        assert committed[name] == {"lo_exp": lo, "hi_exp": hi}


@pytest.mark.parametrize("dtype", [BF16, FP16], ids=str)
def test_fp16_and_bf16_forms_as_jax_computes_them(dtype):
    """bf16: the gradient is JAX's jitted vjp (above), not its vjp op by op
    (which rounds erfc's argument); fp16: the gradient is JAX's vjp op by
    op, and XLA's jitted graph differs only by one rounding fewer, its last
    product and the difference taken together."""
    v = finite(dtype)
    g = draw("unit", v.numel(), dtype)
    got = BA.gelu_plain_grad(g, v)
    eager = jax_vjp(v, g, jit=False)
    jitted = jax_vjp(v, g)
    if dtype == BF16:
        assert not torch.equal(got, eager)
        return
    assert_same(got, eager)
    # The jitted graph: T(m0 - t2 * s) in one rounding, computed in fp64.
    table = torch.from_numpy(BA.gelu_window(dtype)[0].view(np.int32)).view(torch.int16)
    w = table.view(-1, 2)[v.view(torch.int16).long() & 0xFFFF]
    e, ex = w[:, 0].view(dtype).double(), w[:, 1].view(dtype).double()
    r = lambda x: x.to(dtype).double()  # noqa: E731
    s, k = BA.sqrt_half(dtype), BA.erfc_grad(dtype)
    gd = g.double()
    t2 = r(r(r(r(v.double() * 0.5) * gd) * k) * ex)
    fused = (r(r(gd * e) * 0.5) - t2 * s).to(dtype)
    assert_same(fused, jitted)
    assert not torch.equal(got[~got.isnan()], jitted[~got.isnan()])


def test_hlo_gelu_backward_is_the_ports_form():
    """XLA's graph of the gradient of JAX's bf16 `mlp`, read from its HLO,
    is the form the port computes."""
    assert gelu_vjp_form() == GELU_GRAD_FORM


def test_cpu_training_graph_takes_jax_gradient():
    """The port's bf16 `Mlp` on the CPU, autograd through `bias_act_plain`,
    against JAX's jitted gradient of `mlp`. The input is the identity, so
    fc1's product is its weight, exactly, in both (v the same), fc1's
    weight gradient is the gradient at the GELU's input, exactly, and with
    dyadic fc2 weights and loss weights the gradient at the GELU's output
    (captured by a hook) is exact in both too: what remains is the GELU's
    backward."""
    d, hidden = 64, 1536
    rng = np.random.default_rng(3)
    params = {"fc1": {"w": rng.normal(0, 1, (d, hidden)).astype(np.float32),
                      "b": rng.normal(0, 0.3, hidden).astype(np.float32)},
              "fc2": {"w": (rng.integers(-1, 2, (hidden, d)) / 8).astype(np.float32),
                      "b": rng.normal(0, 0.3, d).astype(np.float32)}}
    x = np.eye(d, dtype=np.float32)
    c = (rng.integers(-1, 2, (d, d)) / 1024).astype(np.float32)

    def loss(p, x):
        return jnp.sum(JL.mlp(p, x).astype(jnp.float32) * c)

    want = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, params), x)

    mlp = TL.Mlp(d, hidden)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(mlp, name).weight.copy_(torch.from_numpy(params[name]["w"].T))
            getattr(mlp, name).bias.copy_(torch.from_numpy(params[name]["b"]))
    TL.set_compute_dtype(mlp, BF16)
    seen = {}

    def hook(module, args, kwargs, out):
        seen["h"] = out
        out.register_hook(lambda grad: seen.setdefault("g", grad))

    mlp.fc1.register_forward_hook(hook, with_kwargs=True)
    y = mlp(torch.from_numpy(x))
    (y.float() * torch.from_numpy(c)).sum().backward()

    v = (torch.from_numpy(params["fc1"]["w"]).to(BF16)
         + torch.from_numpy(params["fc1"]["b"]).to(BF16))
    g = (torch.from_numpy(c).to(BF16).double() @ torch.from_numpy(
        params["fc2"]["w"]).to(BF16).double().T).to(BF16)
    assert torch.equal(seen["g"], g)  # exact in both
    assert torch.equal(seen["h"], BA.gelu_plain(v))
    got = mlp.fc1.weight.grad.T.contiguous()
    jax_gv = torch.from_numpy(np.asarray(want["fc1"]["w"]))
    assert torch.equal(got, jax_gv)
    # JAX's gradient inside the jitted mlp is its standalone vjp's.
    assert torch.equal(jax_vjp(v, g).float(), jax_gv)


# ---- a numpy model of the gelu_grad kernel -----------------------------------


def _f32(bits16, dtype):
    """16-bit patterns (uint32 array) -> fp32 values, as the kernel widens
    them (bf16: a shift; fp16: a conversion)."""
    if dtype == BF16:
        return (bits16.astype(np.uint32) << np.uint32(16)).view(np.float32)
    return bits16.astype(np.uint16).view(np.float16).astype(np.float32)


def _bits16(x, dtype):
    """fp32 -> the dtype's patterns, rounded to nearest even (NaN: 0x7fff,
    the card's)."""
    if dtype == BF16:
        b = x.view(np.uint32)
        out = ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1)))
               >> np.uint32(16)).astype(np.uint32)
    else:
        out = x.astype(np.float16).view(np.uint16).astype(np.uint32)
    out[np.isnan(x)] = 0x7FFF
    return out


def _ftz(x):
    return np.where(np.abs(x) < np.float32(2.0 ** -126), x * np.float32(0), x).astype(np.float32)


def _mul_ftz(a, b):
    """PTX mul.rn.ftz.f32."""
    return _ftz(_ftz(a) * _ftz(b))


def _special8(words, dtype):
    """The kernel's test for Inf or NaN among a group's 4 words (8 values)."""
    inf = np.uint32(FORMATS[dtype][0])
    add = ((np.uint32(0x8000) - inf) << np.uint32(16)) | (np.uint32(0x8000) - inf)
    m = np.bitwise_or.reduce((words & np.uint32(0x7FFF7FFF)) + add, axis=-1)
    return (m & np.uint32(0x80008000)) != 0


def _regular8(gw, vw):
    """The kernel's test that a group's 8 values of g (magnitudes in [2^-30,
    2^60)) and of v ([2^-30, 8)) are regular, on [groups, 4] words."""
    def half(x):
        return np.uint32(x) << np.uint32(16) | np.uint32(x)
    lo, hv, hg = half(0x8000 - 0x3080), half(0x8000 - 0x4100), half(0x8000 - 0x5D80)
    mg, mv = gw & np.uint32(0x7FFF7FFF), vw & np.uint32(0x7FFF7FFF)
    all_lo = np.bitwise_and.reduce((mg + lo) & (mv + lo), axis=-1)
    any_hi = np.bitwise_or.reduce((mg + hg) | (mv + hv), axis=-1)
    return (all_lo & ~any_hi & np.uint32(0x80008000)) == np.uint32(0x80008000)


def _staged(table, lo, hi):
    """The window as the kernel stages it: table[lo4:hi4] and table[0x8000 +
    lo4:0x8000 + hi4], lo4 = lo & ~3 and hi4 = (hi | 3) + 1, the ends rounded
    out to whole 16-byte loads. -> (the entries, lo4, the span a sign)."""
    lo4, hi4 = lo & ~3, (hi | 3) + 1
    win = np.concatenate([table[lo4:hi4], table[0x8000 + lo4:0x8000 + hi4]])
    return win, lo4, hi4 - lo4


def _window_pair(staged, words, lo, hi):
    """The kernel's `window_pair` on uint32 words of two 16-bit patterns:
    both magnitudes clamped to [lo, hi] in 16-bit lanes, the span added to
    a negative one's lane -> (the low value's entries, the high value's)."""
    win, lo4, span = staged
    lanes = [np.clip(words & np.uint32(0x7FFF), lo, hi),
             np.clip((words >> np.uint32(16)) & np.uint32(0x7FFF), lo, hi)]
    m = lanes[0].astype(np.uint32) | (lanes[1].astype(np.uint32) << np.uint32(16))
    m = m + ((words >> np.uint32(15)) & np.uint32(0x00010001)) * np.uint32(span)
    assert np.array_equal(m >> np.uint32(16), lanes[1] + np.where(words >> np.uint32(31), span, 0))
    return (win[(m & np.uint32(0xFFFF)).astype(np.int64) - lo4],
            win[(m >> np.uint32(16)).astype(np.int64) - lo4])


def kernel_model(g, v):
    """gelu_grad's result, as csrc/bias_act.cu computes it, in numpy: the
    values as 16-byte groups of 4 words; the window staged from the table
    (bf16) and read by v's clamped magnitude unless the group holds an Inf
    or NaN, else the table itself (and always for fp16); then grad2's
    products on each pair. -> (the result, which groups took the table)."""
    with np.errstate(over="ignore", invalid="ignore"):
        return _kernel_model(g, v)


def _kernel_model(g, v):
    dtype = v.dtype
    table, lo, hi = BA.gelu_window(dtype)
    staged = _staged(table, lo, hi)
    pad = -v.numel() % 8
    words = [np.pad(t.view(torch.int16).numpy().view(np.uint16), (0, pad)).astype(np.uint32)
             for t in (g, v)]
    gw, vw = (w[0::2] | (w[1::2] << np.uint32(16)) for w in words)
    special = _special8(vw.reshape(-1, 4), dtype)
    use_table = np.repeat(special | (dtype == FP16), 4)
    halves = [vw & np.uint32(0xFFFF), vw >> np.uint32(16)]
    t = [np.where(use_table, table[h], w) for h, w in zip(halves, _window_pair(staged, vw, lo, hi))]
    s, k = np.float32(BA.sqrt_half(dtype)), np.float32(BA.erfc_grad(dtype))
    half = dtype == FP16

    def rnd(x):
        return _f32(_bits16(x, dtype), dtype)

    # A regular bf16 group takes the bf16x2 chain: each product rounded
    # once, nothing flushed.
    packed = np.repeat(_regular8(gw.reshape(-1, 4), vw.reshape(-1, 4)) & (dtype == BF16), 4)
    out = []
    for j, shift in ((0, 0), (1, 16)):
        gx = _f32((gw >> np.uint32(shift)) & np.uint32(0xFFFF), dtype)
        vx = _f32(halves[j], dtype)
        e, ex = _f32(t[j] & np.uint32(0xFFFF), dtype), _f32(t[j] >> np.uint32(16), dtype)
        hx = _mul_ftz(vx, np.float32(0.5))
        if half:
            hx = rnd(hx)
        tt = rnd(_mul_ftz(rnd(_mul_ftz(rnd(_mul_ftz(rnd(_mul_ftz(hx, gx)), k)), ex)), s))
        m = _mul_ftz(rnd(_mul_ftz(gx, e)), np.float32(0.5))
        if half:
            m = rnd(m)
        exact = _bits16(_ftz(_ftz(m) - _ftz(tt)), dtype)
        pt = rnd(rnd(rnd(rnd(rnd(vx * np.float32(0.5)) * gx) * k) * ex) * s)
        fast = _bits16(rnd(rnd(gx * e) * np.float32(0.5)) - pt, dtype)
        out.append(np.where(packed, fast, exact))
    res = np.empty(2 * vw.size, np.uint16)
    res[0::2], res[1::2] = out[0], out[1]
    res = torch.from_numpy(res[:v.numel()].view(np.int16)).view(dtype)
    return res, special


@pytest.mark.parametrize("dtype", [BF16, FP16], ids=str)
def test_kernel_window_and_index_map(dtype):
    """Every bit pattern of v reaches its own entry, or an equal one: the
    window's clamp for values outside it, the table in global memory for
    a group with an Inf or NaN; the kernel's group test finds exactly the
    groups that hold one."""
    table, lo, hi = BA.gelu_window(dtype)
    inf = FORMATS[dtype][0]
    u = np.arange(1 << 16, dtype=np.uint32)
    # Each pattern in either lane of a word, beside every other.
    words = u | (np.roll(u, 12345) << np.uint32(16))
    got_lo, got_hi = _window_pair(_staged(table, lo, hi), words, lo, hi)
    special = (u & 0x7FFF) >= inf
    assert np.array_equal(np.where(special, table[u], got_lo), table[u])
    assert np.array_equal(np.where(special[np.roll(u, 12345)], table[np.roll(u, 12345)], got_hi),
                          table[np.roll(u, 12345)])
    assert dtype == FP16 or not np.array_equal(got_lo[special], table[u][special])
    # Groups of 8: each pattern with every other, and a group of finite
    # neighbours only.
    rng = np.random.default_rng(0)
    groups = rng.permutation(u).reshape(-1, 8)
    words = groups[:, 0::2] | (groups[:, 1::2] << np.uint32(16))
    assert np.array_equal(_special8(words, dtype), special[groups].any(axis=1))
    if dtype == BF16:
        # The kernel stages [lo & ~3, (hi | 3) + 1) of each sign, at most
        # 2048 entries a sign (16-byte loads, 4 a thread of 256).
        assert ((hi | 3) + 1) - (lo & ~3) <= 2048


@pytest.mark.parametrize("dtype", [BF16, FP16], ids=str)
def test_kernel_model_equals_plain_version(dtype):
    """The kernel's arithmetic (pairs of values, mul.rn.ftz, one rounding
    after each product, 0.5 * v and 0.5 * T(g * e) unrounded in bf16; a
    regular bf16 group's bf16x2 chain, unflushed) on every bit pattern of
    v under the four draws of g, against the plain version; and on v at
    fc1's scale, where most groups are regular."""
    v = patterns(dtype)
    for name in ("fc1", "unit", "tiny", "mixed"):
        g = draw(name, v.numel(), dtype)
        got, special = kernel_model(g, v)
        assert special.any() and not special.all()
        assert_same(got, BA.gelu_plain_grad(g, v))
    rng = np.random.default_rng(1)
    vf = torch.from_numpy(rng.normal(0, 0.7, 1 << 16).astype(np.float32)).to(dtype)
    for name in ("fc1", "unit", "tiny", "mixed"):
        g = draw(name, vf.numel(), dtype)
        got, _ = kernel_model(g, vf)
        assert_same(got, BA.gelu_plain_grad(g, vf))
    if dtype == BF16:
        g = draw("fc1", vf.numel(), dtype)
        words = [t.view(torch.int16).numpy().view(np.uint16).astype(np.uint32) for t in (g, vf)]
        gw, vw = (w[0::2] | (w[1::2] << np.uint32(16)) for w in words)
        assert _regular8(gw.reshape(-1, 4), vw.reshape(-1, 4)).mean() > 0.9
    # An odd count: the last group is partial.
    got, _ = kernel_model(g[:1001], v[5000:6001])
    assert_same(got, BA.gelu_plain_grad(g[:1001], v[5000:6001]))


def test_table_missing_or_wrong_raises(tmp_path, monkeypatch):
    for dtype in (BF16, FP16):
        table, _, _ = BA.gelu_window(dtype)
        assert table.shape == (1 << 16,) and table.dtype == np.uint32
    monkeypatch.setattr(BA, "_TABLES", {})
    monkeypatch.setattr(BA, "_DATA", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        BA.gelu_window(BF16)
    np.save(tmp_path / "gelu_bf16_table.npy", np.zeros(1000, np.uint32))
    (tmp_path / "gelu_window.json").write_text(json.dumps({"bfloat16": {"lo_exp": -9,
                                                                        "hi_exp": 4}}))
    with pytest.raises(ValueError, match="expected uint32 \\[65536\\]"):
        BA.gelu_window(BF16)
    np.save(tmp_path / "gelu_bf16_table.npy", np.arange(1 << 16, dtype=np.uint32))
    with pytest.raises(ValueError, match="not constant outside its window"):
        BA.gelu_window(BF16)
