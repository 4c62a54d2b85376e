"""The default compute dtype (bf16) of the port against the JAX package, on
the CPU (ROADMAP Queue 3 item 19).

JAX's `conv2d` and `linear` round a bf16 product to bf16 and then add the
bias, cast to bf16, with a second rounding; its float decoder convolves
the trunk side at low resolution and upsamples the result; its
`jax.image.resize` contracts one axis, rounds, then the other; its
attention logits are fp32 sums never rounded to bf16; its exact GELU
rounds erfc to bf16 before the last product. The port rounds at the same
points (`models/layers.add_bias`, `kernels/bias_act.py`,
`models/craft.upsample_to`, `Craft._double_conv`,
`models/layers.attention_logits`). Held here:

* `Conv`, `Linear` and `PaddedLinear` at bf16 bit-equal to JAX's compiled
  `conv2d` / `linear` on seeded inputs (at least 99.99%; the sums of the
  two products run in their own orders), with the ReLU and the pre-ReLU
  output that CRAFT's trunk takes from one `bias_act` pass;
* `upsample_to` at bf16 bit-equal to `jax.image.resize` on every shape
  tried: H < W, H = W, H > W, odd sizes, the decoder levels' own shapes
  and sizes that are not 2x (a canvas that is not a multiple of 32), where
  the axis order is opt_einsum's cheaper one;
* each float decoder level on the golden weights, fed JAX's own inputs,
  against JAX's compiled `conv1_split` and conv2 (at least 99.99%);
* attention at bf16: the logits as fp32 sums, never rounded to bf16, as
  XLA compiles JAX's `einsum(...).astype(float32)`;
* GELU at bf16: the share of outputs that still differs from JAX's
  compiled `jax.nn.gelu(approximate=False)` (`F.gelu` beside it);
* the plain `bias_act` against "product, + bias rounded, then act", in
  every layout the kernel takes, `add_bias`'s plain add where no
  activation follows, and the kernel's backward (`bias_act_grads`) and
  the attention logits' (`_Fp32Logits`) against autograd's, bit for bit;
* `OcrConfig()`, `latency()` and `production()` on a dense crop: every
  record equal to JAX's (also with JAX's Pallas recognizer kernels
  forced), its confidence within a stated tolerance: the confidence at
  bf16 is JAX's bf16 softmax, max and product, rounded where XLA rounds
  them (`models.parseq.confidence`);
* at D = 128, where JAX's gates run the Pallas recognizer kernels, the
  port's `recognize` under latency()'s lowering (K6, K7 and the sites and
  confidence around them) against JAX's forced-Pallas `_recognize_body`;
* where XLA leaves a bf16 Linear's bias add unrounded (its sum goes
  straight into an fp32 add: PARSEQ's residuals, `patch_embed +
  pos_embed`), the port's `Linear(x, residual=r)` against JAX's compiled
  sites, the fp32-output mode of `bias_act` (its plain version and
  backward), and the `hlo` probe that lists those sites from XLA's graph,
  also of the forced-Pallas engine (the sites beside K6 and K7) and of
  int8 CRAFT (every dequant, decoder sum and float bias add rounded to
  bf16 before anything reads it, every scale a division, as the port
  computes them).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tuatara_tpu.config import CraftConfig as JaxCraftConfig
from tuatara_tpu.models import craft as jcraft
from tuatara_tpu.models import layers as JL
from tuatara_tpu.utils import weights as JW
from tuatara_tpu_torch.kernels import bias_act as BA
from tuatara_tpu_torch.models import craft as tcraft
from tuatara_tpu_torch.models import layers as TL
from tuatara_tpu_torch.models.craft import Craft
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.weights import craft_state_dict

from probe_torch_bf16 import SHIPPED_SITES, compare
from torch_common import GOLDEN, image, torch_threads  # noqa: F401

BF16 = torch.bfloat16
MIN_EQUAL = 0.9999  # bit-equal share of a layer's outputs
# GELU at bf16, on 200k seeded values ~ N(0, 4^2): the share that still
# differs from JAX's (XLA flushes erfc's denormal results below x = -12.9,
# where GELU is within 1e-37 of 0), and F.gelu's share for contrast.
GELU_MAX_DIFF = 2e-4


def _bf16(x):
    """numpy fp32 -> the same values rounded to bf16, as fp32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16).float().numpy()


def _equal_share(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.mean(got == want))


def _conv_pair(rng, cin, cout, k):
    w = (rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    return w, b


@pytest.mark.parametrize("cin,cout,k,dilation", [(16, 32, 3, 1), (32, 8, 1, 1), (24, 16, 3, 6),
                                                 (3, 16, 3, 1)])
def test_conv_bf16_equals_jax_conv2d(cin, cout, k, dilation):
    rng = np.random.default_rng(cin * 100 + cout + k + dilation)
    w, b = _conv_pair(rng, cin, cout, k)
    x = _bf16(rng.standard_normal((2, 20, 28, cin)).astype(np.float32))
    want = jax.jit(lambda v: JL.conv2d({"w": w, "b": b}, v, dilation=dilation,
                                       compute_dtype=jnp.bfloat16))(x)
    want = np.asarray(want.astype(jnp.float32))
    conv = TL.Conv(cin, cout, k, dilation)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    TL.set_compute_dtype(conv, BF16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW in channels_last memory, as CRAFT's trunk
    with torch.no_grad():
        got = conv(xt)
        relu, pre = conv(xt, relu=True, keep_pre=True)
    got_nhwc = got.float().permute(0, 2, 3, 1).numpy()
    assert got.dtype == BF16 and _equal_share(got_nhwc, want) >= MIN_EQUAL
    assert torch.equal(pre, got) and torch.equal(relu, F.relu(got))
    # The old form, the bias inside the product's one rounding, parts often.
    with torch.no_grad():
        fused = F.conv2d(xt.to(BF16), conv.weight, conv.bias, padding=conv.padding,
                         dilation=dilation)
    assert _equal_share(fused.float().permute(0, 2, 3, 1).numpy(), want) < 0.95


@pytest.mark.parametrize("cout", [96, 95, 384])
def test_linear_bf16_equals_jax_linear(cout):
    """`Linear`, and `PaddedLinear` (the recognizer head's 95 columns,
    padded to 96 in the product), at bf16 against JAX's compiled `linear`."""
    rng = np.random.default_rng(cout)
    cin = 384
    w = (rng.standard_normal((cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    x = _bf16(rng.standard_normal((3, 26, cin)).astype(np.float32))
    want = jax.jit(lambda v: JL.linear({"w": w, "b": b}, v, compute_dtype=jnp.bfloat16))(x)
    want = np.asarray(want.astype(jnp.float32))
    for cls in (TL.Linear, TL.PaddedLinear):
        lin = cls(cin, cout)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w.T))
            lin.bias.copy_(torch.from_numpy(b))
        TL.set_compute_dtype(lin, BF16)
        with torch.no_grad():
            got = lin(torch.from_numpy(x))
        assert got.dtype == BF16 and _equal_share(got.float().numpy(), want) >= MIN_EQUAL, cls
    # A padded head's rows do not depend on how many rows share the call.
    with torch.no_grad():
        one = lin(torch.from_numpy(x[:1, :3]))
    assert torch.equal(one, got[:1, :3])


# (H, W) -> (h, w): H < W, H = W, H > W, odd sizes, the decoder levels of a
# 256x512 and a 768x768 canvas, and sizes that are not 2x (a canvas of 1000:
# f5 62 -> f4 125; others where the cheaper axis order is not the longer
# axis first).
UPSAMPLE_SHAPES = [((16, 32), (32, 64)), ((32, 64), (64, 128)), ((64, 128), (128, 256)),
                   ((16, 16), (32, 32)), ((48, 48), (96, 96)), ((32, 16), (64, 32)),
                   ((5, 7), (10, 14)), ((3, 5), (6, 10)), ((62, 62), (125, 125)),
                   ((2, 2), (5, 5)), ((10, 7), (13, 20)), ((5, 5), (13, 7)),
                   ((5, 5), (7, 13)), ((9, 4), (12, 9))]


@pytest.mark.parametrize("src,dst", UPSAMPLE_SHAPES, ids=str)
def test_upsample_bf16_equals_jax_resize(src, dst):
    rng = np.random.default_rng(src[0] * 31 + dst[1])
    x = _bf16(rng.standard_normal((2, *src, 8)).astype(np.float32) * 3)
    want = jax.jit(lambda v: jax.image.resize(v, (2, *dst, 8), "bilinear"))(
        jnp.asarray(x).astype(jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)
    for layout in (xt, xt.contiguous()):
        got = tcraft.upsample_to(layout, *dst)
        assert got.dtype == BF16
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)
    # One interpolation, rounded once, parts from JAX's two contractions.
    once = F.interpolate(xt, size=dst, mode="bilinear", align_corners=False)
    assert not np.array_equal(once.float().permute(0, 2, 3, 1).numpy(), want)


def test_upsample_axis_order_is_the_cheaper_contraction():
    """The rule `upsample_to` takes: H first when its contractions cost no
    more products than W first's (opt_einsum's choice, ties to H), which at
    2x is H first when H >= W. Each case above would miss with the other
    order: held on one where the longer-axis rule would choose wrongly."""
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((1, 5, 5, 4)).astype(np.float32))
    want = np.asarray(jax.jit(lambda v: jax.image.resize(v, (1, 13, 7, 4), "bilinear"))(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)
    w_first = tcraft._resize_axis(tcraft._resize_axis(xt, 3, 7), 2, 13)
    h_first = tcraft._resize_axis(tcraft._resize_axis(xt, 2, 13), 3, 7)
    np.testing.assert_array_equal(w_first.float().permute(0, 2, 3, 1).numpy(), want)
    assert not np.array_equal(h_first.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def golden_bf16():
    """(JAX-folded golden CRAFT tree, its config, the port's Craft on that
    tree at bf16). Both packages fold BatchNorm; JAX's rsqrt differs from
    the port's by an ulp on some channels, so both read JAX's fold."""
    ccfg = W.load_configs(GOLDEN)[0]
    tree, _ = JW.load_weights_dir(GOLDEN)
    jfold = jcraft.fold_batchnorms(jax.tree_util.tree_map(jnp.asarray, tree), eps=ccfg.bn_eps)
    m = Craft(ccfg)
    m.load_state_dict(craft_state_dict(jax.tree_util.tree_map(np.asarray, jfold)))
    return jfold, JaxCraftConfig(**dataclasses.asdict(ccfg)), TL.set_compute_dtype(m.eval(), BF16)


def _jax_conv_taps(jfold, canvas, jcfg):
    """JAX's compiled float CRAFT forward at bf16 with every `conv2d`'s
    input and output as outputs, in call order, and the feature map. The
    package's function is wrapped while the forward is traced."""
    saved = JL.conv2d
    taps = []

    def conv(params, x, *a, **k):
        y = saved(params, x, *a, **k)
        taps.append((x, y))
        return y

    def fwd(v):
        taps.clear()
        scores, feat = jcraft.craft_forward(jfold, v, jcfg, compute_dtype=jnp.bfloat16)
        return scores, feat, list(taps)

    JL.conv2d = conv
    try:
        return jax.jit(fwd)(canvas)
    finally:
        JL.conv2d = saved


def test_decoder_levels_bf16_equal_jax(golden_bf16):
    """Each float decoder level (`Craft._double_conv`) at bf16, fed the
    trunk side and the skip that JAX's compiled forward gave its
    `conv1_split` on a resume_example crop: its output against JAX's level
    output (ReLU of conv2; upconv4's conv2 runs width-packed in JAX, so its
    output is the forward's feature map). Then the whole forward."""
    jfold, jcfg, m = golden_bf16
    from tuatara_tpu.api import _canvas_prep as jax_canvas_prep
    from tuatara_tpu.config import OcrConfig as JaxOcrConfig

    page = image("resume_example")[:200, :300].copy()
    canvas = jax.jit(lambda im: jax_canvas_prep(im, JaxOcrConfig()))(page)[None]
    scores, feat, taps = _jax_conv_taps(jfold, canvas, jcfg)
    trunk = len(m.plan) + 2  # the trunk's convs, fc6, fc7
    levels = taps[trunk:trunk + 12]
    shares = []
    for i in range(4):
        (y, _), (skip, _), (_, out) = levels[3 * i:3 * i + 3]
        if i < 3:
            want = np.asarray(jax.nn.relu(out).astype(jnp.float32))
        else:
            want = np.asarray(feat)
        as_port = [torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(BF16).permute(0, 3, 1, 2)
                   for v in (y, skip)]
        assert as_port[0].shape[-2:] != as_port[1].shape[-2:] or i == 0
        with torch.no_grad():
            got = m._double_conv(f"upconv{i + 1}", *as_port)
        shares.append(_equal_share(got.float().permute(0, 2, 3, 1).numpy(), want))
    assert min(shares) >= MIN_EQUAL, shares
    with torch.no_grad():
        got_scores, _ = m(torch.from_numpy(np.asarray(canvas)))
    diff = np.abs(got_scores.numpy() - np.asarray(scores))
    assert diff.max() <= 1 / 64 and diff.mean() <= 1e-4


@pytest.mark.parametrize("lq,lk", [(128, 128), (1, 27)], ids=["encoder", "decode_step"])
def test_attention_bf16_equals_jax(lq, lk):
    """JAX's compiled `attention_core` at bf16 takes the logits as the fp32
    sums of the bf16 products, never rounded to bf16 (XLA folds the
    einsum's `.astype(float32)` into the dot). The port's
    `attention_logits` equals them within the fp32 sums' order (bit for
    bit over the encoder's 32-term sums here; a decode step's
    matrix-vector product adds in another order), and the attention output
    equals JAX's on at least 99.9% of values (softmax's exp in fp32 differs
    by an ulp; the probabilities are rounded to bf16 after it). Rounding
    the logits to bf16 first, as a bf16 product does, parts by up to a
    bf16 step."""
    import math

    rng = np.random.default_rng(lq + lk)
    q, k, v = (_bf16(rng.standard_normal((2, 12, n, 32)).astype(np.float32) * 2)
               for n in (lq, lk, lk))
    mask = rng.random((1, 1, 1, lk)) < 0.8
    mask[..., 0] = True
    scale = 1.0 / math.sqrt(32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want_logits = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        "bhqd,bhkd->bhqk", a, b).astype(jnp.float32) * scale)(jq, jk))
    want = np.asarray(jax.jit(lambda a, b, c: JL.attention_core(
        a, b, c, mask, jnp.bfloat16))(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    logits = (TL.attention_logits(tq, tk) * scale).numpy()
    np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-6)
    if lq > 1:
        np.testing.assert_array_equal(logits, want_logits)
    got = TL.attention_core(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == BF16 and _equal_share(got.float().numpy(), want) >= 0.999
    rounded = torch.matmul(tq, tk.transpose(-1, -2)).float() * scale
    assert np.abs(rounded.numpy() - want_logits).max() > 1e-3


def test_gelu_bf16_share_that_differs_from_jax():
    rng = np.random.default_rng(17)
    x = _bf16((rng.standard_normal(200_000) * 4).astype(np.float32))
    want = jax.jit(lambda v: jax.nn.gelu(v, approximate=False))(jnp.asarray(x).astype(jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(BF16)
    got = TL.gelu(xt).float().numpy()
    plain = F.gelu(xt).float().numpy()
    differs = 1 - _equal_share(got, want)
    assert differs <= GELU_MAX_DIFF
    assert 1 - _equal_share(plain, want) > 0.2  # F.gelu (erf, one rounding) parts often
    # Within |x| < 12 (every value a trained layer gave in practice) none differs.
    inner = np.abs(x) < 12
    assert np.array_equal(got[inner], want[inner])
    # A Linear followed by GELU: one pass, the same rounding as the two steps.
    lin = TL.Linear(8, 16)
    with torch.no_grad():
        lin.weight.normal_(generator=torch.Generator().manual_seed(3))
        lin.bias.normal_(generator=torch.Generator().manual_seed(4))
    TL.set_compute_dtype(lin, BF16)
    v = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(lin(v, act="gelu"), TL.gelu(lin(v)))
        assert torch.equal(TL.linear_gelu(lin, v), TL.gelu(lin(v)))


def _layouts(rng, dtype):
    """(p, dim) in every layout `bias_act` takes: NCHW contiguous and in
    channels_last memory, a Linear's [..., C], an odd element count."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    x = t(2, 6, 5, 7)
    return [(x, 1), (x.contiguous(memory_format=torch.channels_last), 1), (t(3, 4, 10), -1),
            (t(3, 5, 7), -1)]


@pytest.mark.parametrize("dtype", [BF16, torch.float16], ids=str)
@pytest.mark.parametrize("act", [None, "relu", "gelu"])
def test_bias_act_plain_is_round_then_add(dtype, act):
    """`add_bias`: with a ReLU or GELU, `bias_act` (its plain version on
    the CPU); with none, one add that rounds the same way (`bias_act`
    has no such mode)."""
    rng = np.random.default_rng(5)
    for p, dim in _layouts(rng, dtype):
        c = p.shape[dim]
        b = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 2)
        shape = [1] * p.dim()
        shape[dim] = c
        v = (p.float() + b.to(dtype).float().reshape(shape)).to(dtype)
        assert BA._channel_divisor(p, dim) == (1 if p.stride(dim % p.dim()) == 1
                                               else p.shape[2] * p.shape[3])
        if act is None:
            assert torch.equal(TL.add_bias(p, b, None, dim=dim), v)
            assert TL.add_bias(p, None, None, dim=dim) is p
            with pytest.raises(ValueError, match="act must be one of"):
                BA.bias_act(p, b, None, dim=dim)
            continue
        if act == "relu":
            want = torch.clamp(v.float(), min=0).to(dtype)
        else:
            f = v.float()
            a = f * -float(torch.tensor(2 ** -0.5, dtype=dtype))
            if dtype == torch.float16:  # XLA's fp16 graph rounds erfc's argument
                a = a.to(dtype).float()
            e = torch.erfc(a).to(dtype).float()
            want = ((0.5 * f).to(dtype).float() * e).to(dtype)
        y, pre = TL.add_bias(p, b, act, keep_pre=True, dim=dim)
        assert y.dtype == pre.dtype == dtype and y.stride() == p.stride()
        assert torch.equal(pre, v) and torch.equal(y, want)
        assert torch.equal(BA.bias_act(p, None, act, dim=dim),
                           BA.bias_act_plain(p, None, act, dim=dim))
    with pytest.raises(ValueError, match="act must be one of"):
        BA.bias_act(p, b[:p.shape[-1]], "tanh", dim=-1)
    with pytest.raises(ValueError, match="expected a contiguous tensor"):
        BA._channel_divisor(torch.zeros(4, 6, dtype=dtype).t(), -1)


def _jax_gelu_vjp(v, g):
    """JAX's gradient of `jax.nn.gelu(approximate=False)` at v for the
    output gradient g, as the port defines it for the dtype: bf16 compiled
    by XLA; fp16 op by op (XLA's fp16 graph takes its last product and
    difference in one rounding, ROADMAP Queue 3 item 20)."""
    jdt = {BF16: jnp.bfloat16, torch.float16: jnp.float16}[v.dtype]

    def vjp(v, g):
        return jax.vjp(lambda t: jax.nn.gelu(t, approximate=False), v)[1](g)[0]

    fn = jax.jit(vjp) if v.dtype == BF16 else vjp
    out = fn(jnp.asarray(v.float().numpy()).astype(jdt), jnp.asarray(g.float().numpy()).astype(jdt))
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(v.dtype)


@pytest.mark.parametrize("dtype", [BF16, torch.float16], ids=str)
@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("keep_pre", [False, True])
def test_bias_act_grads_equal_autograd_of_plain(dtype, act, keep_pre):
    """The kernel's backward (`bias_act_grads`, which `_BiasAct` runs on the
    card) against autograd through the plain version, bit for bit: the
    gradients of the product and of an fp32 bias (cast to the dtype as
    `add_bias` casts it), in every layout, with and without a bias, and
    with the pre-activation output's gradient present or absent. GELU's
    gradient of the product is held to JAX's vjp of `jax.nn.gelu` at the
    pre-activation value (`_jax_gelu_vjp`), plus the pre-activation
    output's gradient where it is kept."""
    rng = np.random.default_rng(11)
    for p0, dim in _layouts(rng, dtype):
        # Wide values reach GELU's tails (erfc's underflow) and ReLU's 0.
        p0 = (p0.float() * 6).to(dtype)
        c = p0.shape[dim]
        for with_bias in (True, False):
            p = p0.clone().requires_grad_()
            b32 = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).requires_grad_()
            b = b32.to(dtype) if with_bias else None
            out = BA.bias_act_plain(p, b, act, keep_pre, dim)
            gy = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(dtype)
            gpre = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(dtype)
            for use_pre in ((False, True) if keep_pre else (False,)):
                if keep_pre:
                    y, v = out
                    grads = [gy, gpre] if use_pre else [gy]
                    outs = [y, v] if use_pre else [y]
                else:
                    y, v, outs, grads = out, None, [out], [gy]
                want = torch.autograd.grad(outs, [p, b32] if with_bias else [p], grads,
                                           retain_graph=True, allow_unused=True)
                pre = v if v is not None else BA.bias_act_plain(p, b, act, True, dim)[1]
                saved = (y if act == "relu" else pre).detach()
                shape = None if b is None else BA.bias_view(b, p, dim).shape
                gp, gb = BA.bias_act_grads(gy, gpre if use_pre else None, saved, act, shape)
                want_p = want[0]
                if act == "gelu":
                    want_p = _jax_gelu_vjp(pre.detach(), gy)
                    if use_pre:
                        want_p = want_p + gpre
                    assert torch.equal(want[0], want_p)  # autograd takes JAX's too
                assert gp.dtype == dtype and torch.equal(gp, want_p)
                if with_bias:
                    assert torch.equal(gb.to(torch.float32), want[1])
                else:
                    assert gb is None


def test_fp32_logits_backward_equals_fp32_operand_autograd():
    """The card's attention-logit product (`_Fp32Logits`, one cuBLAS
    product with an fp32 output) backpropagates as autograd does through
    the CPU's form, the same product of the operands cast to fp32."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((6, 7, 16)).astype(np.float32)).to(BF16)
    k = torch.from_numpy(rng.standard_normal((6, 9, 16)).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.standard_normal((6, 7, 9)).astype(np.float32))
    q.requires_grad_()
    k.requires_grad_()
    want = torch.autograd.grad(torch.bmm(q.float(), k.float().transpose(1, 2)), [q, k], g)

    class Ctx:
        saved_tensors = (q.detach(), k.detach())
        needs_input_grad = (True, True)

    got = TL._Fp32Logits.backward(Ctx, g)
    assert all(a.dtype == BF16 and torch.equal(a, b) for a, b in zip(got, want))


# JAX's confidence at bf16 is a bf16 value, and the port computes it as XLA
# compiles JAX's softmax, max and product at bf16 (`models.parseq.confidence`:
# bit-equal on 99.95% of 12288 seeded rows, one bf16 step on the rest), so
# where both run the same algorithm the records' confidences are within one
# bf16 step of a value below 1 (equal when measured). JAX's `production()`
# off a TPU quantizes its recognizer's encoder to int8, while the port's
# keeps the float encoder that the preset serves on a TPU: there the
# confidences part by up to 1.8e-2 ("production_pallas" is the same
# algorithm). Before the port rounded as XLA does: 0.005 under `OcrConfig()`
# and 0.03 under the presets.
BF16_CONF_ATOL = {"default": 2.0**-8, "latency": 2.0**-8, "production": 2e-2,
                  "latency_pallas": 2.0**-8, "production_pallas": 2.0**-8}


@pytest.mark.parametrize("preset,n_records", [("latency", 16), ("production", 12),
                                              ("default", 13), ("latency_pallas", 16),
                                              ("production_pallas", 12)])
def test_presets_bf16_records_equal_jax(preset, n_records):
    """`OcrConfig()`, `latency()` and `production()` (all bf16) on the
    golden weights and a 200x300 crop of resume_example, against JAX's
    presets as they run off a TPU and, for the two presets, with JAX's
    Pallas recognizer kernels forced ("_pallas"; at the golden weights'
    width, 32, JAX's gates and the port's run neither kernel): every record
    equal to JAX's (text and bbox), confidences within
    BF16_CONF_ATOL[preset] of JAX's, no pixel of the heatmaps across a
    threshold."""
    page = image("resume_example")[:200, :300].copy()
    r = compare(page, GOLDEN, "bfloat16", preset)
    assert [len(x) for x in r["records"]] == [n_records, n_records]
    assert r["same"] == n_records
    np.testing.assert_allclose([w["confidence"] for w in r["records"][1]],
                               [w["confidence"] for w in r["records"][0]], rtol=0,
                               atol=BF16_CONF_ATOL[preset])
    assert not any(px for _, px in r["flips"].values())
    assert max(r["max_abs"].values()) <= 1 / 64 and r["mean_abs"] <= 1e-4


# ---------------------------------------------------------------------------
# A Linear whose sum goes straight into an fp32 op: XLA adds its bias in fp32
# and never rounds the sum (`tests/probe_torch_bf16.py hlo` lists the sites)
# ---------------------------------------------------------------------------

RESIDUAL_MIN_EQUAL = 0.9995  # equal share at a residual site (fp32 sums' order)
SMALL_BF16 = dict(embed_dim=64, enc_depth=2, enc_heads=4, dec_heads=4, max_label_length=7)
# A width at which JAX's gates run the Pallas recognizer kernels (D % 128 == 0).
PALLAS_D128 = dict(embed_dim=128, enc_depth=2, enc_heads=4, dec_heads=4, max_label_length=7)


def _linear(w, b):
    """The port's Linear on JAX's {w [in, out], b}, at bf16."""
    lin = TL.Linear(*w.shape)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    return TL.set_compute_dtype(lin, BF16)


@pytest.mark.parametrize("rshape", [(4, 26, 384), (1, 26, 384), (1, 1, 384)],
                         ids=["full", "pos_embed", "step"])
def test_linear_residual_bf16_equals_jax(rshape):
    """`Linear(h, residual=r)` at bf16 against JAX's compiled `r +
    linear(h)`: r + (fp32(y) + fp32(b)), never rounded, for a residual of
    the output's shape and ones broadcast over its leading dimensions
    (pos_embed [1, S, D]; a decode step's position query [1, 1, D]). The
    rounded form, the bias add rounded first, gives about half."""
    rng = np.random.default_rng(len(rshape) + rshape[0] + rshape[1])
    w = (rng.standard_normal((384, 384)) * 0.05).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32)
    h = rng.standard_normal((4, 26, 384)).astype(np.float32)
    r = rng.standard_normal(rshape).astype(np.float32) * 3
    want = np.asarray(jax.jit(lambda r, h: r + JL.linear({"w": w, "b": b}, h, jnp.bfloat16))(r, h))
    lin = _linear(w, b)
    with torch.no_grad():
        got = lin(torch.from_numpy(h), residual=torch.from_numpy(r))
        rounded = torch.from_numpy(r) + lin(torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _equal_share(got.numpy(), want) >= RESIDUAL_MIN_EQUAL
    assert _equal_share(rounded.numpy(), want) < 0.6
    with pytest.raises(ValueError, match="do not go together"):
        lin(torch.from_numpy(h), act="gelu", residual=torch.from_numpy(r))


def _seeded_params(jcfg, seed):
    """JAX `init_parseq_params` (numpy) with seeded nonzero biases and a
    head scaled for confident, varied tokens."""
    from tuatara_tpu.models import parseq as jparseq

    params = jax.tree_util.tree_map(
        np.asarray, jparseq.init_parseq_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def biases(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                biases(v)
            elif isinstance(v, list):
                for x in v:
                    biases(x)
            elif k == "b":
                tree[k] = (rng.standard_normal(v.shape) * 0.5).astype(np.float32)

    biases(params)
    params["head"]["w"] = params["head"]["w"] * 40.0  # confident, varied tokens
    return params


@pytest.fixture(scope="module")
def small_bf16():
    """(JAX params with seeded nonzero biases, the port's Parseq on them at
    bf16, JAX config, crops, JAX's bf16 memory of the crops)."""
    from tuatara_tpu.config import ParseqConfig as JaxParseqConfig
    from tuatara_tpu.models import parseq as jparseq
    from tuatara_tpu_torch.config import ParseqConfig
    from tuatara_tpu_torch.models.parseq import Parseq
    from tuatara_tpu_torch.weights import parseq_state_dict

    jcfg = JaxParseqConfig(**SMALL_BF16)
    params = _seeded_params(jcfg, 3)
    m = Parseq(ParseqConfig(**SMALL_BF16))
    m.load_state_dict(parseq_state_dict(params))
    TL.set_compute_dtype(m.eval(), BF16)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    crops = np.random.default_rng(4).random((6, 32, 128, 3), dtype=np.float32)
    memory = np.asarray(jax.jit(lambda p, x: jparseq.parseq_encode(
        p, x, jcfg, compute_dtype=jnp.bfloat16))(params, crops))
    return params, m, jcfg, crops, memory


def _site(name, params, m, jcfg, crops, memory):
    """One residual site of PARSEQ at bf16, fed the same inputs on both
    sides, or a whole decode holding such sites: -> (the port's output,
    JAX's compiled one), numpy fp32."""
    from tuatara_tpu.models import parseq as jparseq

    bf16, H = jnp.bfloat16, jcfg.dec_heads
    rng = np.random.default_rng(sum(map(ord, name)))
    layer, tl, blk, tb = params["dec"][0], m.dec[0], params["enc"][0], m.enc[0]
    D, T = jcfg.embed_dim, jcfg.max_label_length + 1
    t = torch.from_numpy

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    run = jax.jit
    with torch.no_grad():
        if name == "patch_pos_embed":
            x = rng.random((6, jcfg.seq_len, 96), dtype=np.float32)
            want = run(lambda p, x: JL.linear(p["patch_embed"], x, bf16) + p["pos_embed"])(
                params, x)
            return m.patch_embed(t(x), residual=m.pos_embed), want
        if name == "k6_patch_pos_embed":
            # `parseq_encode`'s Pallas branch: the sum cast to fp32 for K6.
            x = rng.random((8, jcfg.seq_len, 96), dtype=np.float32)
            want = run(lambda p, x: (JL.linear(p["patch_embed"], x, bf16)
                                     + p["pos_embed"]).astype(jnp.float32))(params, x)
            return m.patch_embed(t(x), residual=m.pos_embed), want
        if name in ("k7_memory_k", "k7_memory_v"):
            # `parseq_greedy_decode`'s Pallas branch: the memory K/V cast
            # to bf16 for K7; the port's `greedy_decode` before K7.
            key = name[-1]
            want = run(lambda a, x: JL.linear(a[key], x, bf16).astype(bf16))(
                layer["cross_attn"], memory)
            return getattr(tl.cross_attn, key)(t(memory.copy())).to(torch.bfloat16), want
        if name in ("vit_attn", "vit_mlp"):
            # The attention's output projection fed the attention's output
            # (the softmax's fp32 sums run in XLA's order, not torch's), and
            # the MLP fed its input.
            x, h = f32(6, jcfg.seq_len, D), f32(6, jcfg.seq_len, D)
            if name == "vit_attn":
                want = run(lambda p, x, h: x + JL.linear(p["attn"]["o"], h, bf16))(blk, x, h)
                return tb.attn.o(t(h), residual=t(x)), want
            want = run(lambda p, x, h: x + JL.mlp(p["mlp"], h, bf16))(blk, x, h)
            return tb.mlp(t(h), residual=t(x)), want
        if name == "vit_block":
            x = f32(6, jcfg.seq_len, D)
            want = run(lambda p, x: JL.vit_block(p, x, jcfg.enc_heads, jcfg.layer_norm_eps,
                                                 bf16))(blk, x)
            return tb(t(x)), want
        if name in ("decode_self_attn", "decode_cross_attn"):
            q, xq = f32(6, T, D), f32(6, T, D)
            if name == "decode_self_attn":
                xkv, mask = f32(6, T, D), np.array(jparseq.refine_mask(T))[None, None]
                attn, tattn = layer["self_attn"], tl.self_attn
            else:
                xkv, mask, attn, tattn = memory.copy(), None, layer["cross_attn"], tl.cross_attn
            want = run(lambda a, q, xq, xkv: q + JL.mha(a, xq, xkv, H, mask, bf16))(
                attn, q, xq, xkv)
            return tattn(t(xq), t(xkv), None if mask is None else t(mask), residual=t(q)), want
        if name == "dec_ff":
            # `DecoderLayer.ff` after its LayerNorm (norm2): linear2's residual.
            x, h = f32(6, T, D), f32(6, T, D)
            want = run(lambda l, x, h: x + JL.linear(l["linear2"], jax.nn.gelu(JL.linear(
                l["linear1"], h, bf16), approximate=False), bf16))(layer, x, h)
            return tl.linear2(TL.linear_gelu(tl.linear1, t(h)), residual=t(x)), want
        if name == "greedy_decode":
            want = run(lambda p, x: jparseq.parseq_greedy_decode(
                p, x, jcfg, bf16, early_exit=False)[0])(params, memory)
            return m.greedy_decode(t(memory.copy()), early_exit=False), want
        if name == "refine":
            ar = np.asarray(run(lambda p, x: jparseq.parseq_greedy_decode(
                p, x, jcfg, bf16, early_exit=False)[0].astype(jnp.float32))(params, memory))
            want = run(lambda p, x, lg: jparseq.parseq_refine(p, x, lg, jcfg, bf16))(
                params, memory, ar)
            return m.refine(t(memory.copy()), t(ar)), want
        if name == "beam_decode":
            ids, scores = run(lambda p, x: jparseq.parseq_beam_decode(
                p, x, jcfg, 4, compute_dtype=bf16))(params, memory)
            got_ids, got_scores = m.beam_decode(t(memory.copy()), 4)
            return (torch.cat([got_ids.float(), got_scores[:, None]], 1),
                    np.concatenate([np.asarray(ids, np.float32), np.asarray(scores)[:, None]], 1))
    raise ValueError(name)


def _rounded_bias_add(y, b, residual=None):
    """The rounded form at a residual site: the bias add rounded to y's
    dtype, then widened for the residual add."""
    s = (y + b.to(y.dtype)).float()
    return s if residual is None else residual + s


def _site_shares(monkeypatch, site, fixture):
    """(the port's share of JAX's values at `site`, the share with the
    rounded bias add in its place)."""
    shares = []
    for form in (None, _rounded_bias_add):
        with monkeypatch.context() as mp:
            if form is not None:
                mp.setattr(TL, "bias_add_f32", form)
            got, want = _site(site, *fixture)
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        shares.append(_equal_share(got.float().numpy(), want))
    return shares


@pytest.mark.parametrize("site", ["patch_pos_embed", "vit_attn", "vit_mlp", "decode_self_attn",
                                  "decode_cross_attn", "dec_ff", "greedy_decode",
                                  "k6_patch_pos_embed"])
def test_residual_sites_bf16_equal_jax(small_bf16, monkeypatch, site):
    """Each place where XLA leaves a bf16 Linear's bias add unrounded
    (`probe_torch_bf16.py hlo`), fed the same inputs as JAX's compiled
    expression on seeded weights with nonzero biases: `patch_embed +
    pos_embed` (also as the Pallas branch casts it for K6), a ViT block's
    attention and MLP residuals, the decoder's
    self-attention, cross-attention and MLP (`DecoderLayer.ff` after its
    LayerNorm) residuals, and the whole greedy decode, whose steps hold
    the same three with the position query as the first residual and whose
    head stays rounded (8 keys a step: the softmax sums agree): at least
    RESIDUAL_MIN_EQUAL of the values equal.
    The rounded form, the bias add rounded first, parts from JAX on far more."""
    share, rounded = _site_shares(monkeypatch, site, small_bf16)
    assert share >= RESIDUAL_MIN_EQUAL and rounded < share - 0.2, (share, rounded)


@pytest.mark.parametrize("site", ["k7_memory_k", "k7_memory_v"])
def test_kernel_side_rounded_sites_bf16_equal_jax(small_bf16, site):
    """The bias adds that XLA rounds next to K7 (`HLO_UNROUNDED`'s
    forced-Pallas graph): the memory K/V projections cast to bf16 for the
    kernel, fed the same memory as JAX's compiled expression, at least
    MIN_EQUAL of the values equal, bf16 on both sides."""
    got, want = _site(site, *small_bf16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _equal_share(got.float().numpy(), np.asarray(want.astype(jnp.float32))) >= MIN_EQUAL


# A whole ViT block, the refine and the beam decode also run LayerNorms,
# whose fp32 results differ from XLA's by an ulp on many values (XLA's
# rsqrt), and the block's softmax sums its 128 keys in XLA's own order: a
# rare bf16 rounding downstream flips. The shares these hold (the
# rounded bias adds give 0.13 and 0.48 here).
WHOLE_MIN_EQUAL = {"vit_block": 0.997, "refine": 0.999}
BEAM_SCORE_ATOL = 1e-5  # fp32 log-probability sums of the same ids


@pytest.mark.parametrize("fn", ["vit_block", "refine", "beam_decode"])
def test_layers_with_residual_sites_bf16_agree_with_jax(small_bf16, monkeypatch, fn):
    """A whole `VitBlock` and the refine (its rounded head logits) against
    JAX's compiled functions at bf16, at least WHOLE_MIN_EQUAL of the
    values equal; the beam decode's ids equal and its scores within
    BEAM_SCORE_ATOL. With rounded bias adds each parts
    further."""
    if fn != "beam_decode":
        share, rounded = _site_shares(monkeypatch, fn, small_bf16)
        assert share >= WHOLE_MIN_EQUAL[fn] and rounded < share - 0.2, (share, rounded)
        return
    results = []
    for form in (None, _rounded_bias_add):
        with monkeypatch.context() as mp:
            if form is not None:
                mp.setattr(TL, "bias_add_f32", form)
            got, want = _site(fn, *small_bf16)
        results.append((got.numpy(), want))
    (got, want), (rounded, _) = results
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=0, atol=BEAM_SCORE_ATOL)
    assert np.abs(rounded[:, -1] - want[:, -1]).max() > 100 * BEAM_SCORE_ATOL


# JAX's forced-Pallas recognizer (K6 interpreted, K7 by `_simulate_kernel`)
# against the port's at D = 128 on 16 random crops: equal ids. K6's plain
# version sums in other orders than the interpreted kernel, so roundings to
# bf16 in the memory flip and grow through the blocks (23% of its values
# equal, at most 1.9e-3 apart): the confidences part by up to 1.6e-2 (8 bf16
# steps at 0.33). Fed JAX's memory and greedy logits, the port's refine and
# confidence give JAX's confidences within a bf16 step (equal when measured).
PALLAS_CONF_ATOL = 2e-2


def test_forced_pallas_recognize_equals_jax():
    """`Parseq.recognize` under latency()'s lowering at bf16 (K6, K7 and the
    eager sites and confidence between them) against JAX's
    `_recognize_body` with its Pallas kernels forced, at D = 128 (2
    encoder blocks, 4 heads) with seeded nonzero biases: the ids equal,
    the confidences within PALLAS_CONF_ATOL, and within a bf16 step when
    the port's refine is fed JAX's memory and greedy logits."""
    import dataclasses

    from probe_torch_bf16 import PALLAS, jax_recognize
    from tuatara_tpu.config import ParseqConfig as JaxParseqConfig
    from tuatara_tpu.models import parseq as jparseq
    from tuatara_tpu_torch.config import ParseqConfig
    from tuatara_tpu_torch.models.parseq import Parseq, confidence
    from tuatara_tpu_torch.weights import parseq_state_dict

    jcfg = JaxParseqConfig(**PALLAS_D128)
    params = _seeded_params(jcfg, 6)
    m = Parseq(ParseqConfig(**PALLAS_D128, **PALLAS))
    m.load_state_dict(parseq_state_dict(params))
    m.eval().prestack(BF16)
    TL.set_compute_dtype(m, BF16)
    crops = np.random.default_rng(22).random((16, 32, 128, 3), dtype=np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ids, conf = jax_recognize(jparams, crops, jcfg)
    with torch.no_grad():
        got_ids, got_conf = m.recognize(torch.from_numpy(crops))
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    np.testing.assert_allclose(got_conf.numpy(), conf, rtol=0, atol=PALLAS_CONF_ATOL)
    pcfg = dataclasses.replace(jcfg, **PALLAS)
    jmem = np.array(jax.jit(lambda p, x: jparseq.parseq_encode(
        p, x, pcfg, jnp.bfloat16))(jparams, crops))
    jar = np.array(jax.jit(lambda p, x: jparseq.parseq_greedy_decode(
        p, x, pcfg, jnp.bfloat16)[0])(jparams, jmem))
    with torch.no_grad():
        logits = m.refine(torch.from_numpy(jmem), torch.from_numpy(jar))
    fed_ids, fed_conf = confidence(logits.to(BF16))
    np.testing.assert_array_equal(fed_ids.numpy(), ids)
    np.testing.assert_allclose(fed_conf.numpy(), conf, rtol=2.0**-8, atol=0)


def test_fused_kernels_keep_the_rounded_residual_form():
    """The bias adds next to K6 and K7 take the form that XLA's graph of
    the forced-Pallas JAX engine shows (`probe_torch_bf16.py hlo`,
    `HLO_UNROUNDED["serving_pallas"]`), as the eager lowering's do: with the
    bundles built (`latency()`'s lowering at D = 128) and without them,
    `patch_embed + pos_embed` before K6 and the refine's three residuals
    are added unrounded in fp32 (`bias_add_f32`), while K7's memory K/V
    projections and the refine's head keep the rounded bias add. (Until
    the forced-Pallas reference existed, these sites stayed rounded where
    the bundles were built.)"""
    from tuatara_tpu_torch.config import ParseqConfig
    from tuatara_tpu_torch.models.parseq import Parseq

    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.random((8, 128, 96), dtype=np.float32))
    forms = []
    for impl in ("xla", "pallas"):
        torch.manual_seed(0)
        m = Parseq(ParseqConfig(**PALLAS_D128, encoder_impl=impl, decode_impl=impl))
        with torch.no_grad():
            for prm in m.parameters():
                prm.normal_(0, 0.3)
        m.prestack(BF16)
        TL.set_compute_dtype(m.eval(), BF16)
        assert (m.enc_stacked is not None) == (m.dec_stacked is not None) == (impl == "pallas")
        with torch.no_grad():
            got = m.patch_embed(x, residual=m.pos_embed)
            y = F.linear(x.to(BF16), m.patch_embed.weight)
            assert torch.equal(got, BA.bias_add_f32_plain(y, m.patch_embed.bias, m.pos_embed))
            memory = m.encode(x.reshape(8, 32, 128, 3))
            ca = m.dec[0].cross_attn
            mem_k = ca.k(memory)
            assert mem_k.dtype == BF16 and torch.equal(
                mem_k, F.linear(memory.to(BF16), ca.k.weight) + ca.k.bias)
            ar, calls = m.greedy_decode(memory), []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(TL, "bias_add_f32",
                           lambda *a: calls.append(a) or BA.bias_add_f32_plain(*a))
                logits = m.refine(memory, ar)
            assert len(calls) == 3 and all(len(a) == 3 for a in calls)  # three residuals
            head_in = m.dec_norm(torch.zeros(1, 1, m.cfg.embed_dim))
            assert m.head(head_in).dtype == BF16  # the head: rounded
        assert logits.dtype == torch.float32
        forms.append(got)
    assert torch.equal(*forms)


def _residuals(dtype, rng):
    """(y [3, 5, 16], residual) cases: none, y's shape, broadcast [1, 5,
    16] and [16], an expanded view, and a [1, 1, 16] step query."""
    y = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32) * 4).to(dtype)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3)

    return y, [None, r(3, 5, 16), r(1, 5, 16), r(16), r(1, 5, 16).expand(3, 5, 16), r(1, 1, 16)]


@pytest.mark.parametrize("dtype", [BF16, torch.float16], ids=str)
def test_bias_add_f32_plain_is_the_formula(dtype):
    """The fp32-output mode's plain version (what `bias_add_f32` runs on
    the CPU): r + (fp32(y) + fp32(dtype(b))) in fp32, that order, for every
    residual shape it takes, and with no residual; `residual_period`
    gives the values the kernel repeats over y's leading dimensions, and
    refuses a residual that broadcasts over an inner dimension."""
    rng = np.random.default_rng(21)
    y, residuals = _residuals(dtype, rng)
    b32 = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    for r in residuals:
        s = y.float() + b32.to(dtype).float()
        want = s if r is None else r + s
        got = BA.bias_add_f32(y, b32, r)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert torch.equal(BA.bias_add_f32_plain(y, b32, r), want)
        if r is not None:
            flat = BA.residual_period(r, y.shape)
            assert flat.is_contiguous() and y.numel() % flat.numel() == 0
            assert torch.equal(flat.reshape(-1).repeat(y.numel() // flat.numel()),
                               r.expand(y.shape).reshape(-1))
    assert BA.residual_period(residuals[3], y.shape).numel() == 16
    with pytest.raises(ValueError, match="inner dimension"):
        BA.residual_period(torch.zeros(3, 1, 16), y.shape)
    with pytest.raises(ValueError, match="does not broadcast"):
        BA.residual_period(torch.zeros(2, 5, 16), y.shape)


@pytest.mark.parametrize("dtype", [BF16, torch.float16], ids=str)
@pytest.mark.parametrize("bias_fp32", [True, False], ids=["fp32_bias", "dtype_bias"])
def test_bias_add_f32_grads_equal_autograd_of_plain(dtype, bias_fp32):
    """The mode's backward (`bias_add_f32_grads`, which `_BiasAddF32` runs
    on the card) against autograd through the plain version, bit for bit:
    y's gradient (the output's, cast to y's dtype), the bias's (summed over
    the leading dimensions in y's dtype; for an fp32 bias cast as `Linear`
    casts it, cast back) and the residual's (summed to its shape), for
    every residual shape."""
    rng = np.random.default_rng(22)
    y0, residuals = _residuals(dtype, rng)
    for r0 in residuals:
        y = y0.clone().requires_grad_()
        leaf = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
        leaf = (leaf if bias_fp32 else leaf.to(dtype)).requires_grad_()
        b = leaf.to(dtype)
        r = None if r0 is None else r0.detach().clone().requires_grad_()
        out = BA.bias_add_f32_plain(y, b, r)
        g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
        want = list(torch.autograd.grad(out, [y, leaf] + ([r] if r is not None else []), g))
        gy, gb, gr = BA.bias_add_f32_grads(g, dtype, b.shape, b.dtype,
                                           None if r is None else r.shape)
        assert gy.dtype == dtype and torch.equal(gy, want[0])
        assert gb.dtype == dtype and torch.equal(gb.to(leaf.dtype), want[1])
        if r is not None:
            assert torch.equal(gr, want[2])
        else:
            assert gr is None
    assert BA.bias_add_f32_grads(None, dtype, torch.Size([16]), dtype, None) == (None, None, None)


def test_plm_loss_head_bf16_equals_jax(small_bf16):
    """The training graph's own site (`probe_torch_bf16.py hlo` on the PLM
    loss's gradient): the head's logits before the loss's fp32 log-softmax
    (`Parseq.decode(..., fp32_logits=True)`, `PaddedLinear`'s 95 columns
    padded to 96) against JAX's compiled `linear` cast to fp32: at least
    RESIDUAL_MIN_EQUAL of the values equal, where the rounded head parts
    from JAX on far more."""
    params, m, jcfg, _, _ = small_bf16
    x = np.random.default_rng(9).standard_normal((6, 8, jcfg.embed_dim)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: JL.linear(p["head"], x, jnp.bfloat16).astype(
        jnp.float32))(params, x))
    with torch.no_grad():
        got = m.head(torch.from_numpy(x), fp32_logits=True)
        old = m.head(torch.from_numpy(x)).float()
    assert got.dtype == torch.float32
    share = _equal_share(got.numpy(), want)
    assert share >= RESIDUAL_MIN_EQUAL, share
    assert _equal_share(old.numpy(), want) < share - 0.2


@pytest.mark.parametrize("channels_last", [False, True], ids=["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [BF16, torch.float16], ids=str)
def test_bias_add_f32_along_channels_is_the_formula(dtype, channels_last):
    """The fp32-output mode along dim 1 of an NCHW map (CRAFT's training
    sites), contiguous (`div` = H * W) or in channels_last memory (`div` =
    1): fp32(y) + fp32(dtype(b)) per channel, in y's memory format; its
    backward (`bias_add_f32_grads` with the bias as it broadcasts) equals
    autograd's through the plain version; a residual needs channels
    innermost."""
    rng = np.random.default_rng(23)
    y = torch.from_numpy(rng.standard_normal((2, 6, 5, 8)).astype(np.float32) * 4).to(dtype)
    if channels_last:
        y = y.contiguous(memory_format=torch.channels_last)
    assert BA._channel_divisor(y, 1) == (1 if channels_last else 40)
    b32 = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).requires_grad_()
    yg = y.clone().requires_grad_()
    got = BA.bias_add_f32(yg, b32, dim=1)
    want = y.float() + b32.detach().to(dtype).float().reshape(-1, 1, 1)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert got.stride() == y.stride()
    g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    gy, gb = torch.autograd.grad(got, [yg, b32], g)
    b = b32.to(dtype)
    gy2, gb2, gr2 = BA.bias_add_f32_grads(g, dtype, BA.bias_view(b, y, 1).shape, b.dtype, None)
    assert torch.equal(gy, gy2) and torch.equal(gb, gb2.to(torch.float32)) and gr2 is None


def _craft_site(site, x, w, b, k, form):
    """`TrainableCraft`'s conv at `site` at bf16 on x (NCHW), in `form`."""
    with torch.no_grad():
        return tcraft._train_conv(site, x, w, b, BF16, form=form, padding=(k - 1) // 2,
                                  relu=site == "head")


@pytest.mark.parametrize("channels_last", [False, True], ids=["contiguous", "channels_last"])
@pytest.mark.parametrize("site,cin,cout,k", [("head", 32, 32, 3), ("head_out", 16, 2, 1),
                                             ("trunk", 32, 64, 3)])
def test_craft_training_sites_bf16_equal_jax(site, cin, cout, k, channels_last):
    """Each CRAFT training site that follows JAX's graph (the forms
    `TrainableCraft` takes, `probe_torch_bf16.SHIPPED_SITES`: the head's
    conv1-4 with their ReLU, conv5 into the loss), and the fp32
    mode along dim 1 at a trunk conv's shape (JAX's form of the trunk's
    sums into their BatchNorms, which `TrainableCraft` does not take: ROADMAP
    Queue 3 item 19), fed the same input in both NCHW layouts as JAX's
    compiled `conv2d` on seeded weights with nonzero biases: the fp32
    forms (`bias_add_f32` along dim 1) against `conv2d(...)` taken as fp32
    inside the jit, where XLA drops the bias add's rounding as it does into
    a BatchNorm or the loss (`probe_torch_bf16.py hlo`), at least
    RESIDUAL_MIN_EQUAL equal; the head against relu(conv2d) in bf16, two
    roundings, at least MIN_EQUAL; the conv's own bias on the CPU (one
    rounding, oneDNN) parts from JAX on more than 5% (half the head's
    values are ReLU's zeros on both sides)."""
    rng = np.random.default_rng(cin + cout + k)
    w, b = _conv_pair(rng, cin, cout, k)
    x = _bf16(rng.standard_normal((2, 16, 24, cin)).astype(np.float32))
    trunk = site == "trunk"
    site = "vgg" if trunk else site
    form = "fp32" if trunk else SHIPPED_SITES[site]
    fp32 = form == "fp32"
    assert form == ("rounded" if site == "head" else "fp32")

    def jax_site(p, v):
        y = JL.conv2d(p, v, compute_dtype=jnp.bfloat16)
        return y.astype(jnp.float32) if fp32 else jax.nn.relu(y)

    want = np.asarray(jax.jit(jax_site)({"w": w, "b": b}, x).astype(jnp.float32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if not channels_last:
        xt = xt.contiguous()
    wt, bt = torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b)
    got = _craft_site(site, xt, wt, bt, k, form=form)
    assert got.dtype == (torch.float32 if fp32 else BF16)
    share = _equal_share(got.float().permute(0, 2, 3, 1).numpy(), want)
    assert share >= (RESIDUAL_MIN_EQUAL if fp32 else MIN_EQUAL), share
    fused = _craft_site(site, xt, wt, bt, k, form="fused")
    assert _equal_share(fused.float().permute(0, 2, 3, 1).numpy(), want) < 0.95


@pytest.mark.parametrize("other", ["fused", "jax"])
def test_craft_shipped_sites_are_the_models(other, torch_threads):
    """`probe_torch_bf16.SHIPPED_SITES` is what `TrainableCraft` takes at
    bf16 (a tiny model, seeded weights and biases, batch statistics): its
    scores, features and gradients under the probe's
    `site_forms(SHIPPED_SITES)` are bit-equal to the model's own, and under
    `site_forms` of the forms before (`FUSED_SITES`) or of JAX's
    (`JAX_SITES`) they are not, so the probe's wrapper reaches the sites."""
    import probe_torch_bf16 as probe
    from tuatara_tpu_torch.config import CraftConfig

    torch.manual_seed(0)
    model = tcraft.TrainableCraft(CraftConfig(
        stage_channels=(8, 16, 16, 16, 16), fc_channels=16,
        up_channels=((16, 16), (16, 16), (16, 8), (8, 8)), head_channels=(8, 8, 8, 8)))
    for conv in model.convs():
        conv.weight.data.normal_(std=conv.weight[0].numel() ** -0.5)
        conv.bias.data.normal_(std=0.1)
    x = torch.rand(2, 64, 64, 3)

    def run():
        model.zero_grad()
        y, feat = model(x)
        (y.square().sum() + feat.sum()).backward()
        return [y, feat] + [p.grad.clone() for p in model.parameters()]

    own = run()
    with probe.site_forms(probe.SHIPPED_SITES):
        shipped = run()
    with probe.site_forms(probe.FUSED_SITES if other == "fused" else probe.JAX_SITES):
        changed = run()
    assert all(torch.equal(a, b) for a, b in zip(own, shipped))
    assert not torch.equal(own[0], changed[0]) and own[0].std() > 0


def test_hlo_probe_tells_rounded_from_unrounded():
    """The `hlo` probe's reading of XLA's optimised graph, on functions
    whose answer is known: a bf16 Linear into an fp32 residual add (bias
    add unrounded), the same into an argmax and into a bf16 ReLU before
    the cast to fp32 (both rounded), and linear_q's explicit cast of its
    fp32 sum (rounded). Each scope names the call's two frames."""
    from probe_torch_bf16 import bias_add_outcomes, bias_scopes

    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    q = JL.quantize_linear({"w": w, "b": b})
    h = rng.standard_normal((4, 6, 64)).astype(np.float32)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    fns = {"residual": lambda x, h: x + JL.linear({"w": w, "b": b}, h, jnp.bfloat16),
           "argmax": lambda x, h: jnp.argmax(JL.linear({"w": w, "b": b}, h, jnp.bfloat16), -1),
           "relu": lambda x, h: jax.nn.relu(JL.linear({"w": w, "b": b}, h, jnp.bfloat16)
                                            ).astype(jnp.float32) + x,
           "int8": lambda x, h: x + JL.linear(q, h, jnp.bfloat16)}
    verdicts = {}
    for name, fn in fns.items():
        with bias_scopes() as scopes:
            found = bias_add_outcomes(jax.jit(fn).lower(x, h).compile().as_text())
        (scope, outcome), = found.items()
        assert scopes.sites[scope][0][:2] == ("test_torch_bf16.py", "<lambda>")
        verdicts[name] = sorted(outcome)
    assert verdicts["residual"] == ["fp32 add (jit(<lambda>)/add)"]
    assert verdicts["argmax"] == verdicts["relu"] == verdicts["int8"] == ["rounded"]


# Each graph's unrounded bias adds by (file, line) of the call to `linear` /
# `conv2d`: the serving graph of the greedy `_recognize_body`, the same with
# the Pallas recognizer kernels forced (K6 interpreted, K7 a host callback:
# the eager sites around them, `patch_embed + pos_embed` and the refine's
# residuals) and the training losses' gradients.
HLO_UNROUNDED = {
    "serving": [("layers.py", 445), ("layers.py", 558), ("layers.py", 558), ("layers.py", 558),
                ("layers.py", 582), ("parseq.py", 112), ("parseq.py", 245), ("parseq.py", 245),
                ("parseq.py", 442)],
    "serving_pallas": [("layers.py", 558), ("layers.py", 558), ("parseq.py", 112),
                       ("parseq.py", 245)],
    "training": [("craft.py", 307), ("craft.py", 307), ("craft.py", 307), ("craft.py", 500),
                 ("layers.py", 445), ("layers.py", 558), ("layers.py", 558), ("layers.py", 558),
                 ("parseq.py", 112), ("parseq.py", 245), ("parseq.py", 318)],
}


@pytest.mark.parametrize("graph", ["serving", "serving_pallas", "training", "int8"])
def test_hlo_sites_are_the_ports_sites(graph, monkeypatch):
    """On the golden weights, XLA's graph of the greedy `_recognize_body`
    (the eager encoder, the greedy decode, the refine, the confidence), or
    of the PLM and CRAFT losses' gradients, leaves exactly these bias adds
    unrounded, and each of PARSEQ's has its counterpart in the port
    (`probe_torch_bf16.PORT_SITES`): the residual Linears and
    `patch_embed`, in training also the PLM loss's head. CRAFT's training
    sums (its convs' bias adds and the decoder's ya + yb) each read as
    `probe_torch_bf16.JAX_SITES` says, and `TrainableCraft` takes at each
    either JAX's form or the one before (`probe_torch_bf16.SHIPPED_SITES`;
    ROADMAP Queue 3 item 19). The serving heads stay rounded. With the Pallas recognizer
    kernels forced (`latency()`'s lowering at D = 128, random weights),
    the sites around K6 and K7: `patch_embed` and the refine's residuals
    unrounded, K7's memory K/V and the head rounded."""
    import probe_torch_bf16 as probe
    from tuatara_tpu.api import OcrEngine as JaxEngine
    from tuatara_tpu.config import ParseqConfig as JaxParseqConfig

    if graph == "int8":
        _int8_sites_are_the_ports(probe)
        return
    if graph == "serving_pallas":
        keep = [probe.pallas_graph(JaxEngine(probe.jax_config("latency_pallas"),
                                             parseq_config=JaxParseqConfig(**PALLAS_D128),
                                             seed=0))]
    else:
        graphs = probe.hlo_graphs(pallas=False)
        keep = graphs[:1] if graph == "serving" else [g for g in graphs if g[3]]
    monkeypatch.setattr(probe, "hlo_graphs", lambda: keep)
    found = probe.hlo_sites()
    unrounded = [site for site, o in found if any(x.startswith("fp32") for x in o)]
    assert sorted((s[0][0], s[0][2]) for s in unrounded) == HLO_UNROUNDED[graph]
    if graph == "training":
        craft = [(site, o) for site, o in found if site[0][0] == "craft.py"]
        assert len(craft) == len(probe.CRAFT_TRAIN_SITES)
        for site, o in craft:
            key = probe.CRAFT_TRAIN_SITES[(site[0][2], site[1][2])]
            form = "fp32" if any(x.startswith("fp32") for x in o) else "rounded"
            assert probe.JAX_SITES[key] == form, (site, o)
            shipped = probe.SHIPPED_SITES[key]
            assert shipped in (form, probe.FUSED_SITES[key]), (key, shipped)
    for site in unrounded:
        if site[0][0] == "craft.py":
            continue
        where = probe.port_line(site)
        assert any(k in _source_line(where) for k in ("residual", "fp32_logits")), (site, where)
    if graph == "serving":
        heads = [o for site, o in found if site[0][2] in (318, 450)]
        assert len(heads) == 2 and all(o == {"rounded"} for o in heads)
    if graph == "serving_pallas":
        heads = [o for site, o in found if site[0][2] == 318]
        assert len(heads) == 1 and heads[0] == {"rounded"}
        kv = [site for site, o in found if site[0][:3:2] in (("parseq.py", 369),
                                                             ("parseq.py", 370))]
        assert len(kv) == 2 and all(dict(found)[site] == {"rounded"} for site in kv)
        for site in kv:
            assert ".to(torch.bfloat16)" in _source_line(probe.port_line(site)), site


def _int8_sites_are_the_ports(probe):
    """The int8 case of `test_hlo_sites_are_the_ports_sites`: XLA's graph
    of JAX's int8 CRAFT at bf16 as the forced-Pallas `production()` engine
    jits it (golden weights, the probe's crop: the packed head) rounds
    every value the port rounds: each of the 28 dequant outputs, the 4
    decoder sums and the float convs' bias adds (conv1_1, the head's 1x1s)
    reach every consumer (the next abs-max and x * xs, the decoder sum, the
    upsample's dot, the head's convs, the output) after a bf16 rounding, as
    the port's `QConv` (out_dtype bf16), `_double_conv_q`'s bf16 sum, SC
    and `Conv` compute them; every 127 / amax and sw / xs stays a division,
    as the port divides."""
    (_, found, divs, _), = probe.int8_sites(probe.int8_graphs(full=False))
    kinds = [s.split("__")[0] for s in found]
    assert (kinds.count("deq"), kinds.count("sum"), kinds.count("bias")) == (28, 4, 3)
    for scope, consumers in found.items():
        assert consumers and all(c.startswith("rounded") for c in consumers), (scope, consumers)
        if scope.startswith("deq__") and not scope.endswith(("conv1a", "conv1b", "head_conv3")):
            assert any("/reduce_max)" in c for c in consumers), (scope, consumers)
            assert any("/mul)" in c for c in consumers), (scope, consumers)
    assert len(divs) == 56 and all(ops == {"divide"} for ops in divs.values()), divs
    for kind, (module, qualname, text) in probe.INT8_PORT.items():
        assert text in _source_line(probe.source_line(module, qualname, text)), kind
    for module, qualname, text in probe.INT8_BIAS_PORT.values():
        assert text in _source_line(probe.source_line(module, qualname, text))


def _source_line(where):
    """'tuatara_tpu_torch/models/x.py:N fn' -> that line of the source."""
    import os

    path, line = where.split()[0].rsplit(":", 1)
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           path)) as f:
        return f.read().splitlines()[int(line) - 1]
