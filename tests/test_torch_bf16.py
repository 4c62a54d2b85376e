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
* `latency()` and `production()` on a dense crop: every record equal to
  JAX's (Pallas recognizer kernels in interpret mode).
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

from probe_torch_bf16 import compare
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
            e = torch.erfc(f * -float(torch.tensor(2 ** -0.5, dtype=dtype))).to(dtype).float()
            want = (0.5 * f * e).to(dtype)
        y, pre = TL.add_bias(p, b, act, keep_pre=True, dim=dim)
        assert y.dtype == pre.dtype == dtype and y.stride() == p.stride()
        assert torch.equal(pre, v) and torch.equal(y, want)
        assert torch.equal(BA.bias_act(p, None, act, dim=dim),
                           BA.bias_act_plain(p, None, act, dim=dim))
    with pytest.raises(ValueError, match="act must be one of"):
        BA.bias_act(p, b[:p.shape[-1]], "tanh", dim=-1)
    with pytest.raises(ValueError, match="expected a contiguous tensor"):
        BA._channel_divisor(torch.zeros(4, 6, dtype=dtype).t(), -1)


@pytest.mark.parametrize("dtype", [BF16, torch.float16], ids=str)
@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("keep_pre", [False, True])
def test_bias_act_grads_equal_autograd_of_plain(dtype, act, keep_pre):
    """The kernel's backward (`bias_act_grads`, which `_BiasAct` runs on the
    card) against autograd through the plain version, bit for bit: the
    gradients of the product and of an fp32 bias (cast to the dtype as
    `add_bias` casts it), in every layout, with and without a bias, and
    with the pre-activation output's gradient present or absent."""
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
                assert gp.dtype == dtype and torch.equal(gp, want[0])
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


@pytest.mark.parametrize("preset,n_records", [("latency", 16), ("production", 12)])
def test_presets_bf16_records_equal_jax(preset, n_records):
    """`latency()` and `production()` (both bf16) on the golden weights and
    a 200x300 crop of resume_example: every record equal to JAX's (text
    and bbox), no pixel of the heatmaps across a threshold."""
    page = image("resume_example")[:200, :300].copy()
    r = compare(page, GOLDEN, "bfloat16", preset)
    assert [len(x) for x in r["records"]] == [n_records, n_records]
    assert r["same"] == n_records
    assert not any(px for _, px in r["flips"].values())
    assert max(r["max_abs"].values()) <= 1 / 64 and r["mean_abs"] <= 1e-4
