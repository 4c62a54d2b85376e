"""int8 serving of the port (`OcrConfig.production()`) on the CPU against the
JAX package, at the golden weights' widths.

Both packages fold CRAFT's BatchNorms, JAX with an rsqrt that is not
correctly rounded (+-1 ulp from the port's 1/sqrt on ~14% of channels), so
the layer and engine tests feed both the same tree, folded by the JAX
package (a weights directory under the test's tmp path). Then:

* `quantize_conv` (int8 weights and scales) and `Craft.quantize` (JAX's
  `quantize_craft_trunk`: conv1_1 and the head's 1x1s float, decoder conv1
  split into conv1a/conv1b) are bit-equal to JAX's, layer by layer;
* `quantize_act` and the static-scale path are bit-equal;
* `QConv` equals JAX's compiled `conv2d_q` bit for bit at fp32 and bf16
  outputs, at 3x3, 1x1 and fc6's dilation 6: the int32 sums are exact
  (the plain version, im2col rows times the weights in float64, and the
  card's route, im2col rows and one `torch._int_mm`, here on the CPU),
  and the dequant is one fused
  multiply-add, as XLA compiles JAX's `y * (sw / xs) + b`;
* the int8 CRAFT forward on one input is equal to JAX's compiled forward
  at fp32 and at bf16 (conv1_1 summed in XLA's order, kernel SC's plain
  version);
* at bf16, on a reference page, every quantized layer's dynamic scale and
  int8 input, computed from JAX's int8 inputs of the layers before it,
  equal JAX's compiled graph's, and so do the scores; SC's plain version
  equals XLA's bf16 conv1_1 on full-width pages; the port's BatchNorm fold
  (`weights.xla_rsqrt`: x86's rsqrtps table and XLA's two Newton steps)
  equals JAX's compiled fold bit for bit;
* at fp32 the int8 CRAFT forward of a reference page is JAX's bit for bit,
  stage by stage: the canvas (XLA compiles `x / 255.0` as a product with
  the rounded reciprocal), every quantized layer's int8 input and output,
  the decoder's fused `ya + acc * s`, the 2x upsamples (rounded as XLA's
  dots round `jax.image.resize`, whose rule is held here on its own over
  many shapes), the head's float 1x1 convs (XLA's split sums, held per
  shape) and the scores;
* `OcrEngine(OcrConfig.production(compute_dtype="float32"))` against the
  JAX engine's `production(..., encoder_impl="pallas",
  decode_impl="pallas")` on the golden pages (its record,
  tests/fixtures/torch_int8_golden.json): every word of every page
  (ROADMAP Queue 3 item 6 records how the divergence was closed);
* `calibrate` gives JAX's scales (its saved calibration.npz, equal to 1e-5
  relative: an abs-max may move by an ulp for the same reason) and a
  `calibration.npz` saved by either package loads in the other; an engine
  loads the file beside its
  weights; nothing calibrated writes no file; a path that lands on no
  quantized layer raises.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tuatara_tpu.config import CraftConfig as JaxCraftConfig
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.models import craft as jcraft
from tuatara_tpu.models import layers as JL
from tuatara_tpu.utils import weights as JW
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.kernels.int8 import int8_conv, int8_conv_im2col, int8_conv_plain
from tuatara_tpu_torch.models import craft as tcraft
from tuatara_tpu_torch.models import layers as TL
from tuatara_tpu_torch.models.craft import Craft
from tuatara_tpu_torch.utils import weights as W
from tuatara_tpu_torch.utils.image import load_image
from tuatara_tpu_torch.weights import craft_state_dict

from chip_smoke import STEM_EDGE_SHAPES, stem_edge_case, stem_edge_tensors, word_share
from torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")
PAGES = ["funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text"]
MIN_PAGE_SHARE = 1.0    # per page, of the JAX engine's words (same bbox and text)
MIN_SHARE = 1.0         # over the five pages
CRAFT_MAX_ABS = {"float32": 0.0, "bfloat16": 0.0}
CALIB_RTOL = 1e-5
# The JAX engine's results on those pages and its calibration, recorded by
# tests/gen_torch_int8.py (a JAX engine compiles once a page geometry).
RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_int8_golden.json")
JAX_CALIBRATION = os.path.join(ROOT, "tests", "fixtures", "torch_int8_golden_calibration.npz")


def _image(name):
    return load_image(os.path.join(ROOT, "images", f"{name}.png"))


@pytest.fixture(scope="module")
def folded(tmp_path_factory):
    """(weights dir with the golden CRAFT tree BN-folded by the JAX package,
    that folded tree, JAX's quantized tree, the CRAFT config)."""
    ccfg = W.load_configs(GOLDEN)[0]
    tree, _ = JW.load_weights_dir(GOLDEN)
    jfold = jcraft.fold_batchnorms(jax.tree_util.tree_map(jnp.asarray, tree), eps=ccfg.bn_eps)
    out = str(tmp_path_factory.mktemp("golden_folded"))
    JW.save_params(os.path.join(out, JW.CRAFT_FILE), jax.tree_util.tree_map(np.asarray, jfold))
    for f in (JW.PARSEQ_FILE, JW.CONFIG_FILE):
        shutil.copy(os.path.join(GOLDEN, f), out)
    return out, jfold, jcraft.quantize_craft_trunk(jfold), ccfg


def _port_craft(folded_tree, ccfg, dtype=torch.float32):
    m = Craft(ccfg)
    m.load_state_dict(craft_state_dict(jax.tree_util.tree_map(np.asarray, folded_tree)))
    m.eval().quantize()
    return TL.set_compute_dtype(m, dtype)


def _jax_node(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


LAYERS = ["vgg/conv1_2/conv", "vgg/conv2_1/conv", "vgg/conv2_2/conv", "vgg/conv3_1/conv",
          "vgg/conv3_2/conv", "vgg/conv3_3/conv", "vgg/conv4_1/conv", "vgg/conv4_2/conv",
          "vgg/conv4_3/conv", "vgg/conv5_1/conv", "vgg/conv5_2/conv", "fc/fc6", "fc/fc7",
          *[f"up/upconv{i}/{c}" for i in range(1, 5) for c in ("conv1a", "conv1b", "conv2")],
          "head/conv1", "head/conv2", "head/conv3"]


def test_quantized_layers_are_jax_layers(folded):
    """Craft.quantize leaves exactly JAX's quantized layers int8 (conv1_1
    and the head's 1x1 convs float), is idempotent, and keeps K8 off."""
    _, jfold, _, ccfg = folded
    m = _port_craft(jfold, ccfg)
    assert [n for n, _ in m.qconvs()] == LAYERS
    first = dict(m.qconvs())
    m.quantize()
    assert dict(m.qconvs()) == first
    assert isinstance(m.vgg["conv1_1"]["conv"], TL.Conv)
    assert isinstance(m.head["conv4"], TL.Conv) and isinstance(m.head["conv5"], TL.Conv)
    old = tcraft.FUSED_STAGE1
    tcraft.FUSED_STAGE1 = "on"
    try:
        assert not m._fused_stage1_ok(torch.zeros(1, 32, 32, 3))
    finally:
        tcraft.FUSED_STAGE1 = old


@pytest.mark.parametrize("path", LAYERS)
def test_quantize_conv_matches_jax(folded, path):
    """int8 weights and per-channel scales bit-equal to JAX's, the decoder's
    conv1 split at the trunk side's width."""
    _, jfold, jq, ccfg = folded
    q = dict(_port_craft(jfold, ccfg).qconvs())[path]
    node = _jax_node(jq, path)
    np.testing.assert_array_equal(q.wq.numpy(), np.asarray(node["wq"]))
    np.testing.assert_array_equal(q.sw.numpy(), np.asarray(node["sw"]))
    if "b" in node:
        np.testing.assert_array_equal(q.bias.numpy(), np.asarray(node["b"]))
    else:
        assert q.bias is None


def _act(seed, shape=(2, 16, 9, 11)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x.reshape(-1)[:7] = [0.5, -0.5, 1.5, 2.5, 0.0, -2.5, 3.5]  # ties and zero
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_matches_jax(dtype):
    """Dynamic (abs-max over the whole tensor, batch included) and static
    (a calibrated sx) quantization bit-equal to JAX's; round half to even."""
    x = torch.from_numpy(_act(0)).to(getattr(torch, dtype))  # NCHW
    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(getattr(jnp, dtype))
    xq, xs = TL.quantize_act(x)
    jxq, jxs = jax.jit(JL.quantize_act)(xj)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert float(xs) == float(jxs)
    sx = TL.static_scale(3.7, 1.1)
    q = TL.QConv.from_weight(torch.ones(4, 16, 1, 1), None)
    q.sx = torch.tensor(sx)
    sq, ss = q.quantize_input(x)
    jsq, jss = jax.jit(lambda v: JL.quantize_act_q({"wq": 0, "sx": jnp.float32(sx)}, v))(xj)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq))
    assert float(ss) == float(jss)


@pytest.mark.parametrize("path,dtype", [(p, d) for p in ("vgg/conv3_1/conv", "fc/fc6", "fc/fc7",
                                                         "up/upconv2/conv1b", "head/conv2")
                                        for d in ("float32", "bfloat16")])
def test_conv2d_q_matches_jax(folded, path, dtype):
    """QConv == JAX's compiled conv2d_q on the same input, bit for bit (3x3,
    fc6's dilation 6, 1x1 with and without bias); the int32 sums of the
    card's route (im2col + torch._int_mm) equal the plain version's."""
    _, jfold, jq, ccfg = folded
    q = dict(_port_craft(jfold, ccfg, getattr(torch, dtype)).qconvs())[path]
    node = _jax_node(jq, path)
    x = torch.from_numpy(_act(1, (2, q.cin, 13, 10)))
    dil = 6 if path == "fc/fc6" else 1
    want = jax.jit(lambda v: JL.conv2d_q(node, v, dilation=dil, out_dtype=getattr(jnp, dtype)))(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    reset_launches()
    got = q(x)
    assert LAUNCHES["int8_conv"] == 0  # the plain version on the CPU
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    xq, _ = q.quantize_input(x)
    k = q.wq.shape[0]
    want = int8_conv_plain(xq, q.wmat, k, dil).numpy()
    np.testing.assert_array_equal(int8_conv_im2col(xq, q.wmat, k, dil).numpy(), want)
    np.testing.assert_array_equal(int8_conv(xq, q.wmat, k, dil).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_craft_int8_forward_matches_jax(folded, dtype):
    """quantize + the int8 forward against JAX's quantize_craft_trunk +
    compiled craft_forward on one seeded input: at bf16 conv1a runs before
    the decoder's upsample, at fp32 after it, in JAX's order."""
    _, jfold, jq, ccfg = folded
    m = _port_craft(jfold, ccfg, getattr(torch, dtype))
    x = np.random.default_rng(2).random((1, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        scores, _ = m(torch.from_numpy(x))
    jcfg = JaxCraftConfig(**dataclasses.asdict(ccfg))
    want = jax.jit(lambda v: jcraft.craft_forward(jq, v, jcfg,
                                                  compute_dtype=getattr(jnp, dtype))[0])(x)
    err = np.abs(scores.numpy() - np.asarray(want)).max()
    assert err <= CRAFT_MAX_ABS[dtype], f"max abs err {err}"


@pytest.fixture(scope="module")
def engine(folded):
    return tuatara_tpu_torch.OcrEngine(
        OcrConfig.production(compute_dtype="float32", max_label_length=7),
        weights_dir=folded[0], device="cpu")


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def test_production_engine_matches_jax_fp32(engine, record):
    """The int8 engine on the golden pages at fp32 against the JAX engine's
    record: every word of each page with the same bbox and text;
    confidences of the matched words to 1e-4."""
    assert record["config"] == {"preset": "production", "compute_dtype": "float32",
                                "max_label_length": 7, "encoder_impl": "pallas",
                                "decode_impl": "pallas"}
    hit = total = 0
    for name in PAGES:
        want, got = record["pages"][name], engine.run(_image(name))
        share = word_share(want, got)
        assert len(want) > 0 and share >= MIN_PAGE_SHARE, f"{name}: {share}"
        hit, total = hit + share * len(want), total + len(want)
        conf = {(w["text"], tuple(w["bbox"])): w["confidence"] for w in want}
        for w in got:
            key = (w["text"], tuple(w["bbox"]))
            if key in conf:
                assert abs(w["confidence"] - conf[key]) <= 1e-4
    assert hit / total >= MIN_SHARE, f"{hit / total}"


def test_calibration_matches_jax_and_files_cross_load(engine, record, folded, tmp_path):
    """calibrate on the record's two pages: JAX's scales; the JAX engine's
    calibration.npz loads into the port, the port's into JAX's quantized
    tree, each as saved; an engine loads the file beside its weights."""
    pages = [_image(n)[None] for n in record["calibration"]["pages"]]
    assert engine.calibrate(pages) == record["calibration"]["layers"] == len(LAYERS)
    ppath = str(tmp_path / "port.npz")
    assert engine.save_calibration(ppath) == ppath
    jz, pz = dict(np.load(JAX_CALIBRATION)), dict(np.load(ppath))
    assert sorted(pz) == sorted(jz) == sorted(f"craft/{p}/sx" for p in LAYERS)
    for k in jz:
        np.testing.assert_allclose(pz[k], jz[k], rtol=CALIB_RTOL, atol=0)
    W.apply_static_scales(engine.craft, W.load_calibration(JAX_CALIBRATION)[0])
    for name, q in engine.craft.qconvs():
        assert float(q.sx) == float(jz[f"craft/{name}/sx"])
    jtree = jax.tree_util.tree_map(lambda v: v, folded[2])
    assert JW.apply_static_scales(jtree, JW.load_calibration(ppath)[0]) == len(LAYERS)
    for name in LAYERS:
        assert float(_jax_node(jtree, name)["sx"]) == float(pz[f"craft/{name}/sx"])
    wdir = tmp_path / "weights"
    shutil.copytree(folded[0], wdir)
    shutil.copy(JAX_CALIBRATION, wdir / W.CALIB_FILE)
    loaded = tuatara_tpu_torch.OcrEngine(OcrConfig.production(max_label_length=7),
                                         weights_dir=str(wdir), device="cpu")
    for name, q in loaded.craft.qconvs():
        assert float(q.sx) == float(jz[f"craft/{name}/sx"])


def test_calibration_files_refuse_and_skip(folded, tmp_path):
    """Nothing calibrated: no file (save_calibration raises); a path that
    lands on no quantized layer raises KeyError; calibrate needs
    quantized_serving."""
    wdir = folded[0]
    engine = tuatara_tpu_torch.OcrEngine(OcrConfig.production(max_label_length=7),
                                         weights_dir=wdir, device="cpu")
    path = str(tmp_path / W.CALIB_FILE)
    assert W.save_calibration(path, engine.craft) == 0 and not os.path.exists(path)
    with pytest.raises(ValueError):
        engine.save_calibration(path)
    assert not os.path.exists(path)
    for bad in ("vgg/conv1_1/conv/sx", "vgg/conv9_9/conv/sx", "head/conv1/scale"):
        with pytest.raises(KeyError):
            W.apply_static_scales(engine.craft, {bad: np.float32(1.0)})
    plain = tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7), weights_dir=wdir,
                                        device="cpu")
    with pytest.raises(ValueError):
        plain.calibrate(_image("rotated_text"))


def test_production_preset_and_refusals(folded):
    """production() has JAX's fields with the Pallas lowerings; the int8
    encoder (quantized_serving without encoder_impl='pallas') and the beam
    and NAR decodes construct and serve; an unknown encoder_impl is
    refused; tiled detection and rotated boxes are taken as overrides."""
    got = dataclasses.asdict(OcrConfig.production())
    want = dataclasses.asdict(JaxOcrConfig.production(encoder_impl="pallas",
                                                      decode_impl="pallas"))
    assert got == want
    assert OcrConfig.production(rec_width=64).rec_width == 64
    page = _image("rotated_text")
    for cfg in (OcrConfig(quantized_serving=True, max_label_length=7),
                OcrConfig.production(encoder_impl="xla", max_label_length=7),
                OcrConfig.production(decode_mode="beam", max_label_length=7),
                OcrConfig.production(decode_mode="nar", max_label_length=7)):
        engine = tuatara_tpu_torch.OcrEngine(cfg, weights_dir=folded[0], device="cpu")
        assert engine.craft.quantized
        assert engine.parseq.quantized == (cfg.encoder_impl != "pallas")
        got = engine.run(page)
        assert got and all(w["text"] and 0.0 <= w["confidence"] <= 1.0 for w in got)
    with pytest.raises(NotImplementedError):
        tuatara_tpu_torch.OcrEngine(OcrConfig.production(encoder_impl="mosaic"),
                                    weights_dir=folded[0], device="cpu")
    for over in ({"tiled_detection": True}, {"box_mode": "rotated", "rotated_fit": "pca"}):
        engine = tuatara_tpu_torch.OcrEngine(OcrConfig.production(max_label_length=7, **over),
                                             weights_dir=folded[0], device="cpu")
        assert engine.craft.quantized


def _jax_taps(jq, canvas, jcfg):
    """JAX's compiled int8 CRAFT forward at fp32 with its intermediate
    values as outputs (the quantized layers' inputs, int8 inputs, scales,
    int32 sums and outputs, the upsamples, the float convs), in call order.
    The JAX package is not changed: its functions are wrapped while the
    forward is traced."""
    taps, names = [], []
    saved = JL.conv2d, JL.quantize_act_q, JL.conv2d_q_pre, jcraft._upsample_to

    def conv(*a, **k):
        y = saved[0](*a, **k)
        taps.append(("conv", y))
        return y

    def quantize(qp, x):
        xq, xs = saved[1](qp, x)
        taps.extend([("in", x), ("xq", xq), ("xs", xs)])
        return xq, xs

    def pre(qp, xq, xs, stride=1, padding="SAME", dilation=1, out_dtype=jnp.float32):
        acc = jax.lax.conv_general_dilated(xq, qp["wq"], (stride, stride), padding,
                                           rhs_dilation=(dilation, dilation),
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        taps.append(("acc", acc))
        y = saved[2](qp, xq, xs, stride, padding, dilation, out_dtype)
        taps.append(("out", y))
        return y

    def up(x, h, w):
        y = saved[3](x, h, w)
        taps.append(("up", y))
        return y

    def fwd(x):
        taps.clear()
        scores = jcraft.craft_forward(jq, x, jcfg, compute_dtype=jnp.float32)[0]
        names[:] = [t[0] for t in taps]
        return scores, [t[1] for t in taps]

    JL.conv2d, JL.quantize_act_q, JL.conv2d_q_pre, jcraft._upsample_to = conv, quantize, pre, up
    try:
        scores, values = jax.jit(fwd)(canvas)
    finally:
        JL.conv2d, JL.quantize_act_q, JL.conv2d_q_pre, jcraft._upsample_to = saved
    return scores, list(zip(names, values))


def _port_taps(m, canvas):
    """The port's int8 CRAFT forward with the same intermediate values, NHWC."""
    taps = []
    saved = TL.Conv.forward, TL.QConv.sums, tcraft.upsample_to, tcraft._conv1x1_xla

    def conv(self, x):
        y = saved[0](self, x)
        taps.append(("conv", y.permute(0, 2, 3, 1)))
        return y

    def sums(self, x):
        taps.append(("in", x.permute(0, 2, 3, 1)))
        xq, xs = self.quantize_input(x)
        acc = int8_conv(xq, self.wmat, self.wq.shape[0], self.dilation)
        taps.extend([("xq", xq), ("xs", xs), ("acc", acc),
                     ("out", TL.dequant(acc, self.sw / xs, self.bias, self.out_dtype))])
        return acc, self.sw / xs

    def up(x, h, w):
        y = saved[2](x, h, w)
        taps.append(("up", y.permute(0, 2, 3, 1)))
        return y

    def conv1x1(c, x):
        y = saved[3](c, x)
        taps.append(("conv", y.permute(0, 2, 3, 1)))
        return y

    TL.Conv.forward, TL.QConv.sums, tcraft.upsample_to, tcraft._conv1x1_xla = conv, sums, up, conv1x1
    try:
        with torch.no_grad():
            scores, _ = m(canvas)
    finally:
        TL.Conv.forward, TL.QConv.sums, tcraft.upsample_to, tcraft._conv1x1_xla = saved
    return scores, taps


def test_int8_craft_fp32_equals_jax_stage_by_stage(folded):
    """funsd_0001129658 at production(compute_dtype="float32"): the canvas
    equals JAX's compiled one, and every stage of int8 CRAFT after it
    equals JAX's bit for bit, to the scores. JAX's head runs width-packed
    (`_pack4`): its taps there are unpacked before the comparison."""
    _, jfold, jq, ccfg = folded
    img = _image("funsd_0001129658")
    cfg = OcrConfig.production(compute_dtype="float32", max_label_length=7)
    jcfg = JaxOcrConfig.production(compute_dtype="float32", max_label_length=7)
    from tuatara_tpu.api import _canvas_prep as jax_canvas_prep
    from tuatara_tpu_torch.ops.resize import canvas_prep

    want_canvas = np.asarray(jax.jit(lambda im: jax_canvas_prep(im, jcfg))(img))
    canvas = canvas_prep(torch.from_numpy(img), cfg)
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)
    jscores, jtaps = _jax_taps(jq, jnp.asarray(want_canvas)[None],
                               JaxCraftConfig(**dataclasses.asdict(ccfg)))
    scores, ptaps = _port_taps(_port_craft(jfold, ccfg), canvas[None])
    assert [n for n, _ in ptaps] == [n for n, _ in jtaps]
    assert sum(n == "up" for n, _ in ptaps) == 3
    for i, ((name, want), (_, got)) in enumerate(zip(jtaps, ptaps)):
        want = np.asarray(want)
        if want.ndim == 4 and want.shape != tuple(got.shape):
            want = np.asarray(jcraft._unpack4(jnp.asarray(want)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"stage {i} ({name})")
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))


UPSAMPLE_SHAPES = [(1, 64, 48, 16), (1, 128, 96, 16), (1, 256, 192, 8), (2, 32, 24, 64),
                   (1, 24, 32, 8), (1, 48, 48, 4), (1, 40, 20, 8), (1, 34, 26, 16),
                   (1, 90, 58, 4), (1, 16, 62, 8), (1, 8, 128, 2), (3, 8, 6, 32)]


@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=str)
def test_upsample2x_rounds_as_xla(shape):
    """`models.craft.upsample_to`'s fp32 2x path equals XLA's compiled
    `jax.image.resize` bilinear bit for bit: both axis orders (the longer
    axis first) and both roundings of the second contraction (fused where
    its output width is at most 12 short of a multiple of 64)."""
    b, h, w, c = shape
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32) * 3
    want = jax.jit(lambda v: jax.image.resize(v, (b, 2 * h, 2 * w, c), "bilinear"))(x)
    got = tcraft.upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), 2 * h, 2 * w)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("cin,cout", sorted(tcraft._HEAD_1X1_LANES))
def test_head_conv1x1_rounds_as_xla(cin, cout):
    """The head's float 1x1 convs, for each shape of `_HEAD_1X1_LANES`,
    equal XLA's compiled width-packed conv (JAX's serving head) bit for
    bit."""
    rng = np.random.default_rng(cin * 10 + cout)
    x = np.maximum(rng.standard_normal((2, 24, 40, cin)).astype(np.float32), 0)
    w = (rng.standard_normal((cout, cin)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)

    def packed(v):
        kp = {"w": jcraft._pack4_1x1_w(jnp.asarray(w.T[None, None])),
              "b": jnp.tile(jnp.asarray(b), 4)}
        return jcraft._unpack4(JL.conv2d(kp, jcraft._pack4(v), compute_dtype=jnp.float32))

    want = jax.jit(packed)(x)
    conv = TL.Conv(cin, cout, 1)
    conv.weight.data = torch.from_numpy(w[:, :, None, None].copy())
    conv.bias.data = torch.from_numpy(b)
    with torch.no_grad():
        got = tcraft._conv1x1_xla(conv, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def _jax_int8_decisions(jq, canvas, jcfg):
    """JAX's compiled int8 CRAFT at bf16 -> (scores, the untapped graph's
    scores, [(xq, xs)] of each quantized layer in the order their inputs
    are quantized). Only the int8 inputs and the fp32 scales leave the jit
    beside the scores: a bf16 intermediate returned from it would be
    materialized, and could keep a rounding that the whole graph drops."""
    saved, taps = JL.quantize_act_q, []

    def quantize(qp, x):
        xq, xs = saved(qp, x)
        taps.append((xq, xs))
        return xq, xs

    def fwd(x):
        taps.clear()
        return jcraft.craft_forward(jq, x, jcfg, compute_dtype=jnp.bfloat16)[0], list(taps)

    plain, _ = jax.jit(fwd)(canvas)
    JL.quantize_act_q = quantize
    try:
        scores, taps_out = jax.jit(lambda x: fwd(x))(canvas)  # a new trace
    finally:
        JL.quantize_act_q = saved
    return np.asarray(scores), np.asarray(plain), [(np.asarray(a), float(b)) for a, b in taps_out]


def test_int8_craft_bf16_equals_jax_stage_by_stage(folded):
    """funsd_0001129658 at production()'s bf16 on JAX's folded tree: each
    quantized layer's dynamic scale xs and int8 input xq, computed by the
    port from JAX's int8 inputs and scales of the layers before it (its
    own dequant, ReLU, pools, upsamples, the decoder's sum, the abs-max and
    the rounding), equal JAX's compiled graph's bit for bit, conv1_2's from
    the float conv1_1 (kernel SC's plain version) on the canvas; the
    scores after the head's float 1x1 convs equal JAX's too (tolerance
    0). JAX's values are read as int8 and fp32 scalars only, and its
    scores with those outputs equal its scores without."""
    _, jfold, jq, ccfg = folded
    from tuatara_tpu.api import _canvas_prep as jax_canvas_prep

    img = _image("funsd_0001129658")
    canvas = np.array(jax.jit(lambda im: jax_canvas_prep(im, JaxOcrConfig.production()))(img))
    jscores, plain, decisions = _jax_int8_decisions(
        jq, jnp.asarray(canvas)[None], JaxCraftConfig(**dataclasses.asdict(ccfg)))
    np.testing.assert_array_equal(jscores, plain)
    m = _port_craft(jfold, ccfg, torch.bfloat16)
    names = [n for n, _ in m.qconvs()]
    assert len(decisions) == len(names) == 28
    seen = []
    orig = TL.QConv.quantize_input

    def quantize_input(self, x):
        xq, xs = orig(self, x)
        jxq, jxs = decisions[len(seen)]
        if jxq.shape != tuple(xq.shape):  # JAX's width-packed head
            jxq = np.asarray(jcraft._unpack4(jnp.asarray(jxq)))
        seen.append((float(xs) == jxs, int((xq.numpy() != jxq).sum())))
        return torch.from_numpy(jxq), torch.tensor(jxs, dtype=torch.float32)

    TL.QConv.quantize_input = quantize_input
    try:
        with torch.no_grad():
            scores, _ = m(torch.from_numpy(canvas)[None])
    finally:
        TL.QConv.quantize_input = orig
    bad = [(n, ok, nd) for n, (ok, nd) in zip(names, seen) if not ok or nd]
    assert not bad, f"(layer, xs equal, int8 values that differ): {bad}"
    np.testing.assert_array_equal(scores.numpy(), jscores)


@pytest.mark.parametrize("page", ["funsd_0001129658", "resume_example"])
def test_stem_conv_equals_xla_bf16_conv(page):
    """Kernel SC's plain version (int8 CRAFT's conv1_1 at bf16, the route on
    the CPU) on a page's production() canvas (a gray page broadcast to
    three channels, an RGB page) with the production weights folded by
    JAX: bit-equal to JAX's compiled conv2d + ReLU, the product summed in
    XLA's order; a oneDNN bf16 convolution of the same operands is not."""
    from tuatara_tpu.api import _canvas_prep as jax_canvas_prep
    from tuatara_tpu_torch.kernels.stem import stem_conv

    tree, _ = JW.load_weights_dir(os.path.join(ROOT, "evals", "production_weights"))
    p = jcraft.fold_batchnorms(jax.tree_util.tree_map(jnp.asarray, tree))["vgg"]["conv1_1"]["conv"]
    canvas = np.array(jax.jit(lambda im: jax_canvas_prep(im, JaxOcrConfig.production()))(
        _image(page)))[None]
    want = np.asarray(jax.jit(lambda x: jax.nn.relu(JL.conv2d(
        p, jnp.broadcast_to(x, x.shape[:-1] + (3,)), compute_dtype=jnp.bfloat16)))(canvas)
        .astype(jnp.float32))
    x = torch.from_numpy(canvas).permute(0, 3, 1, 2)
    x = x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x
    w = torch.from_numpy(np.asarray(p["w"])).permute(3, 2, 0, 1).to(torch.bfloat16)
    b = torch.from_numpy(np.asarray(p["b"]))
    got = stem_conv(x, w, b)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)
    other = torch.relu(torch.nn.functional.conv2d(x.to(torch.bfloat16), w, b.to(torch.bfloat16),
                                                  padding=1))
    assert (other.float().permute(0, 2, 3, 1).numpy() != want).sum() > 0


def test_stem_packed_weights_follow_the_served_weights(folded):
    """The weights and bias SC reads, packed once by `Craft.quantize` from
    the fp32 folded tree, equal the packing of the bf16 weights the engine
    serves after `set_compute_dtype` (the cast rounds as the packing
    does); a state dict loaded into the quantized model packs them again."""
    from tuatara_tpu_torch.kernels.stem import pack_stem_weights

    _, jfold, _, ccfg = folded
    m = _port_craft(jfold, ccfg, torch.bfloat16)
    c11 = m.vgg["conv1_1"]["conv"]
    assert c11.weight.dtype == torch.bfloat16
    for got, want in zip((m.conv1_1_packed_w, m.conv1_1_packed_b),
                         pack_stem_weights(c11.weight, c11.bias)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    sd = m.state_dict()
    sd["vgg.conv1_1.conv.bias"] = sd["vgg.conv1_1.conv.bias"] + 1
    m.load_state_dict(sd)
    assert torch.equal(m.conv1_1_packed_b, pack_stem_weights(c11.weight, c11.bias)[1])


def stem_edge_id(shape):
    return "{}x{}c{}-{}".format(*shape)


@pytest.mark.parametrize("shape", STEM_EDGE_SHAPES, ids=stem_edge_id)
def test_stem_conv_edge_shapes_equal_xla_bf16_conv(shape):
    """SC's plain version on seeded canvases whose H and W fall on and just
    off the kernel's 8 x 32 tile (1, 2, tile - 1, tile + 1, odd widths
    near 600), gray and RGB, cout 8, 64 and 256: bit-equal to JAX's
    compiled bf16 conv2d + ReLU (`chip_smoke.STEM_EDGE_SHAPES`, the inputs
    phase 4g gives the kernel on the card)."""
    from tuatara_tpu_torch.kernels.stem import stem_conv

    canvas, weight, bias = stem_edge_case(*shape)
    p = {"w": jnp.asarray(weight.transpose(2, 3, 1, 0)), "b": jnp.asarray(bias)}
    want = np.asarray(jax.jit(lambda x: jax.nn.relu(JL.conv2d(
        p, jnp.broadcast_to(x, x.shape[:-1] + (3,)), compute_dtype=jnp.bfloat16)))(canvas)
        .astype(jnp.float32))
    got = stem_conv(*stem_edge_tensors(canvas, weight, bias, "cpu"))
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


def stem_tile_model(x, weight, bias, tile=(8, 32)):
    """A model of csrc/stem.cu's tiles: each 8 x 32 output tile computed
    from its own slab of the canvas (the tile and a one-pixel halo, zero
    outside the image, rounded to bf16 once), each output's 27 taps in
    (kh, kw, ci) order, the ReLU taken on the fp32 sum of the rounded
    product and the bias before its rounding; outputs past H or W dropped.
    x [B, C, H, W] (read through its strides, a gray canvas once), weight
    [O, C, 3, 3], bias [O] -> bf16 [B, O, H, W]."""
    b, c, h, w = x.shape
    th, tw = tile
    xb = x.to(torch.bfloat16).float()
    wb = weight.to(torch.bfloat16).float()
    bb = bias.to(torch.bfloat16).float()
    out = torch.zeros((b, wb.shape[0], h, w), dtype=torch.bfloat16)
    for ty in range(0, h, th):
        for tx in range(0, w, tw):
            slab = torch.zeros((b, c, th + 2, tw + 2))
            ys, xs = slice(max(ty - 1, 0), min(ty + th + 1, h)), slice(max(tx - 1, 0),
                                                                      min(tx + tw + 1, w))
            slab[:, :, ys.start - ty + 1:ys.stop - ty + 1, xs.start - tx + 1:xs.stop - tx + 1] = \
                xb[:, :, ys, xs]
            acc = torch.zeros((b, wb.shape[0], th, tw))
            for kh in range(3):
                for kw in range(3):
                    for ci in range(c):
                        acc += slab[:, ci:ci + 1, kh:kh + th, kw:kw + tw] * \
                            wb[:, ci, kh, kw].view(1, -1, 1, 1)
            s = acc.to(torch.bfloat16).float() + bb.view(1, -1, 1, 1)
            v = torch.clamp_min(s, 0).to(torch.bfloat16)
            hh, ww = min(th, h - ty), min(tw, w - tx)
            out[:, :, ty:ty + hh, tx:tx + ww] = v[:, :, :hh, :ww]
    return out


@pytest.mark.parametrize("shape", STEM_EDGE_SHAPES, ids=stem_edge_id)
def test_stem_tile_model_equals_plain(shape):
    """The kernel's tiling and epilogue, modelled in PyTorch, equal SC's
    plain version bit for bit at the edge shapes."""
    from tuatara_tpu_torch.kernels.stem import stem_conv_plain

    x, w, b = stem_edge_tensors(*stem_edge_case(*shape), "cpu")
    want = stem_conv_plain(x, w, b)
    assert torch.equal(stem_tile_model(x, w, b), want)


def test_xla_rsqrt_equals_jax():
    """`weights.xla_rsqrt` (the rsqrtps table and two Newton steps) equals
    XLA's compiled `jax.lax.rsqrt` bit for bit on 4e5 seeded values over
    26 decades, where a correctly rounded 1/sqrt does not."""
    from tuatara_tpu_torch.weights import xla_rsqrt

    rng = np.random.default_rng(0)
    v = np.concatenate([rng.random(200000, np.float32) * 10,
                        np.exp(rng.uniform(-30, 30, 200000)).astype(np.float32)])
    want = np.asarray(jax.jit(jax.lax.rsqrt)(v))
    np.testing.assert_array_equal(xla_rsqrt(v), want)
    assert np.mean((1 / np.sqrt(v.astype(np.float64))).astype(np.float32) != want) > 0.05


@pytest.mark.parametrize("weights", ["golden_weights", "production_weights"])
def test_fold_batchnorms_equals_jax_bit_for_bit(weights):
    """The port's BatchNorm fold as int8 serving takes it (`xla=True`)
    equals JAX's `fold_batchnorms` compiled on the CPU bit for bit, every
    folded weight and bias of the golden and the production weights."""
    from tuatara_tpu.utils.weights import flatten_tree
    from tuatara_tpu_torch.weights import fold_batchnorms

    wdir = GOLDEN if weights == "golden_weights" else os.path.join(ROOT, "evals", weights)
    tree, _ = JW.load_weights_dir(wdir)
    want = flatten_tree(jcraft.fold_batchnorms(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = flatten_tree(fold_batchnorms(tree, W.load_configs(wdir)[0].bn_eps, xla=True))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
