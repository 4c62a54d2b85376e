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
* the int8 CRAFT forward on one input is within 1e-5 (fp32) and 0.1
  (bf16, where the port's float layers already differ) of JAX's compiled
  forward;
* `OcrEngine(OcrConfig.production(compute_dtype="float32"))` against the
  JAX engine's `production(..., encoder_impl="pallas",
  decode_impl="pallas")` on the golden pages (its record,
  tests/fixtures/torch_int8_golden.json): int8's rounding turns
  one-ulp differences of the float layers before the first int8 conv
  (the canvas resample, conv1_1) into threshold flips, so the pages are
  held to a share of JAX's words (ROADMAP Queue 3 records the divergence
  and its input), not to equality;
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

from chip_smoke import word_share
from torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")
PAGES = ["funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text"]
MIN_PAGE_SHARE = 0.75   # per page, of the JAX engine's words (same bbox and text)
MIN_SHARE = 0.9         # over the five pages
CRAFT_MAX_ABS = {"float32": 1e-5, "bfloat16": 0.1}
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
    record: at least 75% of its words on each page and 90% over the five
    with the same bbox and text; confidences of the matched words to
    1e-4."""
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
    and NAR decodes are refused, not served otherwise; tiled detection and
    rotated boxes are taken as overrides."""
    got = dataclasses.asdict(OcrConfig.production())
    want = dataclasses.asdict(JaxOcrConfig.production(encoder_impl="pallas",
                                                      decode_impl="pallas"))
    assert got == want
    assert OcrConfig.production(rec_width=64).rec_width == 64
    for cfg in (OcrConfig(quantized_serving=True, max_label_length=7),
                OcrConfig.production(encoder_impl="xla", max_label_length=7),
                OcrConfig.production(decode_mode="beam", max_label_length=7),
                OcrConfig.production(decode_mode="nar", max_label_length=7)):
        with pytest.raises(NotImplementedError):
            tuatara_tpu_torch.OcrEngine(cfg, weights_dir=folded[0], device="cpu")
    for over in ({"tiled_detection": True}, {"box_mode": "rotated", "rotated_fit": "pca"}):
        engine = tuatara_tpu_torch.OcrEngine(OcrConfig.production(max_label_length=7, **over),
                                             weights_dir=folded[0], device="cpu")
        assert engine.craft.quantized
