"""The port's modules against the JAX package, module by module, on the CPU.

Inputs are made with numpy from a seed and go through both. Tolerances:
canvas prep 1e-5 abs (antialiased downscale included); CRAFT fp32
heatmaps 1e-4 abs and PARSEQ fp32 logits 1e-4 abs with equal ids, on the
committed golden weights; tokenizer, boxes and crop windows exact; crops
1e-5 abs (the bilinear taps sum in another order).
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tuatara_tpu.api import _canvas_prep as jax_canvas_prep
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.models.craft import craft_forward, fold_batchnorms
from tuatara_tpu.models.parseq import parseq_encode, parseq_forward, parseq_greedy_decode
from tuatara_tpu.ops import boxes as jax_boxes
from tuatara_tpu.ops import warp as jax_warp
from tuatara_tpu.tokenizer import Tokenizer as JaxTokenizer
from tuatara_tpu.utils import weights as jax_weights
from tuatara_tpu_torch.api import content_mask
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.models.craft import Craft
from tuatara_tpu_torch.models.parseq import Parseq
from tuatara_tpu_torch.ops import boxes as t_boxes
from tuatara_tpu_torch.ops import warp as t_warp
from tuatara_tpu_torch.ops.resize import canvas_prep
from tuatara_tpu_torch.tokenizer import EXTENDED_CHARSET, Tokenizer
from tuatara_tpu_torch.utils import weights as t_weights
from tuatara_tpu_torch.utils.image import load_image
from tuatara_tpu_torch.weights import craft_state_dict, parseq_state_dict

from torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")


@pytest.fixture(scope="module")
def golden():
    cc, pc, _ = t_weights.load_configs(GOLDEN)
    ct, pt = t_weights.load_weights_dir(GOLDEN)
    jcc, jpc, _ = jax_weights.load_configs(GOLDEN)
    jct, jpt = jax_weights.load_weights_dir(GOLDEN)
    craft = Craft(cc).eval()
    craft.load_state_dict(craft_state_dict(ct, cc.bn_eps))
    parseq = Parseq(pc).eval()
    parseq.load_state_dict(parseq_state_dict(pt))
    return {"craft": craft, "parseq": parseq, "jcc": jcc, "jpc": jpc,
            "jct": fold_batchnorms(jct, jcc.bn_eps), "jpt": jpt}


# ---- image reading --------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "images", "*.png"))),
                         ids=os.path.basename)
def test_png_reader_matches_pil(path):
    from PIL import Image

    got = load_image(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(got, want)
    im = Image.open(path)
    if im.mode == "L":
        np.testing.assert_array_equal(load_image(path, keep_gray=True), np.asarray(im))


# ---- canvas prep ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1300, 500, 3), (700, 1100, 3), (600, 400, 3),
                                   (1100, 900, 1)], ids=str)
@pytest.mark.parametrize("mode", ["python", "rgb"])
def test_canvas_prep_matches_jax(shape, mode):
    """Resize (antialiased when it shrinks), pad, /255 and the BGR flip."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jax_canvas_prep(jnp.asarray(img), JaxOcrConfig(channel_mode=mode)))
    got = canvas_prep(torch.from_numpy(img), OcrConfig(channel_mode=mode)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# ---- models ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 64, 96, 3), (2, 96, 64, 1)], ids=str)
def test_craft_matches_jax_fp32(golden, shape):
    rng = np.random.default_rng(1)
    x = rng.random(shape, np.float32)
    ref, ref_feat = craft_forward(golden["jct"], jnp.asarray(x), golden["jcc"],
                                  compute_dtype=jnp.float32)
    with torch.no_grad():
        got, feat = golden["craft"](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat), rtol=0, atol=1e-4)


def test_parseq_matches_jax_fp32(golden):
    rng = np.random.default_rng(2)
    crops = rng.random((6, 32, 128, 3), np.float32)
    jp, jpc = golden["jpt"], golden["jpc"]
    m = golden["parseq"]
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(crops))
        ar = m.greedy_decode(mem)
        logits = m(torch.from_numpy(crops))
    ref_mem = parseq_encode(jp, jnp.asarray(crops), jpc, compute_dtype=jnp.float32)
    ref_ar, _ = parseq_greedy_decode(jp, ref_mem, jpc, compute_dtype=jnp.float32)
    ref = parseq_forward(jp, jnp.asarray(crops), jpc, compute_dtype=jnp.float32)
    np.testing.assert_allclose(mem.numpy(), np.asarray(ref_mem), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ar.numpy(), np.asarray(ref_ar), rtol=0, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(logits.numpy().argmax(-1), np.asarray(ref).argmax(-1))


def test_weights_fold_matches_jax(golden):
    """BN folding at load time: the folded conv weights equal the JAX
    package's fold (HWIO -> OIHW), to fp32 rounding."""
    sd = golden["craft"].state_dict()
    for name, blk in golden["jct"]["vgg"].items():
        w = np.asarray(blk["conv"]["w"]).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(sd[f"vgg.{name}.conv.weight"].numpy(), w,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(sd[f"vgg.{name}.conv.bias"].numpy(),
                                   np.asarray(blk["conv"]["b"]), rtol=1e-6, atol=1e-6)
    psd = golden["parseq"].state_dict()
    np.testing.assert_array_equal(psd["head.weight"].numpy(),
                                  np.asarray(golden["jpt"]["head"]["w"]).T)


# ---- tokenizer ------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"reference_charset": True},
                                {"charset": EXTENDED_CHARSET}], ids=str)
def test_tokenizer_matches_jax(kw):
    rng = np.random.default_rng(4)
    t, j = Tokenizer(**kw), JaxTokenizer(**kw)
    assert t.itos == j.itos and t.stoi == j.stoi
    ids = rng.integers(0, t.vocab_size - 2, (32, 26))
    for mode in ("truncate", "reference"):
        assert t.decode_ids(ids, mode=mode) == j.decode_ids(ids, mode=mode)
    assert t.decode_ids(ids, raw=True) == j.decode_ids(ids, raw=True)
    for word in ("Hello", "a&b'c", "x" * 40):
        a, b = t.encode(word, 25, on_oov="skip"), j.encode(word, 25, on_oov="skip")
        np.testing.assert_array_equal(a[0], b[0])
        assert int(a[1]) == int(b[1])


# ---- boxes and crops ------------------------------------------------------

def _heatmaps(seed, h=96, w=128):
    """Gaussian text blobs joined by link bumps, plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    text = np.zeros((h, w), np.float32)
    link = np.zeros((h, w), np.float32)
    for _ in range(14):
        cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
        sy, sx = rng.uniform(1.5, 3.5), rng.uniform(2, 8)
        text += np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        link += 0.6 * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx - sx) / 3) ** 2))
    text += 0.05 * rng.random((h, w), np.float32)
    return np.clip(text, 0, 1).astype(np.float32), np.clip(link, 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_boxes", [4, 256])
def test_extract_boxes_matches_jax(seed, max_boxes):
    """Boxes, validity and counts equal the JAX XLA path exactly."""
    text, link = _heatmaps(seed)
    mask = np.ones(text.shape, bool)
    mask[:, 120:] = False  # content narrower than the canvas
    cfg_j = JaxOcrConfig(max_boxes=max_boxes, use_pallas="off")
    ref = jax_boxes.extract_boxes(jnp.array(text), jnp.array(link), jnp.array(mask), cfg_j)
    assert int(ref["cc_iters"]) < 64
    got = t_boxes.extract_boxes(torch.from_numpy(text), torch.from_numpy(link),
                                torch.from_numpy(mask), OcrConfig(max_boxes=max_boxes))
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert int(got["count"]) == int(ref["count"]) and valid.sum() > 0
    assert int(got["num_components"]) == int(ref["num_components"])
    np.testing.assert_array_equal(got["boxes"].numpy()[valid], np.asarray(ref["boxes"])[valid])
    ratio = 0.8
    np.testing.assert_array_equal(
        t_boxes.tesseract_bbox(t_boxes.scale_boxes(got["boxes"], ratio, OcrConfig())).numpy()[valid],
        np.asarray(jax_boxes.tesseract_bbox(jax_boxes.scale_boxes(
            ref["boxes"], ratio, cfg_j)))[valid])


@pytest.mark.parametrize("name", ["funsd_0001129658", "table_english"])
def test_extract_boxes_low_text_threshold_matches_jax(golden, name):
    """The branch text_threshold < low_text (K4 labels, K5 stats with the
    peak filter) on the golden CRAFT's fp32 heatmaps of a reference page:
    boxes (of the valid slots), valid, count and num_components equal the
    JAX XLA path's."""
    img = load_image(os.path.join(ROOT, "images", f"{name}.png"))
    cfg_j = JaxOcrConfig(text_threshold=0.3, use_pallas="off")
    canvas = jax_canvas_prep(jnp.asarray(img), cfg_j)
    scores, _ = craft_forward(golden["jct"], canvas[None], golden["jcc"],
                              compute_dtype=jnp.float32)
    text, link = np.asarray(scores[0, :, :, 0]), np.asarray(scores[0, :, :, 1])
    cfg = OcrConfig(text_threshold=0.3)
    mask = content_mask(img.shape[0], img.shape[1], cfg, "cpu")
    assert mask.shape == text.shape
    ref = jax_boxes.extract_boxes(jnp.array(text), jnp.array(link),
                                  jnp.array(mask.numpy()), cfg_j)
    assert int(ref["cc_iters"]) < 64
    got = t_boxes.extract_boxes(torch.from_numpy(text), torch.from_numpy(link), mask, cfg)
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    # Invalid slots too: the recognition slab crops them as padding rows.
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(ref["boxes"]))
    assert int(got["count"]) == int(ref["count"])
    assert int(got["num_components"]) == int(ref["num_components"])


def test_crops_match_jax():
    """Crop windows exact; crops to 1e-5 of the JAX sampler."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, 90, 160, 3), dtype=np.uint8)
    boxes = np.concatenate([rng.uniform(-5, 150, (24, 2)), rng.uniform(0, 170, (24, 2))],
                           axis=1).astype(np.float32)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    boxes[:, 1] = np.clip(boxes[:, 1], -3, 95)
    boxes[:, 3] = np.clip(boxes[:, 3], boxes[:, 1], 100)
    ref_r = np.asarray(jax_warp.crop_rects(jnp.asarray(boxes), 90, 160))
    got_r = t_warp.crop_rects(torch.from_numpy(boxes), 90, 160).numpy()
    np.testing.assert_array_equal(got_r, ref_r)
    page = rng.integers(0, 2, 24).astype(np.int32)
    ref = np.asarray(jax_warp.extract_crops_batched(
        jnp.asarray(images), jnp.asarray(page), jnp.asarray(ref_r), 32, 128))
    got = t_warp.extract_crops_batched(torch.from_numpy(images), torch.from_numpy(page),
                                       torch.from_numpy(got_r), 32, 128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
