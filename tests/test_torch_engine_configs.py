"""The port's engine on the CPU against the JAX package under the
configurations a user may set beyond the default (golden weights, fp32):
`text_threshold=0.3` (the detection branch of kernels K4 and K5) on the
reference pages, and magnification, channel order, dilation math, canvas
size and bucket, and box budget on one page or a two-page batch.
Transcripts and bboxes equal, confidences to 1e-4, as in
tests/test_torch_engine.py. (A file of its own so that the test workers
share the engine tests.)
"""

import os

import numpy as np
import pytest

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.utils.image import load_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")
# Three of the five reference pages, to keep the suite's time: a form, a
# résumé and a small rotated crop (tests/test_torch_modules.py runs this
# branch's boxes on the table page's heatmaps too).
PAGES = ["funsd_0001129658", "resume_example", "rotated_text"]


def _image(name):
    return load_image(os.path.join(ROOT, "images", f"{name}.png"))


def _assert_same_words(got, want):
    assert len(want) > 0
    assert [w["bbox"] for w in got] == [w["bbox"] for w in want]
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-4)


def _pair(**overrides):
    cfg = dict(max_label_length=7, compute_dtype="float32", **overrides)
    return (JaxEngine(JaxOcrConfig(**cfg), weights_dir=GOLDEN),
            tuatara_tpu_torch.OcrEngine(OcrConfig(**cfg), weights_dir=GOLDEN, device="cpu"))


@pytest.fixture(scope="module")
def low_threshold_engines():
    return _pair(text_threshold=0.3)


@pytest.mark.parametrize("name", PAGES)
def test_engine_low_text_threshold_matches_jax(low_threshold_engines, name):
    """text_threshold 0.3 < low_text 0.4: the port takes K4 and K5 (their
    plain versions here) and equals JAX page by page."""
    jax_engine, engine = low_threshold_engines
    img = _image(name)
    _assert_same_words(engine.run(img), jax_engine.run(img))


# User configurations of ROADMAP Queue 3, item 2. The max_boxes cases run a
# two-page batch, so there are more live boxes than the budget holds.
USER_CONFIGS = {
    "mag_ratio_1.5": dict(mag_ratio=1.5),
    "channel_mode_cpp": dict(channel_mode="cpp"),
    "channel_mode_rgb": dict(channel_mode="rgb"),
    "niter_upstream": dict(niter_mode="upstream"),
    "canvas_512": dict(canvas_size=512),
    "canvas_bucket_0": dict(canvas_bucket=0),
    "max_boxes_16": dict(max_boxes=16),
    "max_boxes_16_slab_8": dict(max_boxes=16, rec_slab_multiple=8),
}


@pytest.mark.parametrize("name", sorted(USER_CONFIGS))
def test_engine_configs_match_jax(name):
    overrides = USER_CONFIGS[name]
    jax_engine, engine = _pair(**overrides)
    if "max_boxes" in overrides:
        img = _image("funsd_0001129658")
        pages = np.stack([img, img[:, ::-1].copy()])
        want, got = jax_engine.run_pages(pages), engine.run_pages(pages)
        assert sum(map(len, want)) > overrides["max_boxes"]
        for g, w in zip(got, want):
            _assert_same_words(g, w)
    else:
        img = _image("resume_example")
        _assert_same_words(engine.run(img), jax_engine.run(img))
