"""The port's engine on the CPU against the JAX package under the
configurations a user may set beyond the default (golden weights, fp32):
magnification, channel order, dilation math, canvas size and bucket, and
box budget, on one page or a two-page batch (ROADMAP Queue 3, item 2).
Transcripts and bboxes equal, confidences to 1e-4, against the JAX
engine's record (tests/fixtures/torch_engine_golden.json, written by
`tests/gen_torch_engine.py`), with one live JAX case that shows a stale
record. Moved out of `tests/test_torch_engine_configs.py` so that the
test workers share the engine tests.
"""

import json
import os

import numpy as np
import pytest

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig

from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads, words  # noqa: F401

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_engine_golden.json")
USER_CONFIGS = ["canvas_512", "canvas_bucket_0", "channel_mode_cpp", "channel_mode_rgb",
                "mag_ratio_1.5", "max_boxes_16", "max_boxes_16_slab_8", "niter_upstream"]
LIVE_CONFIG = "niter_upstream"


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def _config(record, name):
    return {**record["config"], **record["user_configs"][name]}


@pytest.mark.parametrize("name", USER_CONFIGS)
def test_engine_configs_match_jax(record, name):
    overrides = record["user_configs"][name]
    engine = tuatara_tpu_torch.OcrEngine(OcrConfig(**_config(record, name)),
                                         weights_dir=GOLDEN, device="cpu")
    want = record["configs"][name]
    if "max_boxes" in overrides:
        img = image("funsd_0001129658")
        got = engine.run_pages(np.stack([img, img[:, ::-1].copy()]))
        assert sum(map(len, want)) > overrides["max_boxes"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_same_words(g, w)
    else:
        assert_same_words(engine.run(image("resume_example")), want)


def test_user_config_record_is_live_jax(record):
    """The JAX engine at one user configuration, run live, equals its
    record."""
    assert sorted(record["user_configs"]) == USER_CONFIGS
    jax_engine = JaxEngine(JaxOcrConfig(**_config(record, LIVE_CONFIG)), weights_dir=GOLDEN)
    assert_same_words(words(jax_engine.run(image("resume_example"))),
                      record["configs"][LIVE_CONFIG], atol=1e-6)
