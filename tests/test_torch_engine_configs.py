"""The port's engine on the CPU against the JAX package at
`text_threshold=0.3` (the detection branch of kernels K4 and K5), golden
weights, fp32, on three reference pages: transcripts and bboxes equal,
confidences to 1e-4, as in tests/test_torch_engine.py, against the JAX
engine's record (tests/fixtures/torch_engine_golden.json, written by
`tests/gen_torch_engine.py`), with one live JAX case that shows a stale
record. `tests/test_torch_engine_user_configs.py` holds the other user
configurations (a file of its own so that the test workers share the
engine tests).
"""

import json
import os

import pytest

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig

from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads, words  # noqa: F401

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_engine_golden.json")
# Three of the five reference pages, to keep the suite's time: a form, a
# résumé and a small rotated crop (tests/test_torch_modules.py runs this
# branch's boxes on the table page's heatmaps too).
PAGES = ["funsd_0001129658", "resume_example", "rotated_text"]
LIVE_PAGE = "rotated_text"


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def _config(record):
    return {**record["config"], **record["low_threshold_config"]}


@pytest.fixture(scope="module")
def low_threshold_engine(record):
    return tuatara_tpu_torch.OcrEngine(OcrConfig(**_config(record)), weights_dir=GOLDEN,
                                       device="cpu")


@pytest.mark.parametrize("name", PAGES)
def test_engine_low_text_threshold_matches_jax(low_threshold_engine, record, name):
    """text_threshold 0.3 < low_text 0.4: the port takes K4 and K5 (their
    plain versions here) and equals JAX page by page."""
    assert_same_words(low_threshold_engine.run(image(name)), record["low_threshold"][name])


def test_low_text_threshold_record_is_live_jax(record):
    """The JAX engine at text_threshold 0.3, run live on one page, equals
    its record."""
    assert record["low_threshold_config"] == {"text_threshold": 0.3}
    jax_engine = JaxEngine(JaxOcrConfig(**_config(record)), weights_dir=GOLDEN)
    assert_same_words(words(jax_engine.run(image(LIVE_PAGE))),
                      record["low_threshold"][LIVE_PAGE], atol=1e-6)
