"""The port's whole default path on the CPU against the JAX package.

`tuatara_tpu_torch.OcrEngine(device="cpu")` must give the same transcripts
and bboxes as `tuatara_tpu.OcrEngine` at compute_dtype float32 on the
reference pages with the committed golden weights; confidences agree to
1e-4. The JAX engine's results are its record,
tests/fixtures/torch_engine_golden.json (written by
`tests/gen_torch_engine.py`; the JAX package does not change, so the
record equals a live run); one live JAX case shows a stale record.
`tests/test_torch_engine_batch.py` holds batches, gray pages and the
engine's contract, `tests/test_torch_engine_configs.py` and
`tests/test_torch_engine_user_configs.py` other configurations (files of
their own so that the test workers share them).
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
PAGES = ["funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text"]
LIVE_PAGE = "rotated_text"


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engine(record):
    return tuatara_tpu_torch.OcrEngine(OcrConfig(**record["config"]), weights_dir=GOLDEN,
                                       device="cpu")


@pytest.mark.parametrize("name", PAGES)
def test_engine_matches_jax_fp32(engine, record, name):
    assert_same_words(engine.run(image(name)), record["default"][name])


def test_engine_record_is_live_jax(record):
    """The JAX engine, run live on one page, equals its record."""
    assert record["config"] == {"max_label_length": 7, "compute_dtype": "float32"}
    jax_engine = JaxEngine(JaxOcrConfig(**record["config"]), weights_dir=GOLDEN)
    assert_same_words(words(jax_engine.run(image(LIVE_PAGE))), record["default"][LIVE_PAGE],
                      atol=1e-6)
