"""The port's whole default path on the CPU against the JAX package.

`tuatara_tpu_torch.OcrEngine(device="cpu")` must give the same transcripts
and bboxes as `tuatara_tpu.OcrEngine` at compute_dtype float32 on the
reference pages with the committed golden weights; confidences agree to
1e-4 (`tests/test_torch_engine_configs.py` holds the same at
`text_threshold=0.3` and under other user configurations). One page also
runs at full width on the trained production weights, at the default
configuration and at `text_threshold=0.3`, against the JAX float32 records
that `chip_smoke.py` uses on the card.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import torch

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
import tuatara_tpu_torch
from tuatara_tpu_torch.api import resolve_device
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.utils.image import load_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_weights")
PRODUCTION = os.path.join(ROOT, "evals", "production_weights")
REFERENCE = os.path.join(ROOT, "tests", "fixtures", "torch_reference_production.json")
PAGES = ["funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text"]


@pytest.fixture(scope="module")
def engines():
    cfg = dict(max_label_length=7, compute_dtype="float32")
    return (JaxEngine(JaxOcrConfig(**cfg), weights_dir=GOLDEN),
            tuatara_tpu_torch.OcrEngine(OcrConfig(**cfg), weights_dir=GOLDEN, device="cpu"))


def _image(name):
    return load_image(os.path.join(ROOT, "images", f"{name}.png"))


@pytest.mark.parametrize("name", PAGES)
def test_engine_matches_jax_fp32(engines, name):
    jax_engine, engine = engines
    img = _image(name)
    want = jax_engine.run(img)
    got = engine.run(img)
    assert len(want) > 0
    assert [w["bbox"] for w in got] == [w["bbox"] for w in want]
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-4)


def test_run_pages_batch_and_gray(engines):
    """A two-page batch equals the pages run alone; a gray page [H, W] equals
    its RGB tripling."""
    _, engine = engines
    img = _image("funsd_0001129658")
    single = engine.run(img)
    batch = engine.run_pages(np.stack([img, img[:, ::-1].copy()]))
    assert batch[0] == single
    assert batch[1] == engine.run(img[:, ::-1].copy())
    assert engine.run(img[:, :, 0]) == single


def test_slab_sort_is_a_pure_permutation(engines):
    """Aspect-sorted recognition slabs give the raster-order results."""
    _, engine = engines
    img = _image("resume_example")
    plain = tuatara_tpu_torch.OcrEngine(
        OcrConfig(max_label_length=7, compute_dtype="float32", rec_sort_by_width=False),
        weights_dir=GOLDEN, device="cpu")
    assert plain.run(img) == engine.run(img)


def test_production_page_matches_jax_reference():
    """Full-width trained weights, one page: the port on the CPU matches the
    JAX float32 record (the card's parity check uses the same record and
    share: >= 95% of the words with equal bbox and text)."""
    sys.path.insert(0, ROOT)
    from chip_smoke import MIN_WORD_SHARE, word_share

    with open(REFERENCE) as f:
        ref = json.load(f)["pages"]["resume_example"]["words"]
    engine = tuatara_tpu_torch.OcrEngine(OcrConfig(compute_dtype="float32"),
                                         weights_dir=PRODUCTION, device="cpu")
    got = engine.run(_image("resume_example"))
    assert word_share(ref, got) >= MIN_WORD_SHARE


def test_production_page_low_text_threshold_matches_jax_reference():
    """The same at text_threshold 0.3 (path A) against its JAX float32
    record, which `chip_smoke.py` holds the card to."""
    sys.path.insert(0, ROOT)
    from chip_smoke import FIXTURE_LOW, LOW_THRESHOLD, MIN_WORD_SHARE, word_share

    with open(FIXTURE_LOW) as f:
        ref = json.load(f)["pages"]["resume_example"]["words"]
    engine = tuatara_tpu_torch.OcrEngine(
        OcrConfig(compute_dtype="float32", text_threshold=LOW_THRESHOLD),
        weights_dir=PRODUCTION, device="cpu")
    got = engine.run(_image("resume_example"))
    assert len(got) > 15  # the default path's record has 15 words on this page
    assert word_share(ref, got) >= MIN_WORD_SHARE


def test_construction_checks():
    with pytest.raises(ValueError, match="geometry mismatch"):
        tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, rec_width=64),
                                    weights_dir=GOLDEN, device="cpu")
    with pytest.raises(ValueError, match="tokenizer/recognizer mismatch"):
        tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, charset="abc"),
                                    weights_dir=GOLDEN, device="cpu")
    with pytest.raises(NotImplementedError):
        tuatara_tpu_torch.OcrEngine(OcrConfig(box_mode="rotated"), device="cpu")
    with pytest.raises(ValueError, match="weights_dir is required"):
        tuatara_tpu_torch.OcrEngine(OcrConfig(), device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7), weights_dir=GOLDEN,
                                    device="cpu").run(np.zeros((64, 64, 3), np.float32))


def test_default_device_is_the_gpu():
    """device=None means the card: it raises where there is none."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7), weights_dir=GOLDEN)


def test_image_to_data_contract():
    img = _image("rotated_text")
    out = tuatara_tpu_torch.image_to_data(img, GOLDEN, config=OcrConfig(max_label_length=7),
                                          device="cpu")
    assert out and set(out[0]) == {"text", "bbox", "confidence"}
    with pytest.raises(ValueError, match="3 dimensions"):
        tuatara_tpu_torch.image_to_data(img[:, :, 0], GOLDEN, device="cpu")
