"""The port's engine on the CPU: page batches, gray pages, the
aspect-sorted slab, the full-width trained weights against the JAX
float32 records that `chip_smoke.py` uses on the card (at the default
configuration and at `text_threshold=0.3`), and the engine's contract
(construction checks, the default device, `image_to_data`). Moved out of
`tests/test_torch_engine.py` so that the test workers share the engine
tests.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import tuatara_tpu_torch
from tuatara_tpu_torch.api import resolve_device
from tuatara_tpu_torch.config import OcrConfig

from torch_common import GOLDEN, ROOT, image, torch_threads  # noqa: F401

PRODUCTION = os.path.join(ROOT, "evals", "production_weights")
REFERENCE = os.path.join(ROOT, "tests", "fixtures", "torch_reference_production.json")


@pytest.fixture(scope="module")
def engine():
    return tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, compute_dtype="float32"),
                                       weights_dir=GOLDEN, device="cpu")


def test_run_pages_batch_and_gray(engine):
    """A two-page batch equals the pages run alone; a gray page [H, W] equals
    its RGB tripling."""
    img = image("funsd_0001129658")
    single = engine.run(img)
    batch = engine.run_pages(np.stack([img, img[:, ::-1].copy()]))
    assert batch[0] == single
    assert batch[1] == engine.run(img[:, ::-1].copy())
    assert engine.run(img[:, :, 0]) == single


def test_slab_sort_is_a_pure_permutation(engine):
    """Aspect-sorted recognition slabs give the raster-order results."""
    img = image("resume_example")
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
    got = engine.run(image("resume_example"))
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
    got = engine.run(image("resume_example"))
    assert len(got) > 15  # the default path's record has 15 words on this page
    assert word_share(ref, got) >= MIN_WORD_SHARE


def test_construction_checks():
    with pytest.raises(ValueError, match="geometry mismatch"):
        tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, rec_width=64),
                                    weights_dir=GOLDEN, device="cpu")
    with pytest.raises(ValueError, match="tokenizer/recognizer mismatch"):
        tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, charset="abc"),
                                    weights_dir=GOLDEN, device="cpu")
    for mode in ("beam", "nar"):  # rotated boxes and tiling are served
        with pytest.raises(NotImplementedError):
            tuatara_tpu_torch.OcrEngine(OcrConfig(decode_mode=mode), device="cpu")
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
    img = image("rotated_text")
    out = tuatara_tpu_torch.image_to_data(img, GOLDEN, config=OcrConfig(max_label_length=7),
                                          device="cpu")
    assert out and set(out[0]) == {"text", "bbox", "confidence"}
    with pytest.raises(ValueError, match="3 dimensions"):
        tuatara_tpu_torch.image_to_data(img[:, :, 0], GOLDEN, device="cpu")
