"""The port's `OcrConfig.production()` on confident inputs, on the CPU.

4 of the 16 held-out synthetic pages of tests/fixtures/torch_synthetic_
pages.npz through `production(canvas_size=256, max_boxes=32,
rec_buckets=(32,))` on the trained weights (int8 CRAFT with dynamic
activation scales, the kernels' plain versions): at least 98% of the JAX
engine's recorded production() words (tests/fixtures/torch_synthetic_
production.json, written by `tests/gen_torch_synthetic.py --config
production`) must be matched by a distinct port word with the same text and
a bbox IoU >= 0.5, and the word accuracy against the truths may be at most
0.02 below the JAX record's on the same pages: the gates of `chip_smoke.py`
phase 6c, which runs all 16 pages on the card. The same at
`production(rec_width=64, ...)` on `evals/production_weights_w64` against
its JAX record (tests/fixtures/torch_synthetic_production_w64.json,
`tests/gen_torch_synthetic.py --config production --weights
evals/production_weights_w64`).
"""

import json
import os

import numpy as np

import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.utils.metrics import transcript_agreement, word_accuracy

from torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = os.path.join(ROOT, "evals", "production_weights")
PRODUCTION_W64 = os.path.join(ROOT, "evals", "production_weights_w64")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PAGES = (0, 5, 10, 15)
MIN_AGREEMENT = 0.98


def _agree_with_jax_record(weights, record, **config):
    """4 synthetic pages through production(canvas_size=256, max_boxes=32,
    rec_buckets=(32,), **config) on `weights`, held to the JAX record
    under phase 6c's gates."""
    engine = tuatara_tpu_torch.OcrEngine(
        OcrConfig.production(canvas_size=256, max_boxes=32, rec_buckets=(32,), **config),
        weights_dir=weights, device="cpu")
    assert engine.craft.quantized and engine.parseq.enc_stacked is not None
    pages = np.load(os.path.join(FIXTURES, "torch_synthetic_pages.npz"))["pages"]
    with open(os.path.join(FIXTURES, "torch_synthetic_pages.json")) as f:
        truths = json.load(f)["truths"]
    with open(os.path.join(FIXTURES, record)) as f:
        ref = json.load(f)
    assert ref["config"]["preset"] == "production"
    assert ref["config"].get("rec_width", 128) == engine.config.rec_width
    reset_launches()
    hit = total = 0
    got_pages = []
    for i in PAGES:
        got = engine.run(pages[i])
        got_pages.append(got)
        h, n = transcript_agreement(ref["words"][i], got)
        hit, total = hit + h, total + n
    assert sum(LAUNCHES.values()) == 0  # plain versions on the CPU
    assert total >= 4 * 6
    assert hit / total >= MIN_AGREEMENT, f"{hit}/{total} JAX words matched"
    acc = word_accuracy(got_pages, [truths[i] for i in PAGES])
    jax_acc = word_accuracy([ref["words"][i] for i in PAGES], [truths[i] for i in PAGES])
    assert acc >= jax_acc - 0.02, f"word accuracy {acc} vs the JAX record's {jax_acc}"


def test_synthetic_pages_agree_with_jax_production():
    _agree_with_jax_record(PRODUCTION, "torch_synthetic_production.json")


def test_synthetic_pages_agree_with_jax_production_w64():
    """The same at production(rec_width=64) on the width-64 weights
    (K6's plain version at 64 tokens a crop) against its JAX record,
    tests/fixtures/torch_synthetic_production_w64.json."""
    _agree_with_jax_record(PRODUCTION_W64, "torch_synthetic_production_w64.json", rec_width=64)
