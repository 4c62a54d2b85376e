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
phase 6c, which runs all 16 pages on the card.
"""

import json
import os

import numpy as np

import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.kernels import LAUNCHES, reset_launches
from tuatara_tpu_torch.utils.metrics import transcript_agreement, word_accuracy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = os.path.join(ROOT, "evals", "production_weights")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PAGES = (0, 5, 10, 15)
MIN_AGREEMENT = 0.98


def test_synthetic_pages_agree_with_jax_production():
    engine = tuatara_tpu_torch.OcrEngine(
        OcrConfig.production(canvas_size=256, max_boxes=32, rec_buckets=(32,)),
        weights_dir=PRODUCTION, device="cpu")
    assert engine.craft.quantized and engine.parseq.enc_stacked is not None
    pages = np.load(os.path.join(FIXTURES, "torch_synthetic_pages.npz"))["pages"]
    with open(os.path.join(FIXTURES, "torch_synthetic_pages.json")) as f:
        truths = json.load(f)["truths"]
    with open(os.path.join(FIXTURES, "torch_synthetic_production.json")) as f:
        ref = json.load(f)
    assert ref["config"]["preset"] == "production"
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
