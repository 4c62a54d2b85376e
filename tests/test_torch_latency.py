"""The port's `OcrConfig.latency()` path on the CPU against the JAX package.

* The preset's fields equal JAX `OcrConfig.latency()` on this CPU backend
  apart from the two lowering fields, which the port always sets to
  "pallas" (the JAX preset keeps XLA off a TPU).
* The engine applies the lowering overrides to the resolved ParseqConfig,
  stacks both fused-kernel bundles once at construction (bf16 only), and
  refuses a lowering it does not have.
* The preset's /32 canvas and its 16-first recognition ladder give the JAX
  geometry and buckets.
* The port's word matching (`utils/metrics.py`) equals the JAX package's.
* Confident inputs: 4 of the 16 held-out synthetic pages of
  tests/fixtures/torch_synthetic_pages.npz through the port's
  `latency(canvas_size=256, max_boxes=32, rec_buckets=(32,))` with the
  kernels' plain versions; at least 98% of the JAX engine's recorded bf16
  words must be matched by a distinct port word with the same text and a
  bbox IoU >= 0.5 (bf16 detection may move a box by a pixel), and the word
  accuracy against the truths may be at most 0.02 below the JAX record's on
  the same pages.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import jax  # noqa: F401  (CPU backend, set by conftest)

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.ops.resize import canvas_shape as jax_canvas_shape
from tuatara_tpu.utils import metrics as jax_metrics
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.ops.resize import canvas_shape
from tuatara_tpu_torch.utils.metrics import match_boxes, transcript_agreement, word_accuracy

from torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = os.path.join(ROOT, "evals", "production_weights")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_synthetic_pages")
PAGES = (0, 5, 10, 15)
MIN_AGREEMENT = 0.98


@pytest.fixture(scope="module")
def engine():
    cfg = OcrConfig.latency(canvas_size=256, max_boxes=32, rec_buckets=(32,))
    return tuatara_tpu_torch.OcrEngine(cfg, weights_dir=PRODUCTION, device="cpu")


def test_preset_fields_match_jax():
    got = dataclasses.asdict(OcrConfig.latency())
    want = dataclasses.asdict(JaxOcrConfig.latency())
    assert set(got) == set(want)
    assert got["encoder_impl"] == got["decode_impl"] == "pallas"
    for k in ("encoder_impl", "decode_impl"):
        got.pop(k)
        want.pop(k)
    assert got == want
    over = OcrConfig.latency(canvas_bucket=64, box_mode="axis")
    assert over.canvas_bucket == 64 and over.rec_buckets == (16, 32, 64, 128, 256)


def test_engine_lowers_and_prestacks(engine):
    assert engine.parseq_config.encoder_impl == engine.parseq_config.decode_impl == "pallas"
    assert engine.parseq.enc_stacked is not None and engine.parseq.dec_stacked is not None
    assert engine.parseq.enc_stacked["qkv_w"].shape == (12, 384, 1152)
    assert engine.parseq.dec_stacked["k_tab"].shape == (26, 97, 384)
    f32 = tuatara_tpu_torch.OcrEngine(OcrConfig.latency(compute_dtype="float32"),
                                      weights_dir=PRODUCTION, device="cpu")
    assert f32.parseq.enc_stacked is None and f32.parseq.dec_stacked is None
    with pytest.raises(NotImplementedError):
        tuatara_tpu_torch.OcrEngine(OcrConfig(decode_impl="mosaic"),
                                    weights_dir=PRODUCTION, device="cpu")


@pytest.mark.parametrize("shape", [(607, 763), (1000, 754), (1000, 814), (664, 1245), (256, 256)])
def test_canvas_and_buckets_match_jax(shape):
    cfg, jcfg = OcrConfig.latency(), JaxOcrConfig.latency()
    assert canvas_shape(*shape, cfg) == jax_canvas_shape(*shape, jcfg)
    port = SimpleNamespace(config=cfg)
    jax_engine = SimpleNamespace(config=jcfg)
    for count in (1, 15, 16, 17, 32, 100, 256, 300):
        assert (tuatara_tpu_torch.OcrEngine._bucket(port, count)
                == JaxEngine._bucket(jax_engine, count))


def test_synthetic_pages_agree_with_jax(engine):
    pages = np.load(FIXTURE + ".npz")["pages"]
    with open(FIXTURE + ".json") as f:
        ref = json.load(f)
    hit = total = 0
    got_pages = []
    for i in PAGES:
        got = engine.run(pages[i])
        got_pages.append(got)
        h, n = transcript_agreement(ref["words"][i], got)
        hit, total = hit + h, total + n
    assert total >= 4 * 6
    assert hit / total >= MIN_AGREEMENT, f"{hit}/{total} JAX words matched"
    truths = [ref["truths"][i] for i in PAGES]
    acc = word_accuracy(got_pages, truths)
    jax_acc = word_accuracy([ref["words"][i] for i in PAGES], truths)
    assert acc >= jax_acc - 0.02, f"word accuracy {acc} vs the JAX record's {jax_acc}"


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    """Greedy IoU matching and word accuracy equal the JAX package's on
    random overlapping boxes with a small alphabet (many exact and near
    ties)."""
    rng = np.random.default_rng(seed)

    def page(n):
        xy = rng.integers(0, 40, (n, 2)).astype(float)
        wh = rng.integers(5, 20, (n, 2)).astype(float)
        return [{"text": "".join(rng.choice(list("ab"), 2)),
                 "bbox": [*xy[i], *(xy[i] + wh[i])]} for i in range(n)]

    preds, truths = [page(12) for _ in range(3)], [page(10) for _ in range(3)]
    for p, t in zip(preds, truths):
        boxes = ([w["bbox"] for w in p], [w["bbox"] for w in t])
        assert match_boxes(*boxes, 0.3) == jax_metrics.match_boxes(*boxes, 0.3)
    pairs = [(p[i]["text"], t[j]["text"]) for p, t in zip(preds, truths)
             for i, j, _ in jax_metrics.match_boxes([w["bbox"] for w in p],
                                                    [w["bbox"] for w in t], 0.5)]
    assert word_accuracy(preds, truths) == jax_metrics.word_accuracy(pairs)
