"""The port's serving loop on the CPU: `run_stream`, `run_mixed`,
`engine.stats`, `warmup`, `close` and the evicting engine cache.

On `tests/fixtures/golden_weights` at fp32, with a box budget of 16 and the
slab ladder 4, 8, 16 (`tests/gen_torch_serving.py`'s CONFIG), on crops of
the reference pages (96x128 and 96x120 RGB, 64x80 gray and RGB):

* against the JAX engine's record of one sequence of calls
  (tests/fixtures/torch_serving_golden.json, written by
  `tests/gen_torch_serving.py`): `run_stream` over seven batches (a batch
  that outgrows its speculated slab, a batch with no boxes, batches that a
  larger slab serves), then `run_mixed` twice. Transcripts and bboxes
  equal, confidences to 1e-4, and the counters pages, batches, boxes,
  spec_hits, spec_misses and spec_wasted equal after each call. One live
  JAX case shows a stale record;
* against the port itself: `run_stream` equals a loop of `run_pages` page
  by page at prefetch 1 and 4 and depth 1 and 2 (speculation, whose slab
  may be larger than the sized one, changes no result); `run_mixed`
  equals `run` on each page; an error in the batch source is raised in
  the caller; float batches raise TypeError; a tensor batch equals its
  numpy batch; `warmup` leaves the first live call's results as they
  were; an engine evicted from `get_engine`'s cache is closed, `close`
  is idempotent and a closed engine raises.
"""

import json
import threading

import numpy as np
import pytest
import torch

import tuatara_tpu_torch
from tuatara_tpu_torch import api
from tuatara_tpu_torch.config import OcrConfig

from gen_torch_serving import COUNTERS, CONFIG, MIXED, RECORD, counters, crop, jax_record, \
    mixed_pages, stream_batches
from torch_common import GOLDEN, assert_same_words, torch_threads  # noqa: F401


def _config(**overrides):
    return OcrConfig(**dict(CONFIG, rec_buckets=tuple(CONFIG["rec_buckets"])), **overrides)


def _engine(**overrides):
    return tuatara_tpu_torch.OcrEngine(_config(**overrides), weights_dir=GOLDEN, device="cpu")


def _assert_pages_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if w:
            assert_same_words(g, w)


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engine():
    return _engine()


@pytest.fixture(scope="module")
def batches():
    return stream_batches()


def test_serving_matches_jax_record(record):
    assert set(record["stats_after_stream"]) == set(COUNTERS)
    engine = _engine()
    stream = engine.run_stream(stream_batches(), prefetch=2, depth=1)
    assert len(stream) == len(record["stream_results"])
    for got, want in zip(stream, record["stream_results"]):
        _assert_pages_match(got, want)
    assert counters(engine) == record["stats_after_stream"]
    s = record["stats_after_stream"]
    assert s["spec_hits"] and s["spec_misses"] and s["spec_wasted"]
    for want in record["mixed_results"]:
        _assert_pages_match(engine.run_mixed(mixed_pages(), max_batch=2), want)
    assert counters(engine) == record["stats_after_mixed"]


def test_serving_record_is_live_jax(record):
    """The JAX engine over the record's sequence of calls, run live, equals
    the record."""
    assert json.loads(json.dumps(jax_record())) == record


@pytest.mark.parametrize("prefetch,depth", [(1, 1), (1, 2), (4, 1), (4, 2)])
def test_run_stream_equals_run_pages(engine, batches, prefetch, depth):
    want = [engine.run_pages(b) for b in batches]
    engine._spec.clear()  # the stream starts cold, as a fresh caller's would
    assert engine.run_stream(iter(batches), prefetch=prefetch, depth=depth) == want


def test_run_mixed_equals_run(engine):
    pages = mixed_pages()
    assert engine.run_mixed(pages, max_batch=2) == [engine.run(p) for p in pages]


def test_run_stream_raises_producer_errors(engine, batches):
    """An error in the batch source is raised in the caller instead of
    deadlocking, and the producer thread ends."""
    def source():
        yield batches[0]
        raise RuntimeError("bad batch source")

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="bad batch source"):
        engine.run_stream(source(), prefetch=1)
    assert threading.active_count() == before


def test_float_batches_raise_type_error(engine, batches):
    with pytest.raises(TypeError, match="uint8"):
        engine.run_pages(batches[0].astype(np.float32))
    with pytest.raises(TypeError, match="uint8"):
        engine.run_pages(torch.from_numpy(batches[0]).float() / 255)
    with pytest.raises(TypeError, match="uint8"):
        engine.run_stream([batches[0], batches[1].astype(np.float64)])


def test_tensor_batch_equals_numpy_batch(engine, batches):
    assert engine.run_pages(torch.from_numpy(batches[2])) == engine.run_pages(batches[2])
    gray = np.stack([crop(c) for c in MIXED if c[5]])  # [B, H, W]
    assert engine.run_pages(torch.from_numpy(gray)) == engine.run_pages(gray)


def test_warmup_leaves_first_call_unchanged(batches):
    want = _engine().run_pages(batches[2])
    warm = _engine()
    warm.warmup(*batches[2].shape[1:3], batch=2)
    assert warm.stats["batches"] == 1
    assert warm.run_pages(batches[2]) == want


def test_stats_accumulate_and_reset(engine, batches):
    engine.reset_stats()
    engine.run_pages(batches[0])
    engine.run(batches[1][0])
    s = engine.stats
    assert s["pages"] == 3 and s["batches"] == 2 and s["boxes"] > 0
    assert s["detect_s"] > 0
    assert set(engine.last_timings) == {"detect_s", "recognize_s", "decode_s", "speculative",
                                        "spec_fallback", "boxes"}
    engine.reset_stats()
    assert engine.stats == api.OcrEngine._fresh_stats()


def test_close_is_idempotent_and_closed_engine_raises(batches):
    engine = _engine()
    engine.close()
    engine.close()
    assert engine.craft is None and engine.parseq is None
    for call in (lambda: engine.run(batches[0][0]), lambda: engine.run_pages(batches[0]),
                 lambda: engine.run_stream(batches[:1]), lambda: engine.run_mixed([batches[0][0]]),
                 lambda: engine.warmup(64, 64), lambda: engine.calibrate(batches[0])):
        with pytest.raises(RuntimeError, match="closed"):
            call()


def test_engine_cache_evicts_and_closes(monkeypatch, batches):
    """get_engine keeps the ENGINE_CACHE_MAX most recently used engines and
    closes the one it evicts; clear_engines closes them all."""
    api.clear_engines()
    monkeypatch.setattr(api, "ENGINE_CACHE_MAX", 2)
    cfgs = [_config(canvas_size=c) for c in (256, 512, 768)]
    engines = [api.get_engine(c, GOLDEN, "cpu") for c in cfgs]
    assert len(api._engines) == 2
    with pytest.raises(RuntimeError, match="closed"):
        engines[0].run(batches[0][0])
    assert api.get_engine(cfgs[1], GOLDEN, "cpu") is engines[1]
    assert engines[1].run(batches[0][0]) and engines[2].run(batches[0][0])
    api.clear_engines()
    assert not api._engines
    with pytest.raises(RuntimeError, match="closed"):
        engines[2].run(batches[0][0])
