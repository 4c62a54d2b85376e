"""The port's tracing and timing (`utils/profiling.py`), the engine's stage
marks, and the native host library's binding (`native.py`) on the CPU.

* A `profiling.trace` of `run_pages` (golden weights, fp32) writes a Chrome
  trace holding the four stage names of the JAX engine, `tuatara_detect`,
  `tuatara_recognize`, `tuatara_fetch` and `tuatara_decode`, once a call
  each (recognition: the sized pass of a first call); a second call, with
  a speculative slab, marks recognition in its dispatch. `annotate` names a
  region of the trace.
* `StageTimer.summary()` and `timeit` give the keys of the JAX package's
  (live); a stage's and a call's time covers the work.
* `native.extract_boxes` on the synthetic heatmaps of
  `tests/test_native.py` (seeds 0, 3, 7) gives the port's `extract_boxes`
  boxes (and the JAX package's binding, live, the same boxes and
  corners); `native.label_components` gives the port's labels up to
  renumbering on random masks; the library is built under `build/`, not
  `native/`.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import tuatara_tpu_torch
from tuatara_tpu import native as jax_native
from tuatara_tpu.utils import profiling as jax_profiling
from tuatara_tpu_torch import native
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.ops.boxes import extract_boxes
from tuatara_tpu_torch.ops.connected_components import label_components
from tuatara_tpu_torch.utils import profiling

from torch_common import GOLDEN, image, torch_threads  # noqa: F401

STAGES = ("tuatara_detect", "tuatara_recognize", "tuatara_fetch", "tuatara_decode")


def trace_names(log_dir):
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name") for e in events]


@pytest.fixture(scope="module")
def engine():
    return tuatara_tpu_torch.OcrEngine(OcrConfig(max_label_length=7, compute_dtype="float32"),
                                       weights_dir=GOLDEN, device="cpu")


def test_trace_of_run_pages_holds_the_stages(engine, tmp_path):
    page = image("rotated_text")[None]
    with profiling.trace(str(tmp_path / "first")):
        first = engine.run_pages(page)
    names = trace_names(tmp_path / "first")
    assert first[0], "no words: vacuous"
    for s in STAGES:
        assert names.count(s) == 1, (s, names.count(s))
    with profiling.trace(str(tmp_path / "second")):
        with profiling.annotate("caller_region"):
            second = engine.run_pages(page)
    names = trace_names(tmp_path / "second")
    assert engine.last_timings["speculative"] and not engine.last_timings["spec_fallback"]
    assert second == first
    for s in STAGES + ("caller_region",):
        assert names.count(s) == 1, (s, names.count(s))


def test_stage_timer_and_timeit_have_jax_keys():
    jt = jax_profiling.StageTimer()
    with jt.stage("a"):
        pass
    t = profiling.StageTimer()
    for _ in range(2):
        with t.stage("a"):
            time.sleep(0.01)
    got, want = t.summary(), jt.summary()
    assert got.keys() == want.keys() and got["a"].keys() == want["a"].keys()
    assert got["a"]["count"] == 2 and got["a"]["total_s"] >= 0.02
    assert got["a"]["mean_s"] == got["a"]["total_s"] / 2
    x = torch.ones(64, 64)
    r = profiling.timeit(torch.matmul, x, x, iters=3, warmup=1)
    assert r.keys() == jax_profiling.timeit(lambda: np.ones(1), iters=1).keys()
    assert r["iters"] == 3 and r["mean_s"] > 0


def _synthetic(rng, h=64, w=64, nblobs=6):
    """The heatmaps of tests/test_native.py's `_synthetic`."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    text = np.zeros((h, w), np.float32)
    link = np.zeros((h, w), np.float32)
    for _ in range(nblobs):
        cy, cx = rng.uniform(8, h - 8), rng.uniform(8, w - 8)
        sy, sx = rng.uniform(1.5, 3.5), rng.uniform(2.5, 6.0)
        text += np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        if rng.random() < 0.5:
            link += 0.8 * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx - 5) / (sx * 2)) ** 2))
    return np.clip(text, 0, 1), np.clip(link, 0, 1)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_native_boxes_equal_port_boxes(seed):
    text, link = _synthetic(np.random.default_rng(seed))
    boxes, corners, ncomp = native.extract_boxes(text, link, max_boxes=16)
    out = extract_boxes(torch.from_numpy(text), torch.from_numpy(link),
                        torch.ones(64, 64, dtype=torch.bool),
                        OcrConfig(max_boxes=16, canvas_size=128))
    valid = out["valid"].numpy()
    want = sorted(tuple(int(v) for v in b) for b in out["boxes"].numpy()[valid])
    assert len(want) > 0
    assert sorted(tuple(int(v) for v in b) for b in boxes) == want
    jb, jc, jn = jax_native.extract_boxes(text, link, max_boxes=16)
    np.testing.assert_array_equal(boxes, jb)
    np.testing.assert_array_equal(corners, jc)
    assert ncomp == jn


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_labels_equal_port_labels_up_to_renumbering(seed):
    m = np.random.default_rng(seed).random((40, 56)) < 0.4
    labels, n = native.label_components(m)
    port = label_components(torch.from_numpy(m)).numpy()
    assert n == len(np.unique(port[m])) > 1
    assert (labels[~m] == -1).all() and (port[~m] == -1).all()
    fwd, back = {}, {}
    for a, b in zip(labels[m].tolist(), port[m].tolist()):
        assert fwd.setdefault(a, b) == b and back.setdefault(b, a) == a


def test_native_builds_under_build_dir():
    native.load()
    assert native.available()
    assert os.path.isfile(native.SO_PATH)
    assert os.sep + "build" + os.sep in native.SO_PATH
    assert not native.SO_PATH.startswith(os.path.dirname(native.SOURCE) + os.sep)
