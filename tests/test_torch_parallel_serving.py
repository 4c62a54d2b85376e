"""The port's data-parallel serving (`OcrEngine(..., mesh=make_mesh(2))`)
on the CPU: two ranks of a gloo group (`tests/torch_dist.py`), each with
the whole batch, against the single-device port engine and the JAX
package's records (the cases of `tests/test_mesh_equality.py` and
`tests/test_train_parallel.py:311-330`).

On `tests/fixtures/golden_weights` with a box budget of 16 and the slab
ladder 4, 8, 16, each of the default path at fp32, `latency()` (the plain
versions of K6/K7 at bf16) and `production()` (int8 CRAFT, dynamic scales
over the whole batch) and production() calibrated (two batches, margin
1.0) serves, on both ranks:

* a batch of three pages (padded to four with a copy of the last page,
  whose results are dropped), `run_stream` over the seven two-page batches of the JAX
  serving record (a speculative miss, a wasted slab, hits) and `run_mixed`
  twice over pages of three shapes (odd groups padded): equal transcripts
  and bboxes, confidences within 1e-4, on each rank, to the single engine,
  and the serving counters equal;
* the default path's stream and mixed results and counters equal the JAX
  engine's record `tests/fixtures/torch_serving_golden.json`;
* the calibrated scales equal the single engine's bit for bit, and so do
  those of an engine with an int8 recognizer encoder and a box budget (4)
  below the slab ladder's top (16).

Also: `make_mesh`'s shape errors (ValueError, as JAX's) and its refusal
without an initialized group; `sharded_ocr_programs` refuses an engine
built without the mesh, and its programs give the mesh engine's boxes;
`shard_pages` gives this rank's contiguous pages; `dp_size`.
"""

import json

import numpy as np
import pytest

from gen_torch_serving import RECORD, mixed_pages, stream_batches
from torch_common import assert_same_words, torch_threads  # noqa: F401
from torch_dist import run_ranks
from torch_parallel_cases import COUNTERS, calibrate_small_budget, serve_all, serving_configs
from tuatara_tpu_torch.parallel import make_mesh

CONFIGS = tuple(serving_configs())
WORLD = 2


def odd_batch():
    s = stream_batches()
    return np.concatenate([s[2], s[4][:1]])  # 3 pages, 19 + 5 boxes


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("torch_parallel_cases:serving_rank", WORLD,
                     tmp_path_factory.mktemp("dist"), stream_batches(), mixed_pages(),
                     odd_batch())


@pytest.fixture(scope="module")
def single():
    return serve_all(stream_batches(), mixed_pages(), odd_batch())


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def assert_pages_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if w:
            assert_same_words(g, w)


@pytest.mark.parametrize("call", ["odd", "stream", "mixed"])
@pytest.mark.parametrize("name", CONFIGS)
def test_mesh_equals_single_engine(ranks, single, name, call):
    want = single[name][call]
    assert sum(len(p) for p in (want if call == "odd" else want[0])) > 0, "no boxes: vacuous"
    for r in ranks:
        got = r["results"][name][call]
        if call == "odd":
            assert_pages_equal(got, want)
        else:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert_pages_equal(g, w)


@pytest.mark.parametrize("name", CONFIGS)
def test_mesh_serving_counters_equal_single_engine(ranks, single, name):
    for r in ranks:
        for key in ("stream_stats", "mixed_stats"):
            assert r["results"][name][key] == single[name][key]


def test_mesh_default_path_equals_jax_record(ranks, record):
    for r in ranks:
        got = r["results"]["default"]
        assert len(got["stream"]) == len(record["stream_results"])
        for g, w in zip(got["stream"], record["stream_results"]):
            assert_pages_equal(g, w)
        assert got["stream_stats"] == {k: record["stats_after_stream"][k] for k in COUNTERS}
        for g, w in zip(got["mixed"], record["mixed_results"]):
            assert_pages_equal(g, w)
        assert got["mixed_stats"] == {k: record["stats_after_mixed"][k] for k in COUNTERS}


@pytest.mark.parametrize("case", ["production", "small_budget"])
def test_mesh_calibration_equals_single_engine(ranks, single, case):
    if case == "production":
        want = single["production_calibrated"]
    else:  # an int8 encoder too, max_boxes 4 below the ladder's top 16
        want = calibrate_small_budget(odd_batch())
    assert want["calibrated"] == len(want["scales"]) > 0
    for r in ranks:
        got = (r["results"]["production_calibrated"] if case == "production"
               else r["calib_small"])
        assert got["calibrated"] == want["calibrated"]
        assert got["scales"] == want["scales"]


def test_make_mesh_shape_errors(ranks):
    for r in ranks:
        assert r["dp_size"] == WORLD
        errs = r["shape_errors"]
        assert all(e is not None for e in errs), errs
        assert "!= 2 devices" in errs[0] and "!= 2 devices" in errs[1]
        assert "whole default group" in errs[2]
        assert "unknown mesh axis" in errs[3]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh(device="cpu")


def test_sharded_programs_and_shard_pages(ranks):
    pages = np.concatenate([odd_batch(), odd_batch()[:1]])
    for rank, r in enumerate(ranks):
        assert r["refused"]
        np.testing.assert_array_equal(r["shard"], pages[rank * 2:(rank + 1) * 2])
        assert r["program"] == ranks[0]["program"]
    prog = ranks[0]["program"]
    assert sum(prog["count"]) > 0
    assert len(prog["ids"]) == 16 and len(prog["conf"]) == 16
