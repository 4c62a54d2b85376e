"""Tiled detection of the port against the JAX package, on the CPU.

* `tile_positions`, `extract_tiles` (and its ValueError on a stride that
  is not a multiple of ratio_net) and `stitch_heatmaps`: equal to JAX's on
  seeded inputs (live: small functions);
* the engine at `OcrConfig(tiled_detection=True, canvas_size=512,
  tile_overlap=256)` on the five reference pages (all but rotated_text
  tile; it takes the untiled path) and on funsd_0001129658 read gray, at
  canvas 1024 on table_english, and with `box_mode="rotated"` (a tiled
  page takes axis boxes, as in JAX): texts and bboxes equal to the JAX
  record tests/fixtures/torch_geometry_golden.json
  (`tests/gen_torch_geometry.py`), confidences within 1e-4; one live JAX
  case;
* `mag_ratio=1.5` (the page is upsampled before tiling): at least 95% of
  JAX's words with the same bbox and text, since the port's resample
  differs from XLA's by an ulp (ROADMAP Queue 3, item 6) and CRAFT can
  carry that across a threshold;
* `warmup` on pages that tile and pages that do not under
  `box_mode="rotated"`, then `run` equal to `run` alone; `run_stream`
  equal to a `run_pages` loop and `run_mixed` equal to `run`, under both
  options.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuatara_tpu.api import OcrEngine as JaxEngine
from tuatara_tpu.config import OcrConfig as JaxOcrConfig
from tuatara_tpu.ops import tiling as jtiling
import tuatara_tpu_torch
from tuatara_tpu_torch.config import OcrConfig
from tuatara_tpu_torch.ops import tiling as ttiling

from chip_smoke import word_share

from torch_common import GOLDEN, ROOT, assert_same_words, image, torch_threads, words  # noqa: F401

RECORD = os.path.join(ROOT, "tests", "fixtures", "torch_geometry_golden.json")
PAGES = ["funsd_0001129658", "funsd_91372360", "resume_example", "table_english",
         "rotated_text", "funsd_0001129658/gray"]
MAG_MIN_SHARE = 0.95


def page(name):
    base, _, kind = name.partition("/")
    return image(base, keep_gray=kind == "gray")


@pytest.mark.parametrize("size,tile,stride", [(512, 512, 256), (100, 512, 256),
                                              (1248, 512, 256), (1000, 512, 200),
                                              (513, 512, 256), (2016, 1024, 768)])
def test_tile_positions(size, tile, stride):
    got = ttiling.tile_positions(size, tile, stride)
    assert got == jtiling.tile_positions(size, tile, stride)
    assert got[0] == 0 and got[-1] + tile >= size


@pytest.mark.parametrize("shape,tile,overlap", [((96, 160, 3), 64, 32), ((64, 64, 1), 64, 16),
                                                ((70, 130, 3), 64, 30)])
def test_extract_and_stitch_match_jax(shape, tile, overlap):
    rng = np.random.default_rng(0)
    img = rng.random(shape).astype(np.float32)
    jt, jc = jtiling.extract_tiles(jnp.asarray(img), tile, overlap)
    tt, tc = ttiling.extract_tiles(torch.from_numpy(img), tile, overlap)
    assert tc == jc
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    scores = rng.standard_normal((len(tc), tile // 2, tile // 2, 2)).astype(np.float32)
    out_h, out_w = shape[0] // 2, shape[1] // 2
    want = jtiling.stitch_heatmaps(jnp.asarray(scores), jc, out_h, out_w)
    got = ttiling.stitch_heatmaps(torch.from_numpy(scores), tc, out_h, out_w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_odd_stride_raises():
    img = np.zeros((96, 96, 3), np.float32)
    for extract, arr in ((jtiling.extract_tiles, jnp.asarray(img)),
                         (ttiling.extract_tiles, torch.from_numpy(img))):
        with pytest.raises(ValueError, match="multiple of ratio_net"):
            extract(arr, 64, 33)


def test_stitch_leaves_uncovered_cells_at_minus_inf():
    scores = torch.ones((1, 4, 4, 2))
    out = ttiling.stitch_heatmaps(scores, [(0, 0)], 6, 5)
    assert torch.isneginf(out[4:]).all() and torch.isneginf(out[:, 4:]).all()
    assert (out[:4, :4] == 1).all()


@pytest.fixture(scope="module")
def record():
    with open(RECORD) as f:
        return json.load(f)


def engine_for(record, variant):
    cfg = OcrConfig(**record["base"], **record["variants"][variant]["config"])
    return tuatara_tpu_torch.OcrEngine(cfg, weights_dir=GOLDEN, device="cpu")


@pytest.fixture(scope="module")
def tiled(record):
    return engine_for(record, "tiled")


@pytest.fixture(scope="module")
def rotated_tiled(record):
    return engine_for(record, "rotated_tiled")


@pytest.mark.parametrize("name", PAGES)
def test_engine_tiled_matches_jax(tiled, record, name):
    img = page(name)
    assert tiled._tiled(*img.shape[:2]) == (name != "rotated_text")
    assert_same_words(tiled.run(img), record["variants"]["tiled"]["pages"][name])


def test_engine_tiled_canvas_1024(record):
    eng = engine_for(record, "tiled_1024")
    img = page("table_english")
    det = eng.detect(torch.from_numpy(img[None]))
    assert det["scores"].shape == (1, 512, 624, 2)  # the stitched heatmap, 1024 x 1248 / 2
    assert_same_words(eng.run(img), record["variants"]["tiled_1024"]["pages"]["table_english"])


def test_engine_tiled_mag_ratio(record):
    eng = engine_for(record, "tiled_mag_1.5")
    want = record["variants"]["tiled_mag_1.5"]["pages"]["resume_example"]
    got = eng.run(page("resume_example"))
    assert word_share(want, got) >= MAG_MIN_SHARE


@pytest.mark.parametrize("name", ["table_english", "rotated_text"])
def test_engine_rotated_tiled_matches_jax(rotated_tiled, record, name):
    assert_same_words(rotated_tiled.run(page(name)),
                      record["variants"]["rotated_tiled"]["pages"][name])


def test_engine_tiled_record_is_live_jax(record):
    """The JAX engine, run live on one page, equals its record."""
    cfg = {**record["base"], **record["variants"]["tiled"]["config"]}
    assert cfg == {"max_label_length": 7, "compute_dtype": "float32", "tiled_detection": True,
                   "canvas_size": 512, "tile_overlap": 256}
    live = words(JaxEngine(JaxOcrConfig(**cfg), weights_dir=GOLDEN).run(page("resume_example")))
    assert_same_words(live, record["variants"]["tiled"]["pages"]["resume_example"], atol=1e-6)


@pytest.mark.parametrize("name", ["table_english", "rotated_text"])
def test_rotated_tiled_warmup_then_run(rotated_tiled, name):
    """warmup builds the slab in the page's own rect form ([B, K, 4] on a
    page that tiles, [B, K, 4, 2] on one that does not), and leaves run
    unchanged (JAX's warmup sizes them by box_mode alone and raises on a
    page that tiles)."""
    img = page(name)
    before = rotated_tiled.run(img)
    rotated_tiled.warmup(*img.shape[:2], batch=2)
    det = rotated_tiled.detect(torch.from_numpy(img[None]))
    assert det["rects"].dim() == (3 if name == "table_english" else 4)
    assert rotated_tiled.run(img) == before


@pytest.mark.parametrize("variant", ["tiled", "rotated_tiled"])
def test_stream_and_mixed_equal_run(record, variant):
    eng = engine_for(record, variant)
    table, small = page("table_english"), page("rotated_text")
    flipped = table[:, ::-1].copy()
    batches = [table[None], flipped[None], table[None]]
    want = [eng.run_pages(b) for b in batches]
    eng._spec.clear()
    assert eng.run_stream(batches, prefetch=2, depth=2) == want
    mixed = [small, flipped, small]
    assert eng.run_mixed(mixed, max_batch=2) == [eng.run_pages(flipped[None])[0] if p is flipped
                                                 else eng.run(p) for p in mixed]
